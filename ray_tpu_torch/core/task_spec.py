"""Task/actor specifications exchanged between driver, scheduler and workers.

Role-equivalent to the reference's TaskSpecification (reference:
src/ray/common/task/task_spec.h over protobuf common.proto). Here a spec is a
plain dataclass, msgpack/pickle-serializable; function payloads travel as
cloudpickle bytes exported once per job via the function registry
(reference: python/ray/_private/function_manager.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID


@dataclass
class TaskArg:
    """One argument: either an inline serialized value or an object ref."""
    is_ref: bool
    value: Any = None          # inline value (local mode) or serialized bytes
    object_id: Optional[ObjectID] = None
    owner: Optional[WorkerID] = None


@dataclass
class TaskSpec:
    task_id: TaskID
    name: str
    # local mode keeps the callable; cluster mode ships a function key into
    # the GCS function table plus a pickled fallback.
    function: Any = None
    function_key: Optional[bytes] = None
    args: List[TaskArg] = field(default_factory=list)
    kwargs: Dict[str, Any] = field(default_factory=dict)
    num_returns: int = 1
    #: num_returns="streaming": yielded values become refs incrementally
    #: (reference: _raylet.pyx streaming generator protocol)
    streaming: bool = False
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    owner: Optional[WorkerID] = None
    # actor fields
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    seq_no: int = -1
    # scheduling
    scheduling_strategy: Any = None
    placement_group_id: Optional[bytes] = None
    placement_bundle_index: int = -1
    # validated runtime environment (env_vars/working_dir — see
    # runtime/runtime_env.py; reference: common.proto RuntimeEnvInfo)
    runtime_env: Optional[dict] = None

    @property
    def is_actor_task(self) -> bool:
        return self.actor_id is not None and self.method_name != "__init__"

    def return_ids(self) -> List[ObjectID]:
        # cached: callers hit this several times per task on the submit
        # hot path (lineage, ref registration, reply store)
        rids = getattr(self, "_rids", None)
        if rids is None:
            rids = [ObjectID.for_return(self.task_id, i + 1)
                    for i in range(self.num_returns)]
            object.__setattr__(self, "_rids", rids)
        return rids


@dataclass
class ActorCreationSpec:
    actor_id: ActorID
    name: str                      # class name
    registered_name: str = ""      # named-actor registry key ("" = anonymous)
    namespace: str = "default"
    cls: Any = None                # local mode: the class object
    cls_key: Optional[bytes] = None
    args: List[TaskArg] = field(default_factory=list)
    kwargs: Dict[str, Any] = field(default_factory=dict)
    resources: Dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0
    max_task_retries: int = 0
    # None = unset: resolves to 1 for threaded actors, 1000 for async
    # actors (reference: ray_constants DEFAULT_MAX_CONCURRENCY_ASYNC)
    max_concurrency: Optional[int] = None
    # concurrency groups (reference: core_worker ConcurrencyGroupManager,
    # transport/task_receiver.h): group name -> thread count; methods are
    # routed to their group's lane so e.g. health/stats probes never queue
    # behind long-running request handlers.
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
    method_groups: Dict[str, str] = field(default_factory=dict)
    lifetime: str = "non_detached"
    scheduling_strategy: Any = None
    placement_group_id: Optional[bytes] = None
    placement_bundle_index: int = -1
    owner: Optional[WorkerID] = None
    runtime_env: Optional[dict] = None
