"""Actor API: @ray_tpu_torch.remote on classes, ActorClass/ActorHandle/ActorMethod.

Role-equivalent to the reference's actor surface (reference:
python/ray/actor.py — ActorClass._remote :890, ActorHandle :1265,
ActorMethod._remote :314): `Cls.remote(...)` creates a stateful worker;
`handle.method.remote(...)` submits ordered method calls; handles serialize
so actors can be passed to tasks/other actors; named actors register in the
cluster directory (reference: get_actor in worker.py).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskSpec
from ray_tpu_torch.core.ids import TaskID
from ray_tpu_torch.core.worker import require_connected
from ray_tpu_torch.remote_function import _build_resources

_VALID_ACTOR_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "resources", "memory",
    "max_restarts", "max_task_retries", "max_concurrency",
    "concurrency_groups", "name",
    "namespace", "lifetime", "scheduling_strategy", "placement_group",
    "placement_group_bundle_index", "runtime_env", "_metadata",
}


class ActorClass:
    def __init__(self, cls: type, options: Dict[str, Any]):
        self._cls = cls
        self._options = dict(options)
        for k in self._options:
            if k not in _VALID_ACTOR_OPTIONS:
                raise ValueError(f"invalid option {k!r} for actor @remote")
        from ray_tpu_torch.runtime import runtime_env as rtenv
        self._options["runtime_env"] = rtenv.validate(
            self._options.get("runtime_env"))
        # Collect per-method defaults declared with @ray_tpu_torch.method(...).
        self._method_options: Dict[str, Dict[str, Any]] = {}
        for name in dir(cls):
            try:
                attr = getattr(cls, name)
            except AttributeError:
                continue
            opts = getattr(attr, "__rtpu_method_options__", None)
            if opts:
                self._method_options[name] = dict(opts)
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated "
            "directly — use .remote()")

    def options(self, **opts) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **opts})

    def remote(self, *args, **kwargs) -> "ActorHandle":
        worker = require_connected()
        opts = self._options
        declared_groups = set(opts.get("concurrency_groups") or {})
        for m, o in self._method_options.items():
            g = o.get("concurrency_group")
            if g and g not in declared_groups:
                # undeclared groups would silently fall back to the default
                # lane on the worker — the starvation the group exists to
                # prevent (reference rejects these at creation too)
                raise ValueError(
                    f"method {m!r} uses concurrency_group={g!r} but the "
                    f"actor declares concurrency_groups="
                    f"{sorted(declared_groups) or '{}'}")
        actor_id = ActorID.of(worker.job_id)
        spec = ActorCreationSpec(
            actor_id=actor_id,
            name=self._cls.__name__,
            registered_name=opts.get("name", "") or "",
            namespace=opts.get("namespace", "default") or "default",
            cls=self._cls,
            args=worker.make_task_args(args),
            kwargs=dict(kwargs),
            # Reference semantics (python/ray/actor.py defaults): an actor
            # holds 0 CPUs for its lifetime unless resources are requested
            # explicitly — idle actors don't block scheduling (this is what
            # makes 40k actors/cluster possible in the baseline).
            resources=_build_resources(opts),
            max_restarts=int(opts.get("max_restarts", 0)),
            max_task_retries=int(opts.get("max_task_retries", 0)),
            max_concurrency=(int(opts["max_concurrency"])
                             if opts.get("max_concurrency") is not None
                             else None),
            concurrency_groups=dict(opts.get("concurrency_groups") or {}),
            method_groups={
                m: o["concurrency_group"]
                for m, o in self._method_options.items()
                if o.get("concurrency_group")},
            lifetime=opts.get("lifetime") or "non_detached",
            scheduling_strategy=opts.get("scheduling_strategy"),
            runtime_env=opts.get("runtime_env"),
        )
        pg = opts.get("placement_group")
        if pg is not None:
            spec.placement_group_id = pg.id.binary()
            spec.placement_bundle_index = opts.get(
                "placement_group_bundle_index", -1)
        worker.create_actor(spec)
        return ActorHandle(actor_id, self._cls.__name__,
                           max_task_retries=spec.max_task_retries,
                           method_options=self._method_options)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, **opts) -> "ActorMethod":
        m = ActorMethod(self._handle, self._method_name,
                        opts.get("num_returns", self._num_returns))
        return m

    def remote(self, *args, **kwargs):
        worker = require_connected()
        seq = self._handle._next_seq()
        streaming = self._num_returns == "streaming"
        spec = TaskSpec(
            task_id=TaskID.for_actor_task(self._handle._actor_id),
            name=f"{self._handle._class_name}.{self._method_name}",
            args=worker.make_task_args(args),
            kwargs=dict(kwargs),
            num_returns=0 if streaming else self._num_returns,
            streaming=streaming,
            actor_id=self._handle._actor_id,
            method_name=self._method_name,
            seq_no=seq,
            max_retries=self._handle._max_task_retries,
        )
        refs = worker.submit_actor_task(spec)
        if streaming:
            return refs  # an ObjectRefGenerator
        return refs[0] if self._num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Lazy DAG node over this actor method (reference:
        dag/class_node.py ClassMethodNode); chains compile into
        pre-launched channel-fed loops via dag.experimental_compile."""
        from ray_tpu_torch.dag import ActorMethodNode
        return ActorMethodNode(self._handle, self._method_name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError("actor methods must be invoked with .remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str,
                 max_task_retries: int = 0,
                 method_options: Optional[Dict[str, Dict[str, Any]]] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries
        self._method_options = method_options or {}
        self._seq = 0

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        opts = self._method_options.get(name, {})
        return ActorMethod(self, name, num_returns=opts.get("num_returns", 1))

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle,
                (self._actor_id, self._class_name, self._max_task_retries,
                 self._method_options))


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    worker = require_connected()
    spec = worker.backend.get_actor_by_name(name, namespace)
    if spec is None:
        raise ValueError(f"no named actor {name!r} in namespace {namespace!r}")
    return ActorHandle(spec.actor_id, spec.name,
                       max_task_retries=spec.max_task_retries)
