"""The Worker singleton — every process's in-proc runtime.

Role-equivalent to the reference's CoreWorker + Python Worker pair
(reference: src/ray/core_worker/core_worker.h:166 and
python/ray/_private/worker.py:426): owns the memory store, the reference
counter, id generation, and task submission; exposes get/put/wait.

The JAX package's local mode, copied: the backend is ``LocalBackend``
(core/local_backend.py), in-process thread execution — the reference's
local_mode, used for unit tests and single-process ML library runs. The
cluster runtime (head daemon, node daemons, leased worker processes,
shared-memory data plane) is not part of this package yet.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import object_ref as object_ref_mod
from ray_tpu_torch.core.ids import (ActorID, JobID, ObjectID, TaskID, WorkerID,
                              _Counter)
from ray_tpu_torch.core.memory_store import MemoryStore
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.refcount import ReferenceCounter
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskArg, TaskSpec
from ray_tpu_torch.exceptions import GetTimeoutError, RayTpuError, TaskError

LOCAL_MODE = "local"
#: how long shutdown() waits for each actor thread to finish its queue
SHUTDOWN_JOIN_S = 60.0


class Worker:
    def __init__(self):
        self.mode: Optional[str] = None
        self.job_id = JobID.nil()
        self.worker_id = WorkerID.nil()
        self.current_task_id: Optional[TaskID] = None
        self.memory_store = MemoryStore()
        self.refcounter = ReferenceCounter()
        self.backend = None
        self.node_id = None
        self._put_counter = _Counter()
        self._task_counter = _Counter()
        self._lock = threading.RLock()
        self.runtime_context: Dict[str, Any] = {}
        self._actor_instance = None  # set when this process hosts an actor

    # ------------------------------------------------------------------ init

    @property
    def connected(self) -> bool:
        return self.mode is not None

    def connect_local(self, num_cpus: Optional[int] = None,
                      resources: Optional[Dict[str, float]] = None) -> None:
        from ray_tpu_torch.core.local_backend import LocalBackend
        self.mode = LOCAL_MODE
        self.job_id = JobID.from_int(1)
        self.worker_id = WorkerID.from_random()
        self.current_task_id = TaskID.for_driver(self.job_id)
        self.backend = LocalBackend(self, num_cpus=num_cpus, resources=resources)
        self._install_hooks()

    def _install_hooks(self) -> None:
        object_ref_mod.install_refcount_hooks(
            add=lambda oid: self.refcounter.add_local(oid),
            remove=lambda oid: self.refcounter.remove_local(oid),
            borrow=lambda oid: self.refcounter.on_ref_serialized(oid),
        )
        self.refcounter.free_object = self._free_object

    def disconnect(self) -> None:
        if self.backend is not None:
            # wait for the actor threads to finish what they run: a thread
            # still inside torch code when the interpreter exits aborts
            # the process
            threads = [a.thread for a in self.backend.actors.values()]
            try:
                self.backend.shutdown()
            except Exception:
                pass
            for t in threads:
                t.join(timeout=SHUTDOWN_JOIN_S)
        self.backend = None
        self.mode = None
        self.memory_store = MemoryStore()
        self.refcounter = ReferenceCounter()
        self._install_hooks()
        self._actor_instance = None

    def _free_object(self, object_id: ObjectID) -> None:
        self.memory_store.delete(object_id)
        if self.backend is not None:
            try:
                self.backend.free_object(object_id)
            except Exception:
                pass

    # ------------------------------------------------------------------- ids

    def next_task_id(self) -> TaskID:
        return TaskID.for_normal_task(self.job_id)

    def next_put_id(self) -> ObjectID:
        base_task = self.current_task_id or TaskID.for_driver(self.job_id)
        return ObjectID.for_put(base_task, self._put_counter.next())

    # ------------------------------------------------------------------- api

    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() on an ObjectRef is not allowed")
        object_id = self.next_put_id()
        self.refcounter.mark_owned(object_id)
        self.backend.put_object(object_id, value)
        return ObjectRef(object_id, self.worker_id)

    def get(self, refs, timeout: Optional[float] = None) -> Any:
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
        deadline = None if timeout is None else time.monotonic() + timeout
        values = []
        for r in ref_list:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            values.append(self._get_one(r, remaining))
        return values[0] if single else values

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        oid = ref.id()
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.memory_store.wait_ready(oid, 0.05):
            if deadline is not None and time.monotonic() >= deadline:
                raise GetTimeoutError(f"get() timed out on {ref}")
        entry = self.memory_store.get_if_ready(oid)
        if entry is None:
            from ray_tpu_torch.exceptions import ObjectLostError
            raise ObjectLostError(oid.hex(), "freed while being fetched")
        value, is_error, _ = entry
        if is_error:
            raise value
        return value

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        refs = list(refs)
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        # Readiness is the memory store's alone in local mode: one-lock
        # bulk scan each wakeup, events fire as tasks store their results.
        while len(ready) < num_returns:
            ready_ids = self.memory_store.collect_ready(
                (r.id() for r in pending), num_returns - len(ready))
            still = []
            for r in pending:
                if len(ready) < num_returns and r.id() in ready_ids:
                    ready.append(r)
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if not ready_ids:
                remaining_t = 0.05
                if deadline is not None:
                    remaining_t = min(remaining_t,
                                      max(0.0, deadline - time.monotonic()))
                if len(pending) <= 32:
                    # event-driven: wake on the first completion instead
                    # of a 1ms poll (a poll adds up to 1ms latency per
                    # round and starved reply threads on small hosts).
                    self.memory_store.wait_any(
                        [r.id() for r in pending], remaining_t)
                else:
                    # large sets: wait_any's O(N) event registration per
                    # dry call costs more than the 1ms poll it saves —
                    # completions arrive faster than the poll period
                    # anyway, so the poll amortizes across several.
                    time.sleep(min(0.001, remaining_t))
        return ready, pending

    # -------------------------------------------------------------- futures

    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(self._get_one(ref, None))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        self.memory_store.add_ready_callback(ref.id(), _resolve)
        return fut

    def as_asyncio_future(self, ref: ObjectRef) -> asyncio.Future:
        loop = asyncio.get_event_loop()
        afut = loop.create_future()

        def _resolve():
            def _set():
                if afut.cancelled():
                    return
                value = None
                exc = None
                try:
                    value = self._get_one(ref, 0)
                except BaseException as e:  # noqa: BLE001
                    exc = e
                if exc is not None:
                    afut.set_exception(exc)
                else:
                    afut.set_result(value)
            loop.call_soon_threadsafe(_set)

        self.memory_store.add_ready_callback(ref.id(), _resolve)
        return afut

    # ----------------------------------------------------------- submission

    def submit_task(self, spec: TaskSpec):
        spec.owner = self.worker_id
        if spec.streaming:
            gen = self.backend.register_stream(spec)
            self.backend.submit_task(spec)
            return gen
        refs = [ObjectRef(oid, self.worker_id) for oid in spec.return_ids()]
        for oid in spec.return_ids():
            self.refcounter.mark_owned(oid)
        self.backend.submit_task(spec)
        return refs

    def create_actor(self, spec: ActorCreationSpec) -> None:
        spec.owner = self.worker_id
        self.backend.create_actor(spec)

    def submit_actor_task(self, spec: TaskSpec):
        spec.owner = self.worker_id
        if spec.streaming:
            gen = self.backend.register_stream(spec)
            self.backend.submit_actor_task(spec)
            return gen
        refs = [ObjectRef(oid, self.worker_id) for oid in spec.return_ids()]
        for oid in spec.return_ids():
            self.refcounter.mark_owned(oid)
        self.backend.submit_actor_task(spec)
        return refs

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self.backend.kill_actor(actor_id, no_restart)

    def cancel_task(self, ref: ObjectRef, force: bool = False,
                    recursive: bool = True) -> None:
        self.backend.cancel_task(ref, force)

    def make_task_args(self, args: Sequence[Any]) -> List[TaskArg]:
        out = []
        for a in args:
            if isinstance(a, ObjectRef):
                self.refcounter.on_ref_serialized(a.id())
                out.append(TaskArg(is_ref=True, object_id=a.id(), owner=a.owner_id()))
            else:
                out.append(TaskArg(is_ref=False, value=a))
        return out


global_worker = Worker()


def require_connected() -> Worker:
    if not global_worker.connected:
        raise RayTpuError(
            "ray_tpu_torch is not initialized — call "
            "ray_tpu_torch.init(local_mode=True) first")
    return global_worker
