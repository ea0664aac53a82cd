"""In-process execution backend ("local mode").

Role-equivalent to the reference's local_mode
(python/ray/_private/worker.py local-mode path): tasks run on a thread pool
in the driver process, actors get a dedicated thread with an ordered queue,
values pass by reference (no serialization). Semantics preserved: futures
resolve asynchronously, errors propagate through refs at get(), retries and
max_restarts are honored, resource limits gate concurrency.
"""

from __future__ import annotations

import os
import queue
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.ids import ActorID, ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskArg, TaskSpec
from ray_tpu_torch.exceptions import (ActorDiedError, TaskCancelledError, TaskError)

# Local mode runs tasks as threads in ONE process, so env_vars are applied
# to os.environ around the call. Per-key depth counting makes overlapping
# env'd tasks composable: the FIRST task to touch a key records the
# process-original value, and only the LAST task to leave restores it —
# naive save/restore pairs leak one task's value into the process forever
# under interleaved exits. While tasks overlap, last-writer-wins is
# visible across threads (a documented dev-mode tradeoff; true isolation
# needs the cluster runtime's per-env worker processes). The lock covers
# only mutate/restore, never user code (holding it across user code would
# deadlock a nested env'd ray.get()).
_env_lock = threading.Lock()
_env_depth: Dict[str, int] = {}
_env_original: Dict[str, Optional[str]] = {}


class _applied_runtime_env:
    def __init__(self, renv):
        self.renv = renv or None
        self._keys = None

    def __enter__(self):
        if self.renv is None:
            return self
        if "working_dir" in self.renv:
            raise ValueError(
                "runtime_env['working_dir'] requires the cluster runtime "
                "(per-env worker processes); local_mode runs in-process — "
                "use ray_tpu.init() without local_mode=True")
        env_vars = self.renv.get("env_vars") or {}
        if env_vars:
            with _env_lock:
                for k, v in env_vars.items():
                    if _env_depth.get(k, 0) == 0:
                        _env_original[k] = os.environ.get(k)
                    _env_depth[k] = _env_depth.get(k, 0) + 1
                    os.environ[k] = v
            self._keys = list(env_vars)
        return self

    def __exit__(self, *exc):
        if self._keys is not None:
            with _env_lock:
                for k in self._keys:
                    _env_depth[k] = _env_depth.get(k, 1) - 1
                    if _env_depth[k] <= 0:
                        _env_depth.pop(k, None)
                        orig = _env_original.pop(k, None)
                        if orig is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = orig
            self._keys = None
        return False


class _LocalActor:
    def __init__(self, backend: "LocalBackend", spec: ActorCreationSpec):
        self.backend = backend
        self.spec = spec
        self.instance = None
        self.queue: "queue.Queue" = queue.Queue()
        self.dead = False
        self.death_reason = ""
        self.restarts_left = spec.max_restarts
        self._aio_loop = None  # created at construct for async actors
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"actor-{spec.name}")
        self.thread.start()

    def _construct(self) -> None:
        import asyncio
        import inspect
        args = self.backend._resolve_args(self.spec.args)
        with _applied_runtime_env(self.spec.runtime_env):
            self.instance = self.spec.cls(*args, **self.spec.kwargs)
        cls = type(self.instance)
        if any(inspect.iscoroutinefunction(getattr(cls, n, None))
               or inspect.isasyncgenfunction(getattr(cls, n, None))
               for n in dir(cls)):
            self._aio_loop = asyncio.new_event_loop()
            threading.Thread(target=self._aio_loop.run_forever, daemon=True,
                             name=f"actor-aio-{self.spec.name}").start()

    def _run(self) -> None:
        try:
            self._construct()
        except BaseException as e:  # noqa: BLE001
            self.dead = True
            self.death_reason = f"creation failed: {e!r}"
            self._drain_with_error()
            return
        while True:
            item = self.queue.get()
            if item is None:
                # the kill tombstone: let the instance go, and with it what
                # it holds (an engine's device memory), at the kill, not at
                # shutdown; LocalBackend.actors keeps this entry (spec,
                # death reason, thread) for later calls and shutdown. An
                # async actor's calls still on its loop hold the instance
                # until they end
                self.instance = None
                return
            spec: TaskSpec = item
            try:
                args = self.backend._resolve_args(spec.args)
            except BaseException as e:  # noqa: BLE001
                self.backend._store_error(spec, e)
                continue
            method = getattr(self.instance, spec.method_name, None)
            if method is None:
                self.backend._store_error(
                    spec, AttributeError(f"no method {spec.method_name}"))
                continue
            try:
                if self._aio_loop is not None:
                    # async actor: schedule on the loop, don't block the
                    # queue — concurrent calls interleave like the
                    # cluster-mode asyncio path
                    self._submit_async(method, args, spec)
                    continue
                if spec.streaming:
                    with _applied_runtime_env(self.spec.runtime_env):
                        self.backend._drain_stream(
                            spec, method(*args, **spec.kwargs))
                    continue
                with _applied_runtime_env(self.spec.runtime_env):
                    result = method(*args, **spec.kwargs)
                self.backend._store_result(spec, result)
            except BaseException as e:  # noqa: BLE001
                if isinstance(e, (SystemExit, KeyboardInterrupt)):
                    self.dead = True
                    self.death_reason = "actor exited"
                    self.backend._store_error(spec, ActorDiedError(
                        self.spec.actor_id.hex(), self.death_reason))
                    self._drain_with_error()
                    return
                self.backend._store_error(spec, e)

    def _submit_async(self, method, args, spec: TaskSpec) -> None:
        import asyncio
        import inspect

        async def run():
            with _applied_runtime_env(self.spec.runtime_env):
                return await _run_inner()

        async def _run_inner():
            if inspect.isasyncgenfunction(method):
                if not spec.streaming:
                    raise TypeError(
                        f"{spec.method_name} is an async generator — call "
                        f"it with num_returns='streaming'")
                agen = method(*args, **spec.kwargs)
                i = 0
                try:
                    async for v in agen:
                        i += 1
                        self.backend._store_stream_item(spec, i, v)
                except BaseException as e:  # noqa: BLE001
                    self.backend._finish_stream(spec, i, e)
                    return None, True
                finally:
                    # release ObjectRef args like every other completion path
                    for a in spec.args:
                        if a.is_ref:
                            self.backend.worker.refcounter \
                                .on_serialized_ref_done(a.object_id)
                self.backend._finish_stream(spec, i, None)
                return None, True
            out = method(*args, **spec.kwargs)
            if inspect.isawaitable(out):
                out = await out
            if spec.streaming:
                self.backend._drain_stream(spec, out)
                return None, True
            return out, False

        fut = asyncio.run_coroutine_threadsafe(run(), self._aio_loop)

        def done(f):
            try:
                result, handled = f.result()
            except BaseException as e:  # noqa: BLE001
                self.backend._store_error(spec, e)
                return
            if not handled:
                self.backend._store_result(spec, result)

        fut.add_done_callback(done)

    def _drain_with_error(self) -> None:
        while True:
            try:
                spec = self.queue.get_nowait()
            except queue.Empty:
                return
            if spec is not None:
                self.backend._store_error(spec, ActorDiedError(
                    self.spec.actor_id.hex(), self.death_reason))

    def submit(self, spec: TaskSpec) -> None:
        if self.dead:
            self.backend._store_error(spec, ActorDiedError(
                self.spec.actor_id.hex(), self.death_reason))
            return
        self.queue.put(spec)

    def kill(self, reason: str = "killed via kill()") -> None:
        self.dead = True
        self.death_reason = reason
        self.queue.put(None)


class LocalBackend:
    def __init__(self, worker, num_cpus: Optional[int] = None,
                 resources: Optional[Dict[str, float]] = None):
        self.worker = worker
        n = num_cpus or 8
        self.pool = ThreadPoolExecutor(max_workers=max(2, n),
                                       thread_name_prefix="rtpu-local")
        self.actors: Dict[ActorID, _LocalActor] = {}
        self.named_actors: Dict[str, ActorID] = {}
        self.cancelled: set = set()
        self._streams: Dict[bytes, Any] = {}
        self._lock = threading.Lock()
        self.resources = {"CPU": float(n), **(resources or {})}

    # -------------------------------------------------------------- objects

    def put_object(self, object_id: ObjectID, value: Any) -> None:
        self.worker.memory_store.put(object_id, value)

    def free_object(self, object_id: ObjectID) -> None:
        self.worker.memory_store.delete(object_id)

    def try_resolve(self, ref: ObjectRef) -> bool:
        return self.worker.memory_store.is_ready(ref.id())

    def poke_resolve(self, ref: ObjectRef) -> None:
        pass

    def get_from_store(self, ref: ObjectRef):
        raise RuntimeError("local mode has no shm store")

    # ---------------------------------------------------------------- tasks

    def _resolve_args(self, args: List[TaskArg]) -> List[Any]:
        out = []
        for a in args:
            if a.is_ref:
                out.append(self.worker.get(
                    ObjectRef(a.object_id, a.owner, _register=False)))
            else:
                out.append(a.value)
        return out

    def _store_result(self, spec: TaskSpec, result: Any) -> None:
        rids = spec.return_ids()
        if spec.num_returns == 1:
            self.worker.memory_store.put(rids[0], result)
        else:
            if not isinstance(result, tuple) or len(result) != spec.num_returns:
                err = ValueError(
                    f"task {spec.name} declared num_returns={spec.num_returns} "
                    f"but returned {type(result)}")
                self._store_error(spec, err)
                return
            for rid, val in zip(rids, result):
                self.worker.memory_store.put(rid, val)
        for a in spec.args:
            if a.is_ref:
                self.worker.refcounter.on_serialized_ref_done(a.object_id)

    def _store_error(self, spec: TaskSpec, exc: BaseException) -> None:
        if not isinstance(exc, (TaskError, ActorDiedError, TaskCancelledError)):
            exc = TaskError.from_exception(exc)
        if spec.streaming:
            self._finish_stream(spec, None, exc)
        for rid in spec.return_ids():
            self.worker.memory_store.put(rid, exc, is_error=True)
        for a in spec.args:
            if a.is_ref:
                self.worker.refcounter.on_serialized_ref_done(a.object_id)

    # ------------------------------------------------------------ streaming
    # Same owner-side contract as the cluster backend: items land in the
    # memory store under for_return ids as they are produced; the
    # StreamState records completion/error (see core/generator.py).

    def register_stream(self, spec: TaskSpec):
        from ray_tpu_torch.core.generator import ObjectRefGenerator, StreamState
        state = StreamState()
        with self._lock:
            self._streams[spec.task_id.binary()] = state
        return ObjectRefGenerator(spec.task_id, self.worker.worker_id,
                                  self.worker, state)

    def _stream_state(self, spec: TaskSpec):
        with self._lock:
            return self._streams.get(spec.task_id.binary())

    def _finish_stream(self, spec: TaskSpec, total, error) -> None:
        """Complete the stream; the entry stays until the generator is
        GC'd (unregister_stream), which also frees unconsumed items."""
        with self._lock:
            state = self._streams.get(spec.task_id.binary())
        if state is not None:
            if error is not None and not isinstance(
                    error, (TaskError, ActorDiedError, TaskCancelledError)):
                error = TaskError.from_exception(error)
            state.finish(total, error)

    def unregister_stream(self, task_id) -> None:
        with self._lock:
            self._streams.pop(task_id.binary(), None)

    def _store_stream_item(self, spec: TaskSpec, index: int, value) -> None:
        oid = ObjectID.for_return(spec.task_id, index)
        self.worker.refcounter.mark_owned(oid)
        self.worker.memory_store.put(oid, value)
        state = self._stream_state(spec)
        if state is None or not state.record_arrival(index):
            # straggler after the generator was dropped: free immediately,
            # nothing will ever consume it (mirrors the cluster backend)
            self.worker.refcounter.untrack(oid)
            self.worker.memory_store.delete(oid)

    def _drain_stream(self, spec: TaskSpec, result) -> None:
        i = 0
        try:
            for v in iter(result):
                i += 1
                self._store_stream_item(spec, i, v)
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, (SystemExit, KeyboardInterrupt)):
                raise
            self._finish_stream(spec, i, e)
            return
        finally:
            for a in spec.args:
                if a.is_ref:
                    self.worker.refcounter.on_serialized_ref_done(a.object_id)
        self._finish_stream(spec, i, None)

    def submit_task(self, spec: TaskSpec) -> None:
        def _run(attempt: int = 0):
            if spec.task_id in self.cancelled:
                self._store_error(spec, TaskCancelledError(spec.task_id.hex()))
                return
            try:
                args = self._resolve_args(spec.args)
                with _applied_runtime_env(spec.runtime_env):
                    result = spec.function(*args, **spec.kwargs)
                    if spec.streaming:
                        self._drain_stream(spec, result)
                        return
                self._store_result(spec, result)
            except BaseException as e:  # noqa: BLE001
                # In local mode every failure is an application error, so the
                # reference's system-error retry path (worker crash) cannot
                # occur; retry only when the user opted in via
                # retry_exceptions (reference: max_retries semantics).
                if attempt < spec.max_retries and spec.retry_exceptions:
                    self.pool.submit(_run, attempt + 1)
                else:
                    self._store_error(spec, e)

        self.pool.submit(_run)

    # --------------------------------------------------------------- actors

    def create_actor(self, spec: ActorCreationSpec) -> None:
        actor = _LocalActor(self, spec)
        with self._lock:
            self.actors[spec.actor_id] = actor
            if spec.registered_name:
                self.named_actors[
                    f"{spec.namespace}:{spec.registered_name}"] = spec.actor_id

    def submit_actor_task(self, spec: TaskSpec) -> None:
        with self._lock:
            actor = self.actors.get(spec.actor_id)
        if actor is None:
            self._store_error(spec, ActorDiedError(
                spec.actor_id.hex(), "unknown actor"))
            return
        actor.submit(spec)

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        with self._lock:
            actor = self.actors.get(actor_id)
        if actor is not None:
            actor.kill()

    def get_actor_by_name(self, name: str, namespace: str) -> Optional[ActorCreationSpec]:
        with self._lock:
            actor_id = self.named_actors.get(f"{namespace}:{name}")
            if actor_id is None:
                return None
            return self.actors[actor_id].spec

    def cancel_task(self, ref: ObjectRef, force: bool) -> None:
        self.cancelled.add(ref.id().task_id())

    # ------------------------------------------------------ placement groups
    # Local mode: reservations are bookkeeping only (one in-process "node");
    # a PG is CREATED iff each bundle fits the node's total resources.

    def create_placement_group(self, pg_id: bytes, bundles: list,
                               strategy: str, name: str = "") -> None:
        feasible = all(
            all(self.resources.get(k, 0.0) >= v for k, v in b.items())
            for b in bundles)
        with self._lock:
            if not hasattr(self, "_pgs"):
                self._pgs: Dict[bytes, dict] = {}
            self._pgs[pg_id] = {
                "bundles": bundles, "strategy": strategy, "name": name,
                "state": "CREATED" if feasible else "INFEASIBLE",
                "nodes": ["local"] * len(bundles) if feasible else None}

    def remove_placement_group(self, pg_id: bytes) -> bool:
        with self._lock:
            return getattr(self, "_pgs", {}).pop(pg_id, None) is not None

    def get_placement_group(self, pg_id: bytes):
        with self._lock:
            pg = getattr(self, "_pgs", {}).get(pg_id)
            return dict(pg) if pg else None

    # ----------------------------------------------------------------- misc

    def cluster_resources(self) -> Dict[str, float]:
        return dict(self.resources)

    def available_resources(self) -> Dict[str, float]:
        return dict(self.resources)

    def nodes(self) -> list:
        return [{"NodeID": "local", "Alive": True,
                 "Resources": dict(self.resources)}]

    def shutdown(self) -> None:
        with self._lock:
            for actor in self.actors.values():
                actor.kill("shutdown")
            self.actors.clear()
        self.pool.shutdown(wait=False, cancel_futures=True)
