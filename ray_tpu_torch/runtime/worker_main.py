"""Worker process — task execution loop + actor mode.

Role-equivalent to the reference's worker-side CoreWorker (reference:
src/ray/core_worker/core_worker.cc:3230 ExecuteTask, :3804 HandlePushTask;
ordered actor queues in transport/task_receiver.h:51): a leased worker
receives pushed tasks directly from the submitting owner over RPC, executes
them serially (or on `max_concurrency` threads for threaded actors), and
replies with results — small values inline, large values sealed into the
node's shm store with the location reported back to the owner.

The worker also runs the full client runtime (ClusterBackend), so task code
can itself submit tasks, create actors, and put/get objects (nested
remote calls — reference: workers are full CoreWorkers too).
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch.core import config as config_mod
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.exceptions import TaskCancelledError, TaskError
from ray_tpu_torch.runtime import wire
from ray_tpu_torch.runtime.protocol import (_COMBINED_DONE, DEFERRED, RpcClient,
                                      RpcError)
from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import trace_context


class _LogShipper:
    """Forwards worker stdout/stderr to the submitting owner process.

    Role-equivalent to the reference's log monitor -> GCS pubsub -> driver
    print pipeline (reference: python/ray/_private/log_monitor.py,
    worker.py:1970 prints with the (pid=...) prefix) — redesigned as a
    direct worker->owner push: output produced WHILE a task runs is
    attributed to that task's submitter via a contextvar, so prints land
    on the process that called .remote(), not a global driver.
    """

    MAX_BUFFER = 10_000  # lines; overflow drops the OLDEST, keeps the tail

    def __init__(self, backend):
        self.backend = backend
        # contextvar, not a thread-local: async actor methods run as
        # interleaved coroutines on ONE loop thread, and the context
        # captured at dispatch (run_coroutine_threadsafe copies the
        # submitting thread's context into the Task) keeps each
        # coroutine's prints attributed to ITS caller
        import contextvars
        self._owner_var = contextvars.ContextVar("rtpu_log_owner",
                                                 default=None)
        self._lock = threading.Lock()
        import collections as _collections
        self._buf: "_collections.deque" = _collections.deque()
        self._last_owner: Optional[bytes] = None
        self._dropped = 0
        threading.Thread(target=self._flush_loop, daemon=True,
                         name="log-ship").start()

    # -- attribution --

    def set_owner(self, owner: Optional[bytes]) -> None:
        self._owner_var.set(owner)
        if owner:
            self._last_owner = owner

    def current_owner(self) -> Optional[bytes]:
        # off-task output (background threads) goes to the most recent
        # submitter — better than losing it
        return self._owner_var.get() or self._last_owner

    # -- production --

    def emit(self, stream: str, text: str) -> None:
        owner = self.current_owner()
        if owner is None or not text:
            return
        with self._lock:
            if len(self._buf) >= self.MAX_BUFFER:
                # keep the newest output: the tail (the error) is the
                # diagnostically valuable part of a runaway burst
                self._buf.popleft()
                self._dropped += 1
            self._buf.append((owner, stream, text))

    def _flush_loop(self) -> None:
        while True:
            time.sleep(0.2)
            self.flush()

    def flush(self) -> None:
        import collections as _collections
        with self._lock:
            batch, self._buf = list(self._buf), _collections.deque()
            dropped, self._dropped = self._dropped, 0
        if not batch:
            if dropped:
                # the buffer drained between overflow and flush: carry
                # the count to the next non-empty flush so the "...N
                # lines dropped" notice is never itself dropped
                with self._lock:
                    self._dropped += dropped
            return
        by_owner: Dict[bytes, list] = {}
        for owner, stream, text in batch:
            by_owner.setdefault(owner, []).append((stream, text))
        if dropped:
            by_owner.setdefault(batch[-1][0], []).append(
                ("stderr", f"... {dropped} log lines dropped (buffer full)"))
        me = self.backend.worker.worker_id.hex()[:8]
        pid = os.getpid()
        for owner, lines in by_owner.items():
            try:
                self.backend.object_plane.owner_client(
                    WorkerID(owner)).oneway("log_batch", {
                        "worker": me, "pid": pid, "lines": lines})
            except Exception:  # noqa: BLE001 — log loss must never kill
                pass


class _TeeStream:
    """File-like wrapper: writes through to the real stream (which the
    node daemon redirects into the durable worker-<id>.{out,err} files)
    AND ships complete lines to the log shipper (owner push) and the
    structured log plane (local file sink + head ring) — so output
    produced before the first task, when the shipper has no owner yet,
    is still captured instead of silently discarded."""

    def __init__(self, real, name: str,
                 shipper: Optional[_LogShipper] = None):
        self._real = real
        self._name = name
        self._shipper = shipper
        self._partial = ""

    def _emit(self, line: str) -> None:
        if self._shipper is not None:
            self._shipper.emit(self._name, line)
        if not line:
            return
        try:
            from ray_tpu_torch.util import log_plane
            logger = log_plane.get_global()
            if logger is not None:
                # stderr is error severity: the LogStore's severity-
                # indexed rings keep it alive through debug floods, and
                # tracebacks feed the error-fingerprint/storm machinery
                logger.log("error" if self._name == "stderr" else "info",
                           line, stream=self._name)
        except Exception:  # noqa: BLE001 — log loss must never kill
            pass

    def write(self, text) -> int:
        n = self._real.write(text)
        self._partial += str(text)
        while "\n" in self._partial:
            line, self._partial = self._partial.split("\n", 1)
            self._emit(line)
        return n

    def flush(self) -> None:
        # a trailing partial line (print(..., end='') then flush, or
        # process exit) is emitted, not dropped: the last words before
        # a crash are exactly the ones written without a newline
        if self._partial:
            line, self._partial = self._partial, ""
            self._emit(line)
        self._real.flush()

    def __getattr__(self, attr):
        return getattr(self._real, attr)


class _BatchReplyCollector:
    """Accumulates the per-task replies of ONE push_task_batch frame and
    ships them back as a single combined reply when the last completes.

    This is the worker half of the combined-batch fast path: a 32-task
    frame costs one pickle.dumps + one transport frame in each direction
    instead of 32 (reference analogue: the raylet's batched
    PushTaskReply streaming, core_worker/transport/direct_actor_transport
    — redesigned here as symmetric batch frames)."""

    __slots__ = ("ctx", "n", "slots", "lock", "done")

    def __init__(self, ctx, n: int):
        self.ctx = ctx
        self.n = n
        self.slots: List[Any] = [None] * n
        self.lock = threading.Lock()
        self.done = 0

    def reply_at(self, i: int, value, error) -> None:
        with self.lock:
            if self.slots[i] is not None:
                return
            self.slots[i] = (value, error)
            self.done += 1
            flush = self.done == self.n
        if flush:
            self.ctx.reply(self.slots)


class _EagerReplyCollector:
    """Per-slot eager replies for a combined batch: each task's result is
    flushed on its own pre-allocated req_id the moment it completes, then
    a done marker closes the main req_id. Replaces the buffer-until-last
    behaviour of _BatchReplyCollector when the client sent slot ids —
    buffering deadlocked nested gets (task A in the batch blocked on a
    ref produced by task B in the SAME batch: B's reply was withheld
    until A finished, which never happened)."""

    __slots__ = ("ctx", "slot_ids", "lock", "replied", "done")

    def __init__(self, ctx, slot_ids):
        self.ctx = ctx
        self.slot_ids = slot_ids
        self.lock = threading.Lock()
        self.replied = [False] * len(slot_ids)
        self.done = 0

    def reply_at(self, i: int, value, error) -> None:
        with self.lock:
            if self.replied[i]:
                return
            self.replied[i] = True
            self.done += 1
            last = self.done == len(self.slot_ids)
        self.ctx.reply_to(self.slot_ids[i], value, error)
        if last:
            # marker is sent AFTER every slot reply on the same ordered
            # stream, so the client has fired all callbacks when it lands
            self.ctx.reply(_COMBINED_DONE)


class _SubCtx:
    """HandlerContext stand-in for one task inside a combined batch."""

    __slots__ = ("_coll", "_i", "peer", "replied")

    def __init__(self, coll: _BatchReplyCollector, i: int, peer):
        self._coll = coll
        self._i = i
        self.peer = peer
        self.replied = False

    def reply(self, value=None, error=None) -> None:
        if self.replied:
            return
        self.replied = True
        self._coll.reply_at(self._i, value, error)


class Executor:
    """Serial (or n-threaded, or asyncio-loop) execution of pushed tasks."""

    def __init__(self, backend, worker):
        self.backend = backend
        self.worker = worker
        self.queue: "queue.Queue" = queue.Queue()
        self.fn_cache: Dict[str, Any] = {}
        self.cancelled: set = set()
        self.actor_instance: Optional[Any] = None
        self.actor_id: Optional[bytes] = None
        # async actors: all methods run on this event loop (reference:
        # fiber-based async execution, core_worker/transport/fiber.h role —
        # here a plain asyncio loop thread + semaphore)
        self._aio_loop = None
        self._aio_sem = None
        # packages async-actor replies (serialize + shm copy + socket write)
        # off the event-loop thread so one large result can't stall every
        # interleaved coroutine
        from concurrent.futures import ThreadPoolExecutor
        self._reply_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="reply")
        self._threads: List[threading.Thread] = []
        # concurrency groups (reference: ConcurrencyGroupManager,
        # core_worker/transport/concurrency_group_manager.h): each group
        # gets its own queue + thread lane; methods route by name so
        # control-plane probes never queue behind busy handler lanes.
        self._group_queues: Dict[str, "queue.Queue"] = {}
        self._method_groups: Dict[str, str] = {}
        self.log_shipper: Optional[_LogShipper] = None
        self._start_threads(1)

    def _start_threads(self, n: int, q: Optional["queue.Queue"] = None,
                       tag: str = "exec") -> None:
        q = q if q is not None else self.queue
        # exact-tag match (name is "<tag>-<index>"): a prefix test would
        # over-count when one group's name prefixes another's ("a", "a-b")
        have = sum(1 for t in self._threads
                   if t.name.rsplit("-", 1)[0] == tag)
        for i in range(have, n):
            t = threading.Thread(target=self._loop, args=(q,), daemon=True,
                                 name=f"{tag}-{i}")
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------- handlers

    def handle_push_task(self, payload, ctx):
        group = self._method_groups.get(payload.get("method_name") or "")
        q = self._group_queues.get(group) if group else None
        (q if q is not None else self.queue).put((payload, ctx))
        return DEFERRED

    def handle_push_task_batch(self, payloads, ctx):
        """N tasks in one frame, ONE combined reply frame (see
        _BatchReplyCollector). Tasks still route individually through
        their concurrency-group queues, so ordering semantics match the
        per-task path exactly. Clients that pre-allocated per-slot reply
        ids (ctx.slot_ids) get each result flushed eagerly instead
        (_EagerReplyCollector); old-format frames keep the single
        combined reply."""
        slot_ids = getattr(ctx, "slot_ids", None)
        if slot_ids is not None and len(slot_ids) == len(payloads):
            coll = _EagerReplyCollector(ctx, slot_ids)
        else:
            coll = _BatchReplyCollector(ctx, len(payloads))
        for i, p in enumerate(payloads):
            group = self._method_groups.get(p.get("method_name") or "")
            q = self._group_queues.get(group) if group else None
            (q if q is not None else self.queue).put(
                (p, _SubCtx(coll, i, ctx.peer)))
        return DEFERRED

    def handle_cancel(self, payload, ctx):
        self.cancelled.add(payload["task_id"])
        return True

    def handle_dag_start_loop(self, payload, ctx):
        """Pre-launch a compiled-DAG execution loop on this actor
        (reference: compiled_dag_node.py do_exec_tasks at :188 — the
        actor-side half of aDAG): read the input shm ring, run the bound
        method on the live actor instance, write the output ring. The
        stop sentinel cascades: closing our input closes our output."""
        from ray_tpu_torch.runtime.channel import ChannelClosed, ShmChannel
        store = self.backend.object_plane.store
        inc = ShmChannel(store, payload["in"], payload["capacity"])
        out = ShmChannel(store, payload["out"], payload["capacity"])
        method_name = payload["method"]

        def loop():
            while True:
                try:
                    tag, val = inc.get(timeout=None)
                except ChannelClosed:
                    out.close()
                    return
                except Exception:  # noqa: BLE001 — store torn down
                    return
                if tag == "e":  # upstream error: pass through untouched
                    out.put((tag, val))
                    continue
                try:
                    method = getattr(self.actor_instance, method_name)
                    out.put(("v", method(val)))
                except BaseException as e:  # noqa: BLE001
                    if isinstance(e, (SystemExit, KeyboardInterrupt)):
                        raise
                    try:
                        out.put(("e", e))
                    except Exception:  # unserializable exception: a dead
                        # loop would hang the whole pipeline — ship a
                        # stringified stand-in instead
                        out.put(("e", RuntimeError(
                            f"{type(e).__name__}: {e!r} "
                            f"(original not serializable)")))

        threading.Thread(target=loop, daemon=True, name="dag-loop").start()
        return self.backend.local_node_id

    def handle_become_actor(self, payload, ctx):
        # Ack immediately — construction runs async on the exec thread so an
        # arbitrarily slow __init__ can't trip the node->worker RPC deadline
        # (liveness is tracked via actor_ready/actor_failed to the head).
        self.queue.put((("__become_actor__", payload), None))
        return True

    # ------------------------------------------------------------ execution

    def _loop(self, q: "queue.Queue") -> None:
        while True:
            item, ctx = q.get()
            try:
                if isinstance(item, tuple) and item and \
                        item[0] == "__become_actor__":
                    self._become_actor(item[1], ctx)
                else:
                    self._execute(item, ctx)
            except BaseException as e:  # noqa: BLE001
                try:
                    if ctx is not None:
                        ctx.reply(None, error=e)
                except Exception:
                    pass

    def _resolve_function(self, key: str):
        fn = self.fn_cache.get(key)
        if fn is None:
            blob = self.backend.kv_get(key)
            if blob is None:
                raise TaskError("LookupError", f"function {key} not exported",
                                "<head kv miss>")
            fn = cloudpickle.loads(blob)
            self.fn_cache[key] = fn
        return fn

    def _resolve_args(self, wire_args: List[dict], kwargs_blob: bytes):
        args = []
        for a in wire_args:
            if "ref" in a:
                oid, owner = a["ref"]
                ref = ObjectRef(ObjectID(oid), WorkerID(owner))
                args.append(self.worker.get(ref))
            else:
                args.append(serialization.deserialize(a["inline"]))
        kwargs = serialization.deserialize(kwargs_blob)
        return args, kwargs

    def _become_actor(self, payload: dict, ctx) -> None:
        spec = pickle_loads(payload["spec_bytes"])
        self.actor_id = spec["actor_id"]
        num_restarts = payload.get("num_restarts", 0)
        try:
            cls = cloudpickle.loads(spec["cls_bytes"])
            args, kwargs = self._resolve_args(spec["args"], spec["kwargs"])
            self.actor_instance = cls(*args, **kwargs)
            # ALL extra lanes (default max_concurrency and groups) start
            # only AFTER construction: until then every call sits in the
            # default queue behind this __become_actor__ item, whose
            # single consumer is this thread — any extra consumer could
            # dequeue a method while __init__ is still in flight and see a
            # None instance.
            import asyncio
            import inspect
            # scan the whole MRO (dir), not vars(cls): inherited coroutine
            # methods must also flip the actor into async mode
            is_async = any(
                inspect.iscoroutinefunction(getattr(cls, n, None))
                or inspect.isasyncgenfunction(getattr(cls, n, None))
                for n in dir(cls))
            mc = spec.get("max_concurrency")
            if is_async:
                # async actor: every method runs on one event loop; the
                # semaphore bounds in-flight coroutines (reference default
                # 1000 for async actors)
                self._aio_loop = asyncio.new_event_loop()
                self._aio_sem = asyncio.Semaphore(mc if mc else 1000)
                threading.Thread(target=self._aio_loop.run_forever,
                                 daemon=True, name="actor-aio").start()
            elif mc and mc > 1:
                self._start_threads(mc)
            for gname, gn in (spec.get("concurrency_groups") or {}).items():
                gq: "queue.Queue" = queue.Queue()
                self._group_queues[gname] = gq
                self._start_threads(max(1, int(gn)), q=gq, tag=f"cg-{gname}")
            self._method_groups = dict(spec.get("method_groups") or {})
        except BaseException as e:  # noqa: BLE001
            tb = traceback.format_exc()
            try:
                self.backend.head.call("actor_failed", {
                    "actor_id": spec["actor_id"],
                    "num_restarts": num_restarts,
                    "reason": f"{type(e).__name__}: {e}\n{tb}"})
            except RpcError:
                pass
            return
        try:
            self.backend.head.call("actor_ready", {
                "actor_id": spec["actor_id"],
                "num_restarts": num_restarts,
                "address": self.backend.server.address})
        except RpcError:
            pass

    def _execute(self, payload: dict, ctx) -> None:
        task_id = payload["task_id"]
        if task_id in self.cancelled:
            ctx.reply({"results": None, "cancelled": True})
            return
        self.worker.current_task_id = TaskID(task_id)
        if self.log_shipper is not None:
            self.log_shipper.set_owner(payload.get("owner") or None)
        # restore the submitter's trace context as ambient for the task
        # body: nested .remote() calls stamp THIS span as their parent,
        # linking the cross-process chain into one trace. Contextvar, so
        # async-actor dispatch carries it into the coroutine (the loop
        # handoff snapshots this thread's context).
        trace_tok = trace_context.activate(
            payload.get("trace_id"), payload.get("span_id"))
        t_start = time.time()
        try:
            args, kwargs = self._resolve_args(payload["args"],
                                              payload["kwargs"])
            if payload.get("actor_id") is not None:
                if self.actor_instance is None:
                    raise RuntimeError("push to non-actor worker")
                method = getattr(self.actor_instance, payload["method_name"],
                                 None)
                if method is None:
                    raise AttributeError(
                        f"actor has no method {payload['method_name']!r}")
                if self._aio_loop is not None:
                    # async actor: hand off to the loop WITHOUT blocking
                    # this lane — that's what lets one replica interleave
                    # many in-flight requests
                    self._dispatch_async(method, args, kwargs, payload, ctx,
                                         t_start)
                    return
                result = method(*args, **kwargs)
            else:
                fn = self._resolve_function(payload["function_key"])
                result = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, (SystemExit, KeyboardInterrupt)):
                raise
            self._reply_error(payload, ctx, e, t_start)
            return
        finally:
            self.worker.current_task_id = None
            trace_context.deactivate(trace_tok)
        if payload.get("streaming"):
            self._stream_out(payload, ctx, result, t_start)
            return
        self._reply_ok(payload, ctx, result, t_start)

    # ----------------------------------------------------- reply packaging

    def _record_span(self, payload: dict, t_start: float, ok: bool) -> None:
        # task span -> event buffer (flushed by the telemetry thread;
        # reference: TaskEventBuffer state transitions)
        buf = getattr(self.backend, "event_buffer", None)
        if buf is None:
            return
        name = payload.get("name") or payload.get("method_name") or "task"
        span_id = payload.get("span_id", "")
        buf.record(
            name=name,
            task_id=TaskID(payload["task_id"]).hex()[:16],
            kind="actor_task" if payload.get("actor_id") else "task",
            start=t_start, end=time.time(), ok=ok,
            trace_id=payload.get("trace_id", ""),
            span_id=span_id,
            parent_span_id=payload.get("parent_span_id", ""))
        # scheduler-phase companion span: submit→start, a CHILD of the
        # execution span so a trace view separates queueing delay from
        # run time (reference: ray task-state timeline's
        # PENDING_NODE_ASSIGNMENT..RUNNING segments)
        submit_ts = payload.get("submit_ts")
        if submit_ts is None:
            return
        try:
            submit_ts = float(submit_ts)
        except (TypeError, ValueError):
            return
        import hashlib
        sched_sid = hashlib.sha256(
            f"sched:{span_id or payload['task_id']!r}".encode()
        ).hexdigest()[:16]
        buf.record(
            name=f"{name}::sched",
            task_id=TaskID(payload["task_id"]).hex()[:16],
            kind="sched",
            start=submit_ts, end=t_start, ok=True,
            trace_id=payload.get("trace_id", ""),
            span_id=sched_sid,
            parent_span_id=span_id,
            lease_ts=payload.get("lease_ts"))
        metrics_mod.submit_to_start_histogram().observe(
            max(0.0, t_start - submit_ts))

    def _reply_error(self, payload: dict, ctx, exc: BaseException,
                     t_start: float) -> None:
        # any reply releases the submitter's serialize-time arg pins, so
        # our queued add-borrower registrations for those args must reach
        # their owners first (transfer-before-release, borrower side)
        self.backend.flush_borrows()
        self._record_span(payload, t_start, ok=False)
        so = serialization.serialize_error(exc)
        n = max(1, payload["num_returns"])
        if payload.get("streaming"):
            ctx.reply({"streaming_count": 0,
                       "streaming_error": so.to_bytes()})
            return
        ctx.reply({"results": [{"inline": so.to_bytes(),
                                "is_error": True}] * n})

    def _reply_ok(self, payload: dict, ctx, result: Any,
                  t_start: float) -> None:
        self.backend.flush_borrows()  # see _reply_error: adds-before-reply
        num_returns = payload["num_returns"]
        if num_returns == 1:
            values = [result]
        else:
            if not isinstance(result, tuple) or len(result) != num_returns:
                self._reply_error(payload, ctx, ValueError(
                    f"declared num_returns={num_returns} but returned "
                    f"{type(result)}"), t_start)
                return
            values = list(result)
        self._record_span(payload, t_start, ok=True)
        cfg = config_mod.GlobalConfig
        results = []
        contained = []
        tid = TaskID(payload["task_id"])
        for i, v in enumerate(values):
            so = serialization.serialize(v)
            contained.extend(so.contained_refs)
            if so.total_bytes <= cfg.memory_store_threshold_bytes:
                results.append({"inline": so.to_bytes(), "is_error": False})
            else:
                oid = ObjectID.for_return(tid, i + 1)
                node = self.backend.object_plane.store_result_bytes(
                    oid, so.to_bytes(),
                    owner=(payload.get("owner") or b"").hex())
                results.append({"in_shm": node})
        # Transfer-before-release (owner-side): refs WE own riding in this
        # reply get the caller pre-registered as a borrower BEFORE the
        # serialize-time pins drop. Without this, releasing the pin races
        # the caller's add_borrower registration, and the loser's object is
        # freed while the caller holds a live ref (observed: the LAST ref
        # of a 20-ref list reply lost the race and get() hung on
        # "pending"). add_borrower is set-based, so the caller's own later
        # registration is idempotent (reference: reference_count.h borrower
        # bookkeeping — returned refs are charged to the caller up front).
        caller = payload.get("owner")
        for r in contained:
            if caller and r.owner_id() == self.worker.worker_id:
                self.worker.refcounter.add_borrower(r.id(), caller)
        ctx.reply({"results": results})
        for r in contained:
            self.worker.refcounter.on_serialized_ref_done(r.id())

    # ------------------------------------------------------------ streaming

    def _send_stream_item(self, owner_client, payload: dict, index: int,
                          value: Any) -> None:
        """Ship one yielded value to the owner (inline or via shm)."""
        cfg = config_mod.GlobalConfig
        oid = ObjectID.for_return(TaskID(payload["task_id"]), index)
        so = serialization.serialize(value)
        msg = {"task_id": payload["task_id"], "object_id": oid.binary(),
               "index": index}
        if so.total_bytes <= cfg.memory_store_threshold_bytes:
            msg["inline"] = so.to_bytes()
        else:
            # creator pin released: the owner's ref is the only keeper, and
            # streamed items are meant to be consumed-and-dropped
            msg["in_shm"] = self.backend.object_plane.store_result_bytes(
                oid, so.to_bytes(),
                owner=(payload.get("owner") or b"").hex())
        caller = payload.get("owner")
        for r in so.contained_refs:
            # same transfer-before-release as _reply_ok
            if caller and r.owner_id() == self.worker.worker_id:
                self.worker.refcounter.add_borrower(r.id(), caller)
        self.backend.flush_borrows()  # adds-before-ship for borrowed refs
        owner_client.oneway("stream_item", msg)
        for r in so.contained_refs:
            self.worker.refcounter.on_serialized_ref_done(r.id())

    def _stream_out(self, payload: dict, ctx, result: Any,
                    t_start: float) -> None:
        """Drain a generator task, shipping items as they are produced
        (reference: streaming generator protocol, _raylet.pyx:1391). A
        generator's body runs as it is drained, so the submitter's trace
        context is ambient here too, as for the task body: a served
        stream's engine record carries the caller's trace id."""
        owner = self.backend.object_plane.owner_client(
            WorkerID(payload["owner"]))
        i = 0
        trace_tok = trace_context.activate(
            payload.get("trace_id"), payload.get("span_id"))
        try:
            for v in iter(result):
                i += 1
                self._send_stream_item(owner, payload, i, v)
        except BaseException as e:  # noqa: BLE001
            self._record_span(payload, t_start, ok=False)
            so = serialization.serialize_error(e)
            self.backend.flush_borrows()  # adds-before-reply
            ctx.reply({"streaming_count": i,
                       "streaming_error": so.to_bytes()})
            return
        finally:
            trace_context.deactivate(trace_tok)
        self._record_span(payload, t_start, ok=True)
        self.backend.flush_borrows()  # see _reply_error: adds-before-reply
        ctx.reply({"streaming_count": i})

    # ---------------------------------------------------------- async actors

    def _dispatch_async(self, method, args, kwargs, payload: dict, ctx,
                        t_start: float) -> None:
        import asyncio
        import inspect

        streaming = bool(payload.get("streaming"))

        def _stream_reply(i: int, exc: Optional[BaseException]) -> None:
            """Reply for a streaming call, preserving the count of items
            already shipped so the consumer drains them before seeing the
            error (same contract as the sync _stream_out path)."""
            self.backend.flush_borrows()  # adds-before-reply
            if exc is None:
                self._record_span(payload, t_start, ok=True)
                ctx.reply({"streaming_count": i})
            else:
                self._record_span(payload, t_start, ok=False)
                so = serialization.serialize_error(exc)
                ctx.reply({"streaming_count": i,
                           "streaming_error": so.to_bytes()})

        async def run():
            async with self._aio_sem:
                if inspect.isasyncgenfunction(method):
                    if not streaming:
                        raise TypeError(
                            f"{payload['method_name']} is an async generator"
                            f" — call it with num_returns='streaming'")
                    owner = self.backend.object_plane.owner_client(
                        WorkerID(payload["owner"]))
                    i = 0
                    try:
                        async for v in method(*args, **kwargs):
                            i += 1
                            # blocking socket write; cheap enough on-loop
                            # for token-sized payloads
                            self._send_stream_item(owner, payload, i, v)
                    except BaseException as e:  # noqa: BLE001
                        _stream_reply(i, e)
                        return None
                    _stream_reply(i, None)
                    return None
                out = method(*args, **kwargs)
                if inspect.isawaitable(out):
                    out = await out
                if streaming:
                    owner = self.backend.object_plane.owner_client(
                        WorkerID(payload["owner"]))
                    i = 0
                    try:
                        for v in iter(out):
                            i += 1
                            self._send_stream_item(owner, payload, i, v)
                    except BaseException as e:  # noqa: BLE001
                        _stream_reply(i, e)
                        return None
                    _stream_reply(i, None)
                    return None
                return out

        fut = asyncio.run_coroutine_threadsafe(run(), self._aio_loop)

        def package(f):
            try:
                result = f.result()
            except BaseException as e:  # noqa: BLE001
                # streaming paths that started shipping replied already
                # (ctx.reply is once-only); this covers pre-iteration
                # failures and non-streaming errors
                self._reply_error(payload, ctx, e, t_start)
                return
            if streaming:
                return  # replied inside run() with the true item count
            self._reply_ok(payload, ctx, result, t_start)

        # done-callbacks run ON the loop thread; serializing a large result
        # there would stall every interleaved coroutine, so hand reply
        # packaging to the reply pool and keep the loop free
        fut.add_done_callback(
            lambda f: self._reply_pool.submit(package, f))


def pickle_loads(data: bytes):
    import pickle
    return pickle.loads(data)


def _dump_stacks() -> dict:
    """All thread stacks of this worker, formatted — the in-process
    analog of the reference's on-demand py-spy profiling
    (dashboard/modules/reporter/profile_manager.py:82): no external
    profiler binary exists in the image, but sys._current_frames gives
    the same "where is this worker stuck" answer."""
    import traceback
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for ident, frame in frames.items():
        # key by name AND ident: same-named threads (e.g. pooled client
        # readers) must not overwrite each other in the report
        key = f"{names.get(ident, 'thread')}-{ident}"
        stacks[key] = "".join(traceback.format_stack(frame))
    return {"pid": os.getpid(), "num_threads": len(stacks),
            "stacks": stacks}


def _profile_burst(p, ctx) -> dict:
    """Synchronous collapsed-stack burst of this worker's threads (the
    worker leg of 'profile --record'; runs on the RPC lane so the task
    thread under observation is never perturbed)."""
    from ray_tpu_torch.util.stack_profiler import burst_capture
    p = p or {}
    return burst_capture(float(p.get("seconds", 2.0) or 2.0),
                         float(p.get("hz", 99.0) or 99.0))


def main() -> None:
    node_addr, head_addr, shm_name, worker_hex, cfg_json = sys.argv[1:6]
    config_mod.GlobalConfig.apply(json.loads(cfg_json))
    # per-worker RTPT_* env (e.g. a runtime_env's env_vars) wins over the
    # propagated cluster table — same precedence as the reference's RAY_*
    # per-process overrides (ray_config_def.h env lookup happens in-process)
    config_mod.GlobalConfig.apply_env_overrides()

    # runtime_env working_dir: the node daemon spawned us with cwd set to
    # the materialized package; make its modules importable like the
    # reference does (runtime_env/working_dir.py adds it to sys.path)
    _wd = os.environ.get("RTPT_WORKING_DIR")
    if _wd:
        sys.path.insert(0, _wd)

    # Die with the node daemon (reference: raylet owns worker lifetimes —
    # node death must kill its workers or "node failure" tests lie).
    try:
        import ctypes
        import signal
        PR_SET_PDEATHSIG = 1
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(
            PR_SET_PDEATHSIG, signal.SIGKILL)
    except Exception:
        pass

    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.runtime.cluster_backend import ClusterBackend

    worker_id = WorkerID(bytes.fromhex(worker_hex))
    backend = ClusterBackend.connect_as_worker(
        global_worker, head_addr, shm_name, worker_id)
    executor = Executor(backend, global_worker)
    # structured log plane: records go to worker-<id>.log (same dir the
    # node daemon pointed our raw .out/.err streams at) and ride the
    # backend's telemetry flush to the head's LogStore
    from ray_tpu_torch.util import log_plane
    try:
        log_plane.ensure_started(
            role="worker",
            node=os.environ.get("RTPT_NODE_ID", "")[:12],
            worker=worker_hex[:12],
            log_dir=log_plane.session_log_dir(
                os.environ.get("RTPT_SESSION", "")),
            filename=f"worker-{worker_hex[:12]}.log")
    except Exception:  # noqa: BLE001 — logging must never stop boot
        pass
    # XLA compile tracker: jax-free at this point (the seam only hooks
    # jax.monitoring once user code actually imports jax — re-checked
    # at every telemetry flush), so workers that never touch jax pay
    # one idle object
    try:
        from ray_tpu_torch.util import compile_tracker
        compile_tracker.ensure_started(
            role="worker",
            node=os.environ.get("RTPT_NODE_ID", "")[:12],
            worker=worker_hex[:12])
    except Exception:  # noqa: BLE001 — tracking must never stop boot
        pass
    shipper = None
    if config_mod.GlobalConfig.log_to_driver:
        shipper = _LogShipper(backend)
        executor.log_shipper = shipper
    if shipper is not None or log_plane.get_global() is not None:
        sys.stdout = _TeeStream(sys.stdout, "stdout", shipper)
        sys.stderr = _TeeStream(sys.stderr, "stderr", shipper)
        # emit trailing partial lines on orderly exit (SIGKILL loses
        # them from the rings — the durable .out/.err still have them)
        import atexit
        atexit.register(sys.stderr.flush)
        atexit.register(sys.stdout.flush)
    backend.server.handlers.update({
        "push_task": executor.handle_push_task,
        "push_task_batch": executor.handle_push_task_batch,
        "become_actor": executor.handle_become_actor,
        "cancel_task": executor.handle_cancel,
        "dag_start_loop": executor.handle_dag_start_loop,
        "ping": lambda p, c: "pong",
        "dump_stacks": lambda p, c: _dump_stacks(),
        # on-demand burst capture (node daemon fans 'profiles_record'
        # here); samples THIS worker's task threads from the RPC lane
        "profile_burst": _profile_burst,
        "exit": lambda p, c: os._exit(0),
    })
    backend.server.inline_methods.add("push_task")
    backend.server.inline_methods.add("push_task_batch")

    node = RpcClient(node_addr, name="worker->node")
    node.call_retrying("worker_ready", {
        "worker_id": worker_id.binary(),
        "address": backend.server.address,
    })
    # park forever; the node daemon owns our lifetime
    threading.Event().wait()


if __name__ == "__main__":
    main()
