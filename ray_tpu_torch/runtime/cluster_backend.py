"""Cluster backend — the client-side transport for the multiprocess runtime.

Role-equivalent to the reference's owner-side CoreWorker submission machinery
(reference: src/ray/core_worker/core_worker.cc:2476 SubmitTask, :2557
CreateActor, :2804 SubmitActorTask) with its two transports:

 - _TaskSubmitter: lease-based pipelined submission for normal tasks
   (reference: transport/normal_task_submitter.h:74) — leases are requested
   from the head, cached while the same resource shape has pending work
   (the lease-reuse trick that makes reference task throughput possible),
   and tasks are pushed directly to the leased worker.
 - _ActorSubmitter: direct worker-to-worker pushes with per-handle ordering
   and restart-aware address re-resolution (reference:
   transport/actor_task_submitter.h:75).

`connect_or_start` is the process-supervision role of the reference's Node
(reference: python/ray/_private/node.py:1189 start_gcs_server, :1223
start_raylet): it boots the head and a node daemon as subprocesses when no
address is given.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("ray_tpu_torch.runtime")

from ray_tpu_torch.core import config as config_mod
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core._native import ShmStore
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, JobID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskSpec
from ray_tpu_torch.exceptions import (ActorDiedError, OutOfMemoryError,
                                PlacementGroupUnschedulableError,
                                TaskCancelledError, TaskError,
                                WorkerCrashedError)
from ray_tpu_torch.runtime import wire
from ray_tpu_torch.runtime.object_plane import ObjectPlane
from ray_tpu_torch.runtime.spawn import child_env as _child_env
from ray_tpu_torch.runtime.protocol import (ClientPool, RpcClient, RpcError,
                                      RpcServer)


class _Lease:
    __slots__ = ("lease_id", "worker_addr", "worker_id", "node_addr",
                 "busy", "idle_since", "fast_key")

    def __init__(self, lease_id: str, worker_addr: str, worker_id: bytes,
                 node_addr: str = "", fast_key: Optional[int] = None):
        self.lease_id = lease_id
        self.worker_addr = worker_addr
        self.worker_id = worker_id
        self.node_addr = node_addr
        self.busy = False
        self.idle_since = time.monotonic()
        # set when granted by the head's native lease pool: release can
        # then be a single fast frame served inside the head's C loop
        self.fast_key = fast_key


class _PendingTask:
    __slots__ = ("payload", "spec", "pins", "attempts", "failed_addrs")

    def __init__(self, payload: dict, spec: TaskSpec, pins: list):
        self.payload = payload
        self.spec = spec
        self.pins = pins          # ObjectIDs pinned until reply
        self.attempts = 0
        # addresses this task already failed on: the retry budget counts
        # DISTINCT workers, so a slow corpse-detection window (attempts
        # 1..N all landing on one dead port in microseconds) cannot
        # exhaust max_retries (reference semantics: owner-side
        # max_retries counts EXECUTIONS, task_manager.h:219 — a push
        # that never reached a live worker is not an execution)
        self.failed_addrs: set = set()


class _BatchState:
    """In-flight batch of tasks pushed to one lease in a single frame."""

    __slots__ = ("lease", "tasks", "remaining", "failed")

    def __init__(self, lease: _Lease, tasks: list):
        self.lease = lease
        self.tasks = tasks
        self.remaining = len(tasks)
        self.failed: list = []  # (task, exc) — handled when batch drains


class _TaskSubmitter:
    """Lease-cached pipelined submission for one resource shape."""

    def __init__(self, backend: "ClusterBackend", shape_key: tuple,
                 resources: Dict[str, float],
                 pg: Optional[Tuple[bytes, int]] = None,
                 runtime_env: Optional[dict] = None):
        self.backend = backend
        self.shape_key = shape_key
        self.resources = resources
        self.pg = pg
        self.runtime_env = runtime_env
        self.pending: collections.deque = collections.deque()
        self.leases: Dict[str, _Lease] = {}
        self.requesting = 0
        self._infeasible_since: Optional[float] = None
        self.lock = threading.Lock()
        self._last_submit = 0.0
        self._sig: Optional[int] = None  # lazy wire.lease_sig(resources)

    # -- public --

    def submit(self, payload: dict, spec: TaskSpec, pins: list) -> None:
        now = time.monotonic()
        with self.lock:
            self.pending.append(_PendingTask(payload, spec, pins))
            # Burst deferral: back-to-back submits (<200us apart) let
            # pending ACCUMULATE for the shared flusher, whose _pump then
            # ships proportional combined batches; isolated submits pump
            # inline for latency. Timing-window only: gating on queue
            # depth as well was measured 25% SLOWER on a loaded 1-core
            # host (every submit deferred -> flusher handoff per pump and
            # batches that serialize against execution).
            bursting = now - self._last_submit < 0.0002 \
                and config_mod.GlobalConfig.task_burst_defer
            self._last_submit = now
        if bursting:
            self.backend._defer_actor_flush(self)
        else:
            self._pump()

    # flusher-thread entry (shared with _ActorSubmitter deferrals)
    def _flush(self) -> None:
        self._pump()

    def cancel(self, task_id: bytes) -> bool:
        with self.lock:
            for t in list(self.pending):
                if t.payload["task_id"] == task_id:
                    self.pending.remove(t)
                    self.backend._store_task_error(
                        t.spec, TaskCancelledError(task_id.hex()), t.pins)
                    return True
        for lease in list(self.leases.values()):
            try:
                self.backend.peers.get(lease.worker_addr).call(
                    "cancel_task", {"task_id": task_id}, timeout=5.0)
            except RpcError:
                pass
        return False

    # -- internals --

    def _pump(self) -> None:
        """Assign pending tasks to idle leases; request more leases if short.

        Lease requests in flight are capped (reference: the submitter
        pipelines at most max_pending_lease_requests_per_scheduling_category
        lease requests, normal_task_submitter.h:74) — without the cap, a
        1000-task batch spawns a requester thread per task and the retry
        storm starves the head's RPC pool of the pushes/replies that
        actually drain the queue (measured: 75x throughput loss).
        """
        spawn = 0
        while True:
            with self.lock:
                if not self.pending:
                    break
                lease = next((l for l in self.leases.values() if not l.busy),
                             None)
                if lease is None:
                    if not self.backend._closed:
                        cap = config_mod.GlobalConfig \
                            .max_pending_lease_requests
                        want = min(len(self.pending), cap)
                        spawn = max(0, want - self.requesting)
                        self.requesting += spawn
                    break
                # Parallelism-neutral batching: pack at most an equal
                # share of the queue onto this lease (pending divided by
                # every lease that exists or is being requested). A lease
                # is a concurrency slot — packing a small burst onto the
                # FIRST grant serialized work that belonged on other
                # workers (verified regression: 4 sleeping tasks on one
                # worker). With the share rule a burst of B <= slots tasks
                # batches as 1 per lease, while a 1000-task burst ships in
                # 32-task frames that amortize the per-frame scheduler
                # round-trip without changing who-runs-what.
                slots = max(1, len(self.leases) + self.requesting)
                share = -(-len(self.pending) // slots)  # ceil div
                n = min(share, config_mod.GlobalConfig.task_push_batch)
                tasks = [self.pending.popleft() for _ in range(n)]
                lease.busy = True
            self._push_batch(lease, tasks)
        for _ in range(spawn):
            threading.Thread(target=self._request_lease, daemon=True,
                             name="lease-req").start()

    def _fast_acquire(self) -> Optional[dict]:
        """Try the head's native lease pool (one binary frame served inside
        the head's C loop — transport.cc FOP_LEASE_ACQ). None on miss or
        ineligibility; the Python RPC path then arms the pool server-side
        so the next request hits."""
        if (self.pg is not None or self.runtime_env is not None
                or not self.backend._head_fast):
            return None
        from ray_tpu_torch.runtime.protocol import _chaos_should_fail
        if _chaos_should_fail("request_lease"):
            return None  # chaos tests target the Python path; don't dodge it
        from ray_tpu_torch.runtime import protocol_native as _pn
        if self._sig is None:
            self._sig = wire.lease_sig(self.resources)
        try:
            status, blob = self.backend.head.call_fast(
                _pn.FAST_LEASE_ACQ, key=_pn._U64.pack(self._sig),
                timeout=5.0)
        except Exception:  # noqa: BLE001 — any failure: use the RPC path
            return None
        if status != 1:
            return None
        import pickle
        try:
            return pickle.loads(blob)
        except Exception:  # noqa: BLE001
            return None

    def _request_lease(self) -> None:
        unserved = False    # a request of this thread recorded demand
        try:
            while not self.backend._closed:
                with self.lock:
                    drained = not self.pending
                if drained:
                    if unserved:
                        # after this thread's last request, on its
                        # connection: the head retires the demand it
                        # recorded, as a grant would have
                        self.backend.head.oneway(
                            "retire_demand", {"resources": self.resources})
                    return
                grant = self._fast_acquire()
                if grant is not None:
                    lease = _Lease(grant["lease_id"], grant["worker_addr"],
                                   grant["worker_id"],
                                   node_addr=grant.get("node_addr", ""),
                                   fast_key=grant.get("fast_key"))
                    if self.backend.is_dead_addr(lease.worker_addr):
                        # pooled corpse: release via the PYTHON path so the
                        # head invalidates it instead of re-pooling
                        self._release_to_cluster(lease, fast_ok=False)
                        time.sleep(0.1)
                        continue
                    with self.lock:
                        self.leases[lease.lease_id] = lease
                    break
                with self.lock:
                    n_pending = len(self.pending)
                payload = {"resources": self.resources,
                           "pending": n_pending}
                if self.runtime_env is not None:
                    payload["runtime_env"] = self.runtime_env
                if self.pg is not None:
                    payload["pg_id"], payload["bundle_index"] = self.pg
                try:
                    grant = self.backend.head.call_retrying(
                        "request_lease", payload)
                except RpcError:
                    time.sleep(0.2)
                    continue
                # (a placement group's bundle records no demand)
                unserved = self.pg is None and bool(
                    grant.get("infeasible") or grant.get("retry"))
                if grant.get("infeasible"):
                    # infeasible NOW is the autoscaler's signal to add a
                    # node (the head recorded the demand): keep waiting
                    # for a grace period before declaring it impossible
                    # (reference: infeasible tasks pend + autoscaler
                    # warning, not immediate failure)
                    if self._infeasible_since is None:
                        self._infeasible_since = time.monotonic()
                        logger.warning(
                            "no node can currently satisfy resources %s; "
                            "waiting %.0fs for the cluster to scale",
                            self.resources,
                            config_mod.GlobalConfig.infeasible_grace_s)
                    elif time.monotonic() - self._infeasible_since > \
                            config_mod.GlobalConfig.infeasible_grace_s:
                        grace = config_mod.GlobalConfig.infeasible_grace_s
                        # reset so a LATER submission of this shape gets a
                        # fresh grace window (the submitter object persists
                        # per shape)
                        self._infeasible_since = None
                        self._fail_pending(TaskError(
                            "PlacementError",
                            f"no node can satisfy resources "
                            f"{self.resources} (waited {grace:.0f}s)",
                            "<scheduler>"))
                        return
                    time.sleep(0.2)
                    continue
                self._infeasible_since = None
                if grant.get("retry"):
                    time.sleep(0.05)
                    continue
                lease = _Lease(grant["lease_id"], grant["worker_addr"],
                               grant["worker_id"],
                               node_addr=grant.get("node_addr", ""))
                if self.backend.is_dead_addr(lease.worker_addr):
                    # the head re-granted a worker we watched die (its
                    # corpse detection hasn't fired yet): hand it back
                    # and wait out the window instead of burning a push
                    self._release_to_cluster(lease)
                    time.sleep(0.1)
                    continue
                with self.lock:
                    self.leases[lease.lease_id] = lease
                break
        finally:
            with self.lock:
                self.requesting = max(0, self.requesting - 1)
            # Always re-pump: a task may have been enqueued in the window
            # where this thread still counted toward `requesting` but was
            # about to exit (e.g. the early return on empty pending).
            self._pump()

    def _fail_pending(self, exc: BaseException) -> None:
        with self.lock:
            tasks = list(self.pending)
            self.pending.clear()
        for t in tasks:
            self.backend._store_task_error(t.spec, exc, t.pins)

    def _push_batch(self, lease: _Lease, tasks: list) -> None:
        now = time.time()
        for t in tasks:
            t.attempts += 1
            # scheduler-phase marker: lease assignment time, carried on the
            # wire so the worker's sched:: span can split queue vs transport
            t.payload["lease_ts"] = now
        state = _BatchState(lease, tasks)
        client = self.backend.peers.get(lease.worker_addr)
        cb = lambda i, v, e: self._on_reply(state, i, v, e)  # noqa: E731
        if len(tasks) > 1 and config_mod.GlobalConfig.task_combined_push:
            # combined fast path: one frame + one pickle each way for the
            # whole batch (worker half: worker_main.handle_push_task_batch)
            client.call_combined_cb(
                "push_task_batch", [t.payload for t in tasks], cb)
        else:
            client.call_batch_cb("push_task",
                                 [t.payload for t in tasks], cb)

    def _on_reply(self, state: _BatchState, i: int, value,
                  exc: Optional[BaseException]) -> None:
        task = state.tasks[i]
        if exc is None:
            self.backend._store_task_reply(task.spec, value, task.pins)
        else:
            state.failed.append((task, exc))
        with self.lock:
            state.remaining -= 1
            done = state.remaining == 0
            if done and not state.failed:
                state.lease.busy = False
                state.lease.idle_since = time.monotonic()
        if not done:
            return
        if state.failed:
            # Transport failure: the leased worker is gone (crash/chaos).
            # Handled on a fresh thread: this callback runs on the transport
            # dispatcher, and the failure path makes blocking RPCs
            # (release_lease / worker_fate) the dispatcher must not wait on.
            threading.Thread(target=self._on_push_failed, args=(state,),
                             daemon=True, name="push-fail").start()
        else:
            self._pump()

    def _on_push_failed(self, state: _BatchState) -> None:
        self._drop_lease(state.lease)
        # the worker behind this ADDRESS is gone: every cached lease on it
        # is a corpse too — retrying onto one would burn the whole retry
        # budget in microseconds (native transport fails dead-addr pushes
        # instantly)
        dead_addr = state.lease.worker_addr
        self.backend.mark_dead_addr(dead_addr)
        with self.lock:
            stale = [l for l in self.leases.values()
                     if l.worker_addr == dead_addr]
        for l in stale:
            self._drop_lease(l)
        retry = []
        for task, exc in state.failed:
            if dead_addr in task.failed_addrs:
                # repeat hit on an address this task ALREADY died on: the
                # push never reached a live worker, so it doesn't consume
                # retry budget (budget counts distinct leases/addresses)
                task.attempts -= 1
            else:
                task.failed_addrs.add(dead_addr)
            if isinstance(exc, RpcError) and \
                    task.attempts <= task.spec.max_retries:
                retry.append(task)
                continue
            fate = self._worker_fate(state.lease)
            if fate == "oom":
                err: BaseException = OutOfMemoryError(
                    f"worker was OOM-killed running {task.spec.name} "
                    f"(attempt {task.attempts}); raise the task's memory "
                    f"request or the node's memory_usage_threshold")
            else:
                err = WorkerCrashedError(
                    f"worker died running {task.spec.name} "
                    f"(attempt {task.attempts}): {exc}")
            self.backend._store_task_error(task.spec, err, task.pins)
        if retry:
            with self.lock:
                # preserve original submission order at the queue front
                self.pending.extendleft(reversed(retry))
        self._pump()

    def _worker_fate(self, lease: _Lease) -> Optional[str]:
        """Ask the worker's node daemon WHY it died (the submitter only
        sees a dropped connection; the node records OOM kills —
        reference: raylet death-cause propagation into task errors)."""
        if not lease.node_addr:
            return None
        try:
            return self.backend.peers.get(lease.node_addr).call(
                "worker_fate",
                {"worker_id": WorkerID(lease.worker_id).hex()},
                timeout=5.0)
        except RpcError:
            return None

    def _release_to_cluster(self, lease: _Lease, timeout: float = 5.0,
                            fast_ok: bool = True) -> None:
        """Release via the head; if the head forgot the lease (it restarted
        and leases are process state), return the worker straight to its
        node daemon so the pool slot isn't leaked.

        fast_ok: a healthy-worker release of a native-pool grant goes back
        as one fast frame (the head's C loop re-pools it instantly, zero
        Python). Corpse releases pass fast_ok=False so the head's Python
        invalidates the grant instead of re-pooling a dead worker.

        The fallback fires ONLY on an explicit "unknown lease" reply. A
        transport failure is ambiguous — the head may have completed the
        release after we gave up, after which the worker can be re-leased
        to someone else, and a late direct return would hand one worker to
        two leases. Leaking a slot on an unreachable head is the safe side.
        """
        if fast_ok and lease.fast_key is not None \
                and self.backend._head_fast:
            from ray_tpu_torch.runtime import protocol_native as _pn
            try:
                status, _ = self.backend.head.call_fast(
                    _pn.FAST_LEASE_REL, key=_pn._U64.pack(lease.fast_key),
                    timeout=timeout)
                if status == 1:
                    return
            except Exception:  # noqa: BLE001 — fall through to the RPC
                pass
        try:
            known = bool(self.backend.head.call(
                "release_lease", {"lease_id": lease.lease_id},
                timeout=timeout))
        except RpcError:
            return
        if not known and lease.node_addr:
            # "unknown lease" has two causes: the head restarted (fall back
            # — nobody else will free the worker), or THIS head already
            # reclaimed it via our own connection blip (_on_client_disconnect)
            # — in which case the worker may be re-leased already and a
            # direct return would hand it to two leases. Lease ids embed the
            # granting head's incarnation; only fall back across a change.
            try:
                pong = self.backend.head.call("ping", timeout=timeout)
            except RpcError:
                return
            inc = pong.get("incarnation") if isinstance(pong, dict) else None
            if inc is None or lease.lease_id.startswith(f"l{inc}."):
                return
            try:
                self.backend.peers.get(lease.node_addr).call(
                    "return_worker", {"worker_id": lease.worker_id},
                    timeout=timeout)
            except RpcError:
                pass

    def _drop_lease(self, lease: _Lease) -> None:
        with self.lock:
            self.leases.pop(lease.lease_id, None)
        self.backend.peers.invalidate(lease.worker_addr)
        # corpse path: never fast-release (the head must invalidate the
        # grant, not hand the dead worker to the next acquirer)
        self._release_to_cluster(lease, fast_ok=False)

    def reap_idle(self, linger_s: float) -> None:
        now = time.monotonic()
        with self.lock:
            idle = [l for l in self.leases.values()
                    if not l.busy and now - l.idle_since > linger_s
                    and not self.pending]
        for lease in idle:
            with self.lock:
                if lease.busy:
                    continue
                self.leases.pop(lease.lease_id, None)
            self._release_to_cluster(lease)

    def shutdown(self) -> None:
        with self.lock:
            leases = list(self.leases.values())
            self.leases.clear()
        for lease in leases:
            self._release_to_cluster(lease, timeout=2.0)


class _ActorSubmitter:
    """Per-actor ordered submission with restart-aware re-resolution."""

    def __init__(self, backend: "ClusterBackend", actor_id: ActorID,
                 creation_pins: Optional[list] = None):
        self.backend = backend
        self.actor_id = actor_id
        self.address: Optional[str] = None
        self.state = "RESOLVING"
        self.dead_reason = ""
        self.pending: collections.deque = collections.deque()
        self.lock = threading.Lock()
        self.resolving = False
        self._flushing = False
        self._last_submit = 0.0
        self.creation_pins = creation_pins or []
        if self.creation_pins:
            self._ensure_resolver()

    def submit(self, payload: dict, spec: TaskSpec, pins: list) -> None:
        t = _PendingTask(payload, spec, pins)
        now = time.monotonic()
        with self.lock:
            if self.state == "DEAD":
                dead = True
                bursting = False
            else:
                dead = False
                self.pending.append(t)
                # burst detection (same idea as the transport's write
                # coalescing): back-to-back submits defer to the shared
                # flusher thread, which drains them as ONE batched frame;
                # isolated submits flush inline for latency
                bursting = now - self._last_submit < 0.0002
                self._last_submit = now
        if dead:
            self.backend._store_task_error(
                spec, ActorDiedError(self.actor_id.hex(), self.dead_reason),
                pins)
            return
        if self.state == "ALIVE":
            if bursting:
                self.backend._defer_actor_flush(self)
            else:
                self._flush()
        else:
            self._ensure_resolver()

    def _ensure_resolver(self) -> None:
        with self.lock:
            if self.resolving:
                return
            self.resolving = True
        threading.Thread(target=self._resolve_loop, daemon=True,
                         name="actor-resolve").start()

    def _resolve_loop(self) -> None:
        try:
            while not self.backend._closed:
                try:
                    info = self.backend.head.call_retrying(
                        "get_actor", {"actor_id": self.actor_id.binary()})
                except RpcError:
                    time.sleep(0.2)
                    continue
                if info is None:
                    self._mark_dead("actor not registered")
                    return
                if info["state"] == "ALIVE":
                    with self.lock:
                        self.address = info["address"]
                        self.state = "ALIVE"
                    self._release_creation_pins()
                    self._flush()
                    return
                if info["state"] == "DEAD":
                    self._mark_dead(info.get("reason", "actor died"))
                    self._release_creation_pins()
                    return
                time.sleep(0.02)
        finally:
            with self.lock:
                self.resolving = False

    def _release_creation_pins(self) -> None:
        with self.lock:
            pins, self.creation_pins = self.creation_pins, []
        for oid in pins:
            self.backend.worker.refcounter.on_serialized_ref_done(oid)

    def _requeue_ordered(self, task: _PendingTask) -> None:
        """Re-insert a failed in-flight task preserving seq_no order —
        several pipelined calls can fail together and their completion
        callbacks run in arbitrary order, so a plain appendleft would
        replay them reversed (per-handle ordering contract, reference:
        ActorSchedulingQueue seq enforcement)."""
        with self.lock:
            items = list(self.pending)
            items.append(task)
            items.sort(key=lambda t: t.spec.seq_no)
            self.pending = collections.deque(items)

    def _mark_dead(self, reason: str) -> None:
        with self.lock:
            self.state = "DEAD"
            self.dead_reason = reason
            tasks = list(self.pending)
            self.pending.clear()
        for t in tasks:
            self.backend._store_task_error(
                t.spec, ActorDiedError(self.actor_id.hex(), reason), t.pins)

    def _flush(self) -> None:
        # Single-flusher discipline: exactly one thread drains the queue at
        # a time, so tasks hit the wire (and the actor's FIFO queue) in
        # seq_no order even when the resolver thread and a submitting user
        # thread race into _flush together.
        while True:
            with self.lock:
                if self._flushing:
                    return
                self._flushing = True
            try:
                batch_max = config_mod.GlobalConfig.task_push_batch
                while True:
                    with self.lock:
                        if self.state != "ALIVE" or not self.pending:
                            break
                        tasks = [self.pending.popleft() for _ in
                                 range(min(len(self.pending), batch_max))]
                        addr = self.address
                    for t in tasks:
                        t.attempts += 1
                    try:
                        client = self.backend.peers.get(addr)
                        # one frame for the whole run of queued calls; the
                        # actor executes them in seq order either way
                        if len(tasks) > 1 and \
                                config_mod.GlobalConfig.task_combined_push:
                            client.call_combined_cb(
                                "push_task_batch",
                                [t.payload for t in tasks],
                                lambda i, v, e, ts=tasks:
                                    self._on_reply(ts[i], v, e))
                        else:
                            client.call_batch_cb(
                                "push_task", [t.payload for t in tasks],
                                lambda i, v, e, ts=tasks:
                                    self._on_reply(ts[i], v, e))
                    except BaseException as e:  # noqa: BLE001
                        # Synchronous submit failure (stale address etc):
                        # popped tasks must NOT vanish — requeue in order
                        # and re-resolve (critical on the deferred-flush
                        # path, where no caller would see the raise). The
                        # attempt COUNTS: a deterministic failure (actor
                        # reported ALIVE at an unreachable address) must
                        # exhaust the retry budget, not loop forever.
                        # KeyboardInterrupt/SystemExit re-raise AFTER the
                        # requeue below, so an interrupted inline flush
                        # still leaves every task accounted for.
                        for t in tasks:
                            if t.attempts <= t.spec.max_retries:
                                self._requeue_ordered(t)
                            else:
                                self.backend._store_task_error(
                                    t.spec,
                                    ActorDiedError(
                                        self.actor_id.hex(),
                                        f"submit to {addr} kept failing: "
                                        f"{e!r}"),
                                    t.pins)
                        with self.lock:
                            self.address = None
                            if self.state == "ALIVE":
                                self.state = "RESOLVING"
                        self._ensure_resolver()
                        if isinstance(e, (KeyboardInterrupt, SystemExit)):
                            raise
                        break
            finally:
                with self.lock:
                    self._flushing = False
            with self.lock:
                if self.state != "ALIVE" or not self.pending:
                    return
                # work arrived while we were clearing the flag — go again

    def _on_reply(self, task: _PendingTask, value,
                  exc: Optional[BaseException]) -> None:
        if exc is None:
            self.backend._store_task_reply(task.spec, value, task.pins)
            return
        # connection to the actor broke: restart-aware handling
        # (reference: ActorTaskSubmitter disconnect path + max_task_retries,
        # transport/actor_task_submitter.h:75)
        with self.lock:
            self.address = None
            if self.state == "ALIVE":
                self.state = "RESOLVING"
        if isinstance(exc, RpcError) and task.attempts <= task.spec.max_retries:
            self._requeue_ordered(task)
            self._ensure_resolver()
        else:
            self.backend._store_task_error(
                task.spec,
                ActorDiedError(self.actor_id.hex(),
                               f"actor task {task.spec.name} interrupted: "
                               f"{exc}"),
                task.pins)
            self._ensure_resolver()


class ClusterBackend:
    """Backend interface implementation over the multiprocess runtime."""

    def __init__(self, worker, head_addr: str, role: str,
                 shm_name: Optional[str] = None,
                 worker_id: Optional[WorkerID] = None,
                 owned_procs: Optional[list] = None):
        self.worker = worker
        self.role = role
        # process-global planes this connect started: stopped at
        # shutdown, so a later init() or server in this process (a test
        # run, a script) installs its own instead of reusing this one's
        self._owned_planes: list = []
        self.head = RpcClient(head_addr, name=f"{role}->head")
        self.head_addr = head_addr
        self.peers = ClientPool(name=f"{role}-peers")
        self._closed = False
        self._owned_procs = owned_procs or []
        self._submitters: Dict[tuple, _TaskSubmitter] = {}
        self._actor_submitters: Dict[ActorID, _ActorSubmitter] = {}
        self._actor_name_cache: Dict[str, dict] = {}
        self._export_epoch = os.urandom(8).hex()  # per-backend cache tag
        # working_dir path -> uploaded package uri (upload-once semantics,
        # reference: runtime_env working_dir URI cache)
        self._rtenv_uploads: Dict[str, str] = {}
        # owner-side lineage: return-object id -> creating TaskSpec, so a
        # lost shm object can be rebuilt by re-executing its task
        # (reference: ObjectRecoveryManager, object_recovery_manager.h:38,
        # lineage pinned in TaskManager bounded by max_lineage_bytes)
        self._lineage: "collections.OrderedDict[bytes, TaskSpec]" = \
            collections.OrderedDict()
        self._lineage_cap = 8192
        self._lock = threading.Lock()
        # worker addresses observed dead (push transport failure), with
        # expiry: lease grants naming one are released and re-requested
        # instead of burning a push on a known corpse — covers the window
        # between a worker's death and the node/head noticing it
        self._dead_addrs: Dict[str, float] = {}
        self._dead_addrs_lock = threading.Lock()

        worker.worker_id = worker_id or WorkerID.from_random()

        # Native-KV probe: kv/ping traffic is served inside the head's
        # event loop (fast frames — protocol_native.call_fast) once the
        # head has enabled its fast path. One ping detects it; a head
        # without it answers with an error and we stay on the pickle path.
        self._head_fast = False
        try:
            from ray_tpu_torch.runtime import protocol_native as _pn
            status, _ = self.head.call_fast(_pn.FAST_PING, timeout=5.0)
            self._head_fast = status == 1
        except Exception:  # noqa: BLE001 — use the pickle path
            self._head_fast = False

        # node registry + local shm store
        nodes = self.head.call_retrying("list_nodes")
        node_addrs = {n["node_id"]: n["address"] for n in nodes}
        node_shm = {n["node_id"]: n["shm_name"] for n in nodes}
        if shm_name is None:
            alive = [n for n in nodes if n["alive"]]
            if not alive:
                raise RuntimeError("cluster has no alive nodes")
            local = alive[0]
            shm_name = local["shm_name"]
            local_node_id = local["node_id"]
        else:
            local_node_id = next(
                (n["node_id"] for n in nodes if n["shm_name"] == shm_name),
                nodes[0]["node_id"] if nodes else "")
        store = ShmStore.attach(shm_name)
        self.object_plane = ObjectPlane(
            worker, local_node_id, store, self.head, node_addrs, node_shm)
        self.local_node_id = local_node_id

        # streaming-generator states by task id (reference: the owner-side
        # streaming generator metadata in TaskManager)
        self._streams: Dict[bytes, Any] = {}

        # owner service: every process is reachable for object resolution
        self.server = RpcServer({
            "get_object": self.object_plane.handle_get_object,
            "add_location": self.object_plane.handle_add_location,
            "add_borrower": self.object_plane.handle_add_borrower,
            "remove_borrower": self.object_plane.handle_remove_borrower,
            "stream_item": self._h_stream_item,
            "log_batch": self._h_log_batch,
            "borrow_batch": self._h_borrow_batch,
            "ping": lambda p, c: "pong",
        }, name=f"{role}-owner")
        self.kv_put(f"addr:{worker.worker_id.hex()}",
                    self.server.address)

        # borrowed-ref owner map for unborrow notifications
        self._borrowed_owner: Dict[ObjectID, WorkerID] = {}
        worker.refcounter.notify_owner_unborrow = self._notify_unborrow
        # Borrow traffic batcher: add/remove-borrower notifications queue
        # here and flush as one RPC per owner, preserving per-owner FIFO
        # order (adds for refs nested in a container always reach the
        # owner before the container's own unborrow, so the owner can
        # never free the container — and with it the nested containment
        # borrows — while our nested adds are still in flight). Turns the
        # deserialize/drop of a 10k-ref container from 10k round trips
        # into a handful (reference: batched WaitForRefRemoved pubsub).
        self._borrow_q: collections.deque = collections.deque()
        self._borrow_wake = threading.Event()
        # serializes flushers: concurrent drains could split one owner's
        # add/remove pair across two in-flight RPCs and reorder them
        self._borrow_flush_lock = threading.Lock()
        self._borrow_thread = threading.Thread(
            target=self._borrow_flush_loop, daemon=True,
            name=f"{role}-borrow")
        self._borrow_thread.start()

        self._reaper = threading.Thread(target=self._reap_loop, daemon=True,
                                        name="lease-reaper")
        self._reaper.start()

        # shared actor-submit flusher: bursting submitters defer here so
        # a tight .remote() loop coalesces into batched frames (the GIL
        # timeslice between the submitting thread and this one sets the
        # natural batch size). Dedicated lock: this is the hottest submit
        # path — it must not contend on the backend-wide _lock.
        self._aflush_subs: set = set()
        self._aflush_lock = threading.Lock()
        self._aflush_wake = threading.Event()
        self._aflush_thread = threading.Thread(
            target=self._actor_flush_loop, daemon=True,
            name=f"{role}-aflush")
        self._aflush_thread.start()

        # telemetry: metric snapshots + task-event spans → head
        # (reference: metrics agent push + TaskEventBuffer→GcsTaskManager)
        from ray_tpu_torch.runtime.events import TaskEventBuffer
        self.event_buffer = TaskEventBuffer()
        self._telemetry_stop = threading.Event()
        self._telemetry = threading.Thread(target=self._telemetry_loop,
                                           daemon=True,
                                           name=f"{role}-telemetry")
        self._telemetry.start()
        # continuous wall-clock stack sampler for this process (worker or
        # driver); windows drain through _flush_telemetry into the head's
        # ProfileStore (off unless profile_enabled is set)
        try:
            from ray_tpu_torch.util import stack_profiler
            self._start_plane(stack_profiler)
        except Exception:  # noqa: BLE001 — profiling never stops connect
            pass
        # structured log plane for DRIVERS (workers install theirs in
        # worker_main with the node/worker identity the daemon passed;
        # installing a generic one here first would shadow it)
        if role == "driver":
            try:
                from ray_tpu_torch.util import log_plane
                wid12 = self.worker.worker_id.hex()[:12]
                self._start_plane(
                    log_plane, role="driver",
                    node=(self.local_node_id or "")[:12], worker=wid12,
                    log_dir=log_plane.session_log_dir(
                        os.environ.get("RTPT_SESSION", "")),
                    filename=f"driver-{wid12}.log")
            except Exception:  # noqa: BLE001 — never stops connect
                pass
            # XLA compile tracker for DRIVERS (workers install theirs
            # in worker_main, same shadowing argument as the log plane;
            # jax listeners only hook if/when this process imports jax)
            try:
                from ray_tpu_torch.util import compile_tracker
                self._start_plane(
                    compile_tracker, role="driver",
                    node=(self.local_node_id or "")[:12],
                    worker=self.worker.worker_id.hex()[:12])
            except Exception:  # noqa: BLE001 — never stops connect
                pass

    def _start_plane(self, mod, **kwargs) -> None:
        """``mod.ensure_started(**kwargs)`` for a process-global plane
        (stack sampler, log plane, compile tracker), owned by this
        backend when no earlier one ran."""
        if mod.get_global() is None and \
                mod.ensure_started(**kwargs) is not None:
            self._owned_planes.append(mod)

    def _defer_actor_flush(self, sub) -> None:
        with self._aflush_lock:
            self._aflush_subs.add(sub)
        self._aflush_wake.set()

    def _actor_flush_loop(self) -> None:
        while not self._closed:
            self._aflush_wake.wait(timeout=0.5)
            self._aflush_wake.clear()
            self._drain_actor_flushes()

    def _drain_actor_flushes(self) -> None:
        with self._aflush_lock:
            subs, self._aflush_subs = self._aflush_subs, set()
        for sub in subs:
            try:
                sub._flush()
            except Exception:  # noqa: BLE001 — _flush requeues its tasks
                pass           # and re-resolves on submit failures

    def _telemetry_loop(self) -> None:
        from ray_tpu_torch.core.config import GlobalConfig
        interval = max(GlobalConfig.metrics_export_period_s, 0.1)
        # woken by shutdown(), which makes the last flush itself: a flush
        # from here after it would drain the process's live recorders
        # (request records, log and profile windows) into a closed head
        while not self._telemetry_stop.wait(interval):
            self._flush_telemetry()

    def _flush_telemetry(self) -> None:
        from ray_tpu_torch.util import metrics as metrics_mod
        try:
            # scheduler-backlog gauge: tasks enqueued but not yet pushed to
            # a leased worker (len() is atomic; no submitter locks needed)
            depth = sum(len(s.pending)
                        for s in list(self._submitters.values()))
            metrics_mod.queue_depth_gauge().set(depth)
            snap = metrics_mod.snapshot()
            events = self.event_buffer.drain()
            # bounded object-table summary for `list objects` (reference:
            # util/state object listing; owners are authoritative, so each
            # process reports its own table). snapshot(limit=...) keeps
            # the under-lock work O(limit), not O(all refs).
            tracked = self.worker.refcounter.num_tracked()
            sample = [{"object_id": oid, **counts}
                      for oid, counts in
                      self.worker.refcounter.snapshot(limit=50).items()]
            objects = {"tracked": tracked, "sample": sample,
                       # reconciled per-object directory of everything this
                       # process sealed into shm/spill ('ray_tpu_torch memory')
                       **self.object_plane.directory_export()}
            # cluster events staged process-side (spill overflows) are
            # sequenced by the head's journal when they land
            journal = self.object_plane.drain_journal()
            # accelerator memory rides the worker flush: only worker
            # processes have a CUDA context (the node daemon must never
            # make one), so device memory gauges originate here, tagged
            # per worker since device indices are process-local
            from ray_tpu_torch.runtime.hw_sampler import gpu_memory_samples
            samples = gpu_memory_samples()
            wid12 = self.worker.worker_id.hex()[:12]
            for s in samples:
                s.setdefault("tags", {})["worker"] = wid12
            # LLM request records (llm/request_log.py flight recorders):
            # drained only when some engine in this process already
            # imported the module — resolved via sys.modules so
            # non-serving workers never pull it in
            reqlog = sys.modules.get("ray_tpu_torch.llm.request_log")
            llm_requests = reqlog.drain_all_exports() \
                if reqlog is not None else []
            # this process's collapsed-stack profiler window (None when
            # profiling is disabled or nothing was sampled)
            from ray_tpu_torch.util import stack_profiler
            profiles = stack_profiler.drain_export()
            # this process's structured-log window + staged error-storm
            # events (None/[] when the plane is off or nothing logged)
            from ray_tpu_torch.util import log_plane
            logs = log_plane.drain_export()
            journal = journal + log_plane.drain_journal_events()
            # this process's XLA compile window + staged compile_storm /
            # invariant-breach events (None/[] when the tracker is off
            # or this process never compiled anything)
            from ray_tpu_torch.util import compile_tracker
            compiles = compile_tracker.drain_export()
            journal = journal + compile_tracker.drain_journal_events()
            if snap or events or tracked or samples or llm_requests \
                    or journal or profiles or logs or compiles:
                self.head.oneway("telemetry_push", {
                    "worker": self.worker.worker_id.hex(),
                    "role": self.role,
                    "node": self.local_node_id,
                    "metrics": snap, "events": events,
                    "objects": objects, "samples": samples,
                    "llm_requests": llm_requests, "journal": journal,
                    "profiles": profiles, "logs": logs,
                    "compiles": compiles})
        except Exception:  # noqa: BLE001 — telemetry must never kill
            pass

    # ------------------------------------------------------------ head KV

    def kv_put(self, key: str, value: Any, overwrite: bool = True) -> bool:
        """Head KV write — native fast frame when both ends are C++
        transport (no Python runs on the head), pickle RPC otherwise."""
        if self._head_fast:
            import pickle
            from ray_tpu_torch.runtime import protocol_native as _pn
            try:
                status, _ = self._fast_retry(
                    _pn.FAST_PUT, key.encode(),
                    pickle.dumps(value, protocol=5),
                    flags=1 if overwrite else 0)
                return status == 1
            except RpcError:
                pass  # head unreachable via fast path: use retrying RPC
        return bool(self.head.call_retrying("kv_put", {
            "key": key, "value": value, "overwrite": overwrite}))

    def kv_get(self, key: str) -> Any:
        if self._head_fast:
            import pickle
            from ray_tpu_torch.runtime import protocol_native as _pn
            try:
                status, raw = self._fast_retry(_pn.FAST_GET, key.encode())
                return pickle.loads(raw) if status == 1 else None
            except RpcError:
                pass
        return self.head.call_retrying("kv_get", {"key": key})

    def kv_del(self, key: str) -> bool:
        if self._head_fast:
            from ray_tpu_torch.runtime import protocol_native as _pn
            try:
                status, _ = self._fast_retry(_pn.FAST_DEL, key.encode())
                return status == 1
            except RpcError:
                pass
        return bool(self.head.call("kv_del", {"key": key}, timeout=5.0))

    def kv_keys(self, prefix: str = "") -> list:
        keys = self.head.call_retrying("kv_keys", {"prefix": prefix})
        return list(keys or [])

    #: how long a dead address stays blacklisted — a fresh worker at the
    #: same host gets a new port, so false positives only cost one
    #: re-request; sized to the worst observed corpse-detection window
    DEAD_ADDR_TTL_S = 5.0

    def mark_dead_addr(self, addr: str) -> None:
        with self._dead_addrs_lock:
            self._dead_addrs[addr] = time.monotonic() + self.DEAD_ADDR_TTL_S
            if len(self._dead_addrs) > 256:
                now = time.monotonic()
                self._dead_addrs = {a: t for a, t in
                                    self._dead_addrs.items() if t > now}

    def is_dead_addr(self, addr: str) -> bool:
        with self._dead_addrs_lock:
            t = self._dead_addrs.get(addr)
            if t is None:
                return False
            if t <= time.monotonic():
                del self._dead_addrs[addr]
                return False
            return True

    def _fast_retry(self, op: int, key: bytes, val: bytes = b"",
                    flags: int = 0) -> tuple:
        from ray_tpu_torch.runtime.protocol import FastPathUnavailable
        cfg = config_mod.GlobalConfig
        attempts = max(1, cfg.rpc_retry_max_attempts)
        delay = cfg.rpc_retry_base_ms / 1000.0
        last: Optional[Exception] = None
        for i in range(attempts):
            try:
                return self.head.call_fast(op, key, val, flags=flags)
            except FastPathUnavailable:
                # the head answered via its Python path (restarted without
                # the fastpath): deterministic — retrying the fast frame
                # would burn the whole backoff budget on EVERY kv call.
                # Demote this backend to the pickle path for good.
                self._head_fast = False
                raise
            except RpcError as e:
                last = e
                if i + 1 < attempts:  # no pointless sleep before the raise
                    time.sleep(delay)
                    delay = min(delay * 2, 5.0)
        raise last  # type: ignore[misc]

    # ------------------------------------------------------------- factories

    @classmethod
    def connect_as_driver(cls, worker, head_addr: str,
                          owned_procs: Optional[list] = None
                          ) -> "ClusterBackend":
        backend = cls(worker, head_addr, role="driver",
                      owned_procs=owned_procs)
        info = backend.head.call_retrying("connect_driver", {})
        worker.job_id = JobID.from_int(info["job_id"])
        from ray_tpu_torch.core.ids import TaskID
        worker.current_task_id = TaskID.for_driver(worker.job_id)
        worker.node_id = backend.local_node_id
        worker.connect_cluster(backend)
        backend._install_cluster_hooks()
        return backend

    @classmethod
    def connect_as_worker(cls, worker, head_addr: str, shm_name: str,
                          worker_id: WorkerID) -> "ClusterBackend":
        backend = cls(worker, head_addr, role="worker", shm_name=shm_name,
                      worker_id=worker_id)
        worker.job_id = JobID.from_int(0)
        from ray_tpu_torch.core.ids import TaskID
        worker.current_task_id = None
        worker.node_id = backend.local_node_id
        worker.mode = "worker"
        worker.backend = backend
        worker._install_hooks()
        backend._install_cluster_hooks()
        return backend

    def _install_cluster_hooks(self) -> None:
        from ray_tpu_torch.core import object_ref as object_ref_mod
        object_ref_mod.install_refcount_hooks(
            add=lambda oid: self.worker.refcounter.add_local(oid),
            remove=self._on_ref_removed,
            borrow=lambda oid: self.worker.refcounter.on_ref_serialized(oid),
            deserialized=self._on_ref_deserialized,
        )
        self.worker.refcounter.free_object = self.worker._free_object

    # ----------------------------------------------------- refcount plumbing

    def _on_ref_deserialized(self, ref: ObjectRef) -> None:
        if ref.owner_id() == self.worker.worker_id or ref.owner_id().is_nil():
            return
        with self._lock:
            first = ref.id() not in self._borrowed_owner
            self._borrowed_owner[ref.id()] = ref.owner_id()
        if first:
            self._enqueue_borrow("add", ref.owner_id(), ref.id())
        self.worker.refcounter.on_ref_deserialized(ref.id())

    def _on_ref_removed(self, oid: ObjectID) -> None:
        self.worker.refcounter.remove_local(oid)

    def _notify_unborrow(self, oid: ObjectID) -> None:
        with self._lock:
            owner = self._borrowed_owner.pop(oid, None)
        self.object_plane.release_local_pin(oid)
        if owner is None:
            return
        self._enqueue_borrow("remove", owner, oid)

    # -------------------------------------------------------- borrow batching

    def _enqueue_borrow(self, kind: str, owner: WorkerID,
                        oid: ObjectID) -> None:
        self._borrow_q.append((kind, owner.binary(), oid.binary()))
        if len(self._borrow_q) >= 200:
            self._borrow_wake.set()

    def _borrow_flush_loop(self) -> None:
        # 200ms idle cadence: borrow traffic is advisory bookkeeping whose
        # only cost-of-delay is deferred frees, and a 5ms timer measurably
        # taxed single-CPU hosts with GIL handoffs (~20% on the hot-path
        # microbenches). Bursts don't wait: _enqueue_borrow sets the event
        # at >=200 queued, so big batches flush immediately.
        while not self._closed:
            self._borrow_wake.wait(timeout=0.2)
            self._borrow_wake.clear()
            self.flush_borrows()

    def flush_borrows(self) -> None:
        """Drain the borrow queue and notify owners, one batched RPC per
        owner. Called by the flush loop, by shutdown, and by worker_main
        BEFORE every task reply: the reply releases the submitter's
        serialize-time pins, so our adds for borrowed args must be at
        their owners first (transfer-before-release, reply side)."""
        # Lock BEFORE the emptiness check: a caller that needs the
        # adds-before-reply guarantee must also wait out a drain the
        # background loop already popped and is mid-RPC on — an empty
        # queue alone doesn't mean the adds have landed.
        with self._borrow_flush_lock:
            if not self._borrow_q:
                return
            batch = []
            while self._borrow_q:
                batch.append(self._borrow_q.popleft())
            # Send every add before any remove. Within one drain a remove
            # to owner O2 (e.g. dropping a container) can transitively
            # release protection for a ref whose add targets a DIFFERENT
            # owner O1, so per-owner FIFO alone is not enough — the
            # protect/release phases must be globally ordered. Across
            # drains FIFO holds already: drains are serialized by this
            # lock, and an add enqueued after a remove may legitimately
            # be sent after it.
            me = self.worker.worker_id.binary()
            for phase in ("add", "remove"):
                by_owner: Dict[bytes, list] = {}
                for kind, owner, oid in batch:
                    if kind == phase:
                        by_owner.setdefault(owner, []).append((kind, oid))
                for owner, ops in by_owner.items():
                    try:
                        self.object_plane.owner_client(WorkerID(owner)).call(
                            "borrow_batch", {"borrower": me, "ops": ops})
                    except Exception:  # noqa: BLE001 — owner gone: refs
                        pass           # resolve to ObjectLost on use

    def _h_borrow_batch(self, p, ctx):
        borrower = p["borrower"]
        for kind, oid in p["ops"]:
            if kind == "add":
                self.worker.refcounter.add_borrower(ObjectID(oid), borrower)
            else:
                self.worker.refcounter.remove_borrower(ObjectID(oid),
                                                       borrower)
        return True

    # --------------------------------------------------------------- objects

    def put_object(self, object_id: ObjectID, value: Any) -> None:
        self.object_plane.put_object(object_id, value)

    def free_object(self, object_id: ObjectID) -> None:
        with self._lock:
            # freed objects must not be reconstructable (and dead
            # TaskSpecs with inline args are driver-memory ballast)
            dropped = self._lineage.pop(object_id.binary(), None)
        # the popped spec dies OUTSIDE the lock: a spec holding the last
        # handle to inline-arg ObjectRefs fires their __del__ -> nested
        # free_object, which must re-acquire self._lock (self-deadlock on
        # this non-reentrant lock if the drop happened inside)
        del dropped
        self.object_plane.free_object(object_id)

    def try_resolve(self, ref: ObjectRef) -> bool:
        return self.object_plane.try_resolve(ref)

    def poke_resolve(self, ref: ObjectRef) -> None:
        self.object_plane.poke_resolve(ref)

    def get_from_store(self, ref: ObjectRef) -> Tuple[Any, bool]:
        return self.object_plane.get_from_store(ref)

    # ----------------------------------------------------------------- tasks

    def _export_function(self, fn) -> str:
        # Cache the export key ON the function object, never keyed by
        # id(fn): ids are reused after GC, and a stale id->key entry makes
        # a NEW function silently execute a DEAD function's code on
        # workers (wrong-function corruption, was a real bug). The cache
        # carries this backend's epoch so a key cached against a previous
        # cluster (whose KV died with it) re-exports here.
        cached = getattr(fn, "__rtpu_export_key__", None)
        if cached is not None and cached[0] == self._export_epoch:
            return cached[1]
        key, blob = wire.export_function(fn)
        self.kv_put(key, blob, overwrite=False)
        try:
            fn.__rtpu_export_key__ = (self._export_epoch, key)
        except (AttributeError, TypeError):
            pass  # unsettable callables just re-export every call
        return key

    def resolve_runtime_env(self, descriptor: Optional[dict]
                            ) -> Optional[dict]:
        """Upload-once packaging: working_dir paths become content-hash
        URIs in the head KV; env_vars pass through (reference:
        runtime_env working_dir.py upload_package_if_needed)."""
        if not descriptor:
            return None
        from ray_tpu_torch.runtime import runtime_env as rtenv
        out = dict(descriptor)
        wd = out.pop("working_dir", None)
        if wd is not None:
            wd = os.path.abspath(wd)
            with self._lock:
                uri = self._rtenv_uploads.get(wd)
            if uri is None:
                uri, blob = rtenv.package_working_dir(wd)
                self.kv_put(rtenv.kv_key(uri), blob, overwrite=False)
                with self._lock:
                    self._rtenv_uploads[wd] = uri
            out["working_dir_uri"] = uri
        return out or None

    def submit_task(self, spec: TaskSpec) -> None:
        key = self._export_function(spec.function)
        payload, contained = wire.task_to_wire(spec, function_key=key)
        pins = self._pin_args(spec, contained)
        pg = None
        if spec.placement_group_id is not None:
            pg = (spec.placement_group_id, spec.placement_bundle_index)
        renv = self.resolve_runtime_env(spec.runtime_env)
        from ray_tpu_torch.runtime.runtime_env import descriptor_key
        shape_key = (tuple(sorted(spec.resources.items())), pg,
                     descriptor_key(renv))
        with self._lock:
            sub = self._submitters.get(shape_key)
            if sub is None:
                sub = _TaskSubmitter(self, shape_key, dict(spec.resources),
                                     pg=pg, runtime_env=renv)
                self._submitters[shape_key] = sub
            # lineage: stateless tasks only (actor calls mutate state and
            # cannot be replayed — reference restriction)
            if spec.actor_id is None:
                for oid in spec.return_ids():
                    self._lineage[oid.binary()] = spec
                    self._lineage.move_to_end(oid.binary())
                while len(self._lineage) > self._lineage_cap:
                    self._lineage.popitem(last=False)
        sub.submit(payload, spec, pins)

    def try_reconstruct(self, ref: ObjectRef) -> bool:
        """Rebuild a lost object by re-executing its creating task
        (reference: ObjectRecoveryManager lineage reconstruction). The
        respawned task reuses the SAME spec, so results land under the
        original return object ids."""
        with self._lock:
            spec = self._lineage.get(ref.id().binary())
        if spec is None or spec.actor_id is not None:
            return False
        # forget ONLY the lost object's ready marker (deleting healthy
        # sibling returns would race their concurrent getters into a
        # spurious ObjectLost); resubmission re-stores every return
        self.worker.memory_store.delete(ref.id())
        # re-pin top-level ref args: the reconstruction reply will run the
        # standard unpin (on_serialized_ref_done) per ref arg, and without
        # a matching pin here the arg's submitted-count underflows and a
        # LIVE object gets freed
        for a in spec.args:
            if a.is_ref:
                self.worker.refcounter.on_ref_serialized(a.object_id)
        self.submit_task(spec)
        return True

    def _pin_args(self, spec: TaskSpec, contained: list) -> list:
        """Collect refs pinned until the task's reply arrives.

        Top-level ref args were pinned by worker.make_task_args
        (on_ref_serialized); nested refs inside inline values were pinned by
        the serialize-time borrow hook (ObjectRef.__reduce__). Each gets
        exactly one on_serialized_ref_done at reply time.
        """
        pins = [a.object_id for a in spec.args if a.is_ref]
        pins.extend(r.id() for r in contained)
        return pins

    # ------------------------------------------------------------- streaming

    def register_stream(self, spec: TaskSpec):
        """Create owner-side state + generator for a streaming task."""
        from ray_tpu_torch.core.generator import ObjectRefGenerator, StreamState
        state = StreamState()
        with self._lock:
            self._streams[spec.task_id.binary()] = state
        return ObjectRefGenerator(spec.task_id, self.worker.worker_id,
                                  self.worker, state)

    def _h_log_batch(self, p, ctx):
        """Worker stdout/stderr shipped by the executing worker's log
        shipper (reference: log_monitor -> driver prints with the
        (pid=...) prefix, _private/worker.py:1970). Only processes that
        submitted work receive logs — output follows the caller."""
        if not config_mod.GlobalConfig.log_to_driver:
            return True
        prefix = f"({p.get('worker', '?')} pid={p.get('pid', '?')})"
        for stream, line in p.get("lines", ()):
            out = sys.stderr if stream == "stderr" else sys.stdout
            try:
                out.write(f"{prefix} {line}\n")
                out.flush()
            except Exception:  # noqa: BLE001
                break
        return True

    def _h_stream_item(self, p, ctx):
        """A worker shipped one yielded value of a streaming task we own."""
        oid = ObjectID(p["object_id"])
        self.worker.refcounter.mark_owned(oid)
        if "in_shm" in p:
            self.object_plane.record_remote_location(oid, p["in_shm"])
        else:
            value = serialization.deserialize(p["inline"])
            self.worker.memory_store.put(oid, value, is_error=False)
        # state lookup AFTER the store: checking before would let a
        # concurrent generator cleanup (which drains the arrival set and
        # unregisters) slip between the check and the store, stranding the
        # freshly-stored item outside both cleanup paths
        with self._lock:
            state = self._streams.get(p["task_id"])
        recorded = state is not None and \
            state.record_arrival(p.get("index", 0))
        if not recorded:
            # straggler after the generator was dropped and cleaned up:
            # nothing will ever consume or free this item — free it now
            self.worker.refcounter.untrack(oid)
            self.worker._free_object(oid)
        return True

    def unregister_stream(self, task_id) -> None:
        with self._lock:
            self._streams.pop(task_id.binary(), None)

    def _finish_stream(self, spec: TaskSpec, total, error) -> None:
        # the entry stays in _streams until the generator is GC'd
        # (unregister_stream): stragglers arriving after the reply must
        # still find the state, and the generator's cleanup needs the
        # arrival set to free unconsumed items
        with self._lock:
            state = self._streams.get(spec.task_id.binary())
        if state is not None:
            state.finish(total, error)

    def _store_task_reply(self, spec: TaskSpec, reply: dict,
                          pins: list) -> None:
        if reply.get("cancelled"):
            self._store_task_error(
                spec, TaskCancelledError(spec.task_id.hex()), pins)
            return
        if spec.streaming:
            error = None
            if "streaming_error" in reply:
                error = serialization.deserialize(reply["streaming_error"])
            self._finish_stream(spec, reply.get("streaming_count"), error)
            self._unpin(pins)
            return
        rids = spec.return_ids()
        for rid, res in zip(rids, reply["results"]):
            if "in_shm" in res:
                self.object_plane.record_remote_location(rid, res["in_shm"])
            else:
                value = serialization.deserialize(res["inline"])
                self.worker.memory_store.put(rid, value,
                                             is_error=res["is_error"])
        self._unpin(pins)

    def _store_task_error(self, spec: TaskSpec, exc: BaseException,
                          pins: list) -> None:
        if spec.streaming:
            # no total recorded: consumer raises once received items drain
            self._finish_stream(spec, None, exc)
        for rid in spec.return_ids():
            self.worker.memory_store.put(rid, exc, is_error=True)
        self._unpin(pins)

    def _unpin(self, pins: list) -> None:
        for oid in pins:
            self.worker.refcounter.on_serialized_ref_done(oid)

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> None:
        tid = ref.id().task_id().binary()
        with self._lock:
            subs = list(self._submitters.values())
        for sub in subs:
            if sub.cancel(tid):
                return

    # ---------------------------------------------------------------- actors

    def create_actor(self, spec: ActorCreationSpec) -> None:
        payload, contained = wire.actor_to_wire(spec)
        pins = [a.object_id for a in spec.args if a.is_ref]
        pins.extend(r.id() for r in contained)
        import pickle
        name_key = (f"{spec.namespace}:{spec.registered_name}"
                    if spec.registered_name else "")
        self.head.call_retrying("create_actor", {
            "actor_id": spec.actor_id.binary(),
            "spec_bytes": pickle.dumps(payload, protocol=5),
            "max_restarts": spec.max_restarts,
            "max_task_retries": spec.max_task_retries,
            "name_key": name_key,
            "resources": spec.resources,
            "owner_addr": self.server.address,
            "class_name": spec.name,
            "pg_id": spec.placement_group_id,
            "bundle_index": spec.placement_bundle_index,
            "runtime_env": self.resolve_runtime_env(spec.runtime_env),
        })
        with self._lock:
            self._actor_submitters[spec.actor_id] = _ActorSubmitter(
                self, spec.actor_id, creation_pins=pins)

    def submit_actor_task(self, spec: TaskSpec) -> None:
        payload, contained = wire.task_to_wire(spec)
        pins = self._pin_args(spec, contained)
        with self._lock:
            sub = self._actor_submitters.get(spec.actor_id)
            if sub is None:
                sub = _ActorSubmitter(self, spec.actor_id)
                self._actor_submitters[spec.actor_id] = sub
        sub.submit(payload, spec, pins)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self.head.call_retrying("kill_actor", {
            "actor_id": actor_id.binary(), "no_restart": no_restart})

    def get_actor_by_name(self, name: str, namespace: str):
        info = self.head.call_retrying("get_actor_by_name", {
            "name": name, "namespace": namespace})
        if info is None:
            return None
        spec = ActorCreationSpec(
            actor_id=ActorID(info["actor_id"]), name=info["class_name"],
            registered_name=name, namespace=namespace,
            max_task_retries=info["max_task_retries"])
        return spec

    # ------------------------------------------------------ placement groups

    def create_placement_group(self, pg_id: bytes, bundles: list,
                               strategy: str, name: str = "") -> None:
        self.head.call_retrying("create_placement_group", {
            "pg_id": pg_id, "bundles": bundles, "strategy": strategy,
            "name": name})

    def remove_placement_group(self, pg_id: bytes) -> bool:
        return self.head.call_retrying("remove_placement_group",
                                       {"pg_id": pg_id})

    def get_placement_group(self, pg_id: bytes):
        return self.head.call_retrying("get_placement_group",
                                       {"pg_id": pg_id})

    # ------------------------------------------------------------------ misc

    def cluster_resources(self) -> Dict[str, float]:
        return self.head.call_retrying("cluster_resources")

    def available_resources(self) -> Dict[str, float]:
        return self.head.call_retrying("available_resources")

    def nodes(self) -> list:
        out = []
        for n in self.head.call_retrying("list_nodes"):
            out.append({"NodeID": n["node_id"], "Alive": n["alive"],
                        "Resources": n["resources"],
                        "Address": n["address"]})
        return out

    def state_dump(self, task_limit: int = 200) -> dict:
        return self.head.call_retrying("state_dump",
                                       {"task_limit": task_limit})

    def _reap_loop(self) -> None:
        cfg = config_mod.GlobalConfig
        while not self._closed:
            time.sleep(0.2)
            with self._lock:
                subs = list(self._submitters.values())
            for sub in subs:
                try:
                    sub.reap_idle(cfg.lease_idle_linger_s)
                except Exception:
                    pass

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._telemetry_stop.set()
        if threading.current_thread() is not self._telemetry:
            self._telemetry.join(timeout=10.0)
        self._flush_telemetry()  # last-interval metrics/spans must land
        # stop the flush loop before the final drain: a concurrent drain
        # could split one owner's add/remove pair across two in-flight
        # RPCs; after the join, any late enqueue from teardown is caught
        # by this (locked) final flush
        self._borrow_wake.set()
        self._borrow_thread.join(timeout=2.0)
        self.flush_borrows()     # queued unborrows must reach owners
        # burst-deferred actor submits must hit the wire before teardown
        # closes the peers (the flush loop exits on _closed)
        self._aflush_wake.set()
        self._aflush_thread.join(timeout=2.0)
        self._drain_actor_flushes()
        with self._lock:
            subs = list(self._submitters.values())
        for sub in subs:
            sub.shutdown()
        try:
            self.kv_del(f"addr:{self.worker.worker_id.hex()}")
        except RpcError:
            pass
        self.server.stop()
        self.object_plane.shutdown()
        self.peers.close_all()
        self.head.close()
        # tear down processes we started (driver that booted the cluster)
        for proc in reversed(self._owned_procs):
            try:
                proc.terminate()
                proc.wait(timeout=5.0)
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass
        # after the last telemetry flush above drained them
        for mod in self._owned_planes:
            mod.stop_global()


# ---------------------------------------------------------------------------
# bootstrap

def _free_port() -> int:
    """A port no process holds, picked below the kernel's ephemeral range.
    The port is bound by another process seconds later (a head, a rank
    0), or again after a head's restart; a port from ``bind(0)`` is one
    the kernel hands out meanwhile to outgoing connections and other
    ``bind(0)`` callers, and on a busy host one of them takes it first."""
    import random
    low = 32768
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    for _ in range(100):
        port = random.randrange(max(1024, low // 3), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ready(address: str, proc: subprocess.Popen, what: str,
                timeout: float = 30.0) -> None:
    client = RpcClient(address, name="bootstrap")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"{what} exited rc={proc.returncode} during startup")
        try:
            client.call("ping", timeout=1.0)
            client.close()
            return
        except RpcError:
            time.sleep(0.05)
    client.close()
    raise RuntimeError(f"{what} not ready after {timeout}s")


def start_head(session: str, port: Optional[int] = None,
               persist_path: Optional[str] = None
               ) -> Tuple[subprocess.Popen, str]:
    """persist_path enables KV durability: a restarted head pointed at
    the same file serves the previous KV table (reference role: GCS
    Redis persistence, scoped to the KV/jobs tables)."""
    port = port or _free_port()
    cmd = [sys.executable, "-m", "ray_tpu_torch.runtime.head", str(port), session,
           config_mod.GlobalConfig.to_json()]
    if persist_path:
        cmd.append(persist_path)
    proc = subprocess.Popen(cmd, env=_child_env())
    address = f"127.0.0.1:{port}"
    _wait_ready(address, proc, "head")
    return proc, address


def start_node(head_addr: str, session: str,
               resources: Optional[Dict[str, float]] = None,
               object_store_bytes: Optional[int] = None,
               node_id: Optional[str] = None) -> subprocess.Popen:
    args = {"resources": resources,
            "object_store_bytes": object_store_bytes,
            "node_id": node_id,
            "config": json.loads(config_mod.GlobalConfig.to_json())}
    cmd = [sys.executable, "-m", "ray_tpu_torch.runtime.node", head_addr, session,
           json.dumps(args)]
    return subprocess.Popen(cmd, env=_child_env())


def connect_or_start(worker, address: Optional[str] = None,
                     num_cpus: Optional[int] = None,
                     num_gpus: Optional[int] = None,
                     resources: Optional[Dict[str, float]] = None,
                     object_store_memory: Optional[int] = None,
                     namespace: str = "default") -> Dict[str, Any]:
    owned: list = []
    if address is None:
        session = os.urandom(4).hex()
        # the driver's own log plane (and any process it spawns) files
        # under the same session log directory as the daemons
        os.environ["RTPT_SESSION"] = session
        head_proc, address = start_head(session)
        owned.append(head_proc)
        merged = dict(resources or {})
        merged.setdefault("CPU", float(num_cpus if num_cpus is not None
                                       else (os.cpu_count() or 1)))
        # without num_gpus the node counts the machine's cards itself
        if num_gpus is not None:
            merged["GPU"] = float(num_gpus)
        node_proc = start_node(address, session, resources=merged,
                               object_store_bytes=object_store_memory)
        owned.append(node_proc)
        # wait until the node registers
        probe = RpcClient(address, name="probe")
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if node_proc.poll() is not None:
                raise RuntimeError(
                    f"node daemon exited rc={node_proc.returncode}")
            try:
                if any(n["alive"] for n in probe.call("list_nodes")):
                    break
            except RpcError:
                pass
            time.sleep(0.05)
        else:
            raise RuntimeError("node daemon never registered")
        probe.close()

    backend = ClusterBackend.connect_as_driver(worker, address,
                                               owned_procs=owned)
    return {"address": address, "node_id": backend.local_node_id}
