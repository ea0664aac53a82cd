"""Per-node daemon — worker pool, leases, shm store host (raylet role).

Role-equivalent to the reference's raylet (reference:
src/ray/raylet/node_manager.h:118 — lease protocol at :554; worker pool at
src/ray/raylet/worker_pool.h:224): owns the node's shared-memory object
store, spawns/monitors worker processes, grants leased workers to the head,
and serves cross-node object reads (role of the object manager's push/pull,
src/ray/object_manager/object_manager.h — collapsed into a read RPC since
every peer reaches us over TCP directly).

Worker death is detected by a waiter thread per child process (reference:
raylet worker death via process waits) and reported to the head so actor
restart logic runs (gcs_actor_manager.cc:413).
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import config as config_mod
from ray_tpu_torch.core._native import ShmStore
from ray_tpu_torch.core.ids import NodeID, WorkerID
from ray_tpu_torch.runtime.protocol import ClientPool, RpcError, RpcServer
from ray_tpu_torch.util import metrics as metrics_mod


def _proc_dead(proc) -> bool:
    """True when the child is dead, including dead-but-unreaped: Popen
    poll() returns None while another thread (our per-worker waitpid
    thread) holds the internal wait lock, so zombies need the /proc
    state check."""
    if proc.poll() is not None:
        return True
    try:
        with open(f"/proc/{proc.pid}/stat") as f:
            # field 3 is the state letter; comm (field 2) may contain
            # spaces but is parenthesized — split after the last ')'
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state in ("Z", "X", "x")
    except (OSError, IndexError):
        return True  # no /proc entry: reaped and gone


class _WorkerEntry:
    __slots__ = ("worker_id", "proc", "address", "ready", "state", "actor_id",
                 "devices", "env_key", "idle_since", "cgroup_leaf",
                 "out_path", "err_path", "log_path")

    def __init__(self, worker_id: bytes, proc: subprocess.Popen,
                 env_key: str = ""):
        self.worker_id = worker_id
        self.proc = proc
        self.cgroup_leaf: Optional[str] = None
        # durable per-worker stream/log files in the session log dir
        # (None when the log plane is disabled: streams are inherited)
        self.out_path: Optional[str] = None
        self.err_path: Optional[str] = None
        self.log_path: Optional[str] = None
        self.address: Optional[str] = None
        self.ready = threading.Event()
        self.state = "starting"  # starting | idle | leased | actor | dead
        self.actor_id: Optional[bytes] = None
        self.devices: Optional[list] = None  # GPU ids owned (single-use)
        # runtime-env signature this worker was spawned under; workers only
        # serve leases of their own environment (reference: WorkerPool keys
        # workers by runtime_env hash, worker_pool.h:224)
        self.env_key = env_key
        self.idle_since: Optional[float] = None


class NodeDaemon:
    def __init__(self, head_addr: str, session: str,
                 resources: Dict[str, float],
                 object_store_bytes: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 node_id: Optional[str] = None):
        cfg = config_mod.GlobalConfig
        self.head_addr = head_addr
        self.session = session
        # launcher-assigned id lets the autoscaler match a registration to
        # the exact launch it came from (adoption by identity, not order)
        self.node_id = node_id or NodeID.from_random().hex()
        self.resources = dict(resources)
        # GPU nodes advertise their card count (detected from the env and
        # the driver's procfs entries only — a CUDA context here would
        # take device memory on cards the daemon never uses; see
        # accelerators/gpu.py)
        from ray_tpu_torch.accelerators.gpu import (DeviceAllocator,
                                                    GPUAcceleratorManager)
        if "GPU" not in self.resources:
            self.resources.update(GPUAcceleratorManager.node_resources())
        n_gpus = int(self.resources.get("GPU", 0))
        self.devices = DeviceAllocator(n_gpus) if n_gpus > 0 else None
        # /rtpt_ (not the JAX package's /rtpu_): the two packages' stores
        # never share a name, even in one session
        self.shm_name = f"/rtpt_{session[:8]}_{self.node_id[:8]}"
        self.store = ShmStore.create(
            self.shm_name,
            object_store_bytes or cfg.object_store_memory_bytes,
            cfg.object_store_max_objects)
        self._lock = threading.RLock()
        # serve-side object-plane accounting: bytes shipped to remote
        # pullers + spill restores served from disk; the hardware sampler
        # loop pushes these to the head alongside its gauge samples
        self._m_pull_out_bytes = \
            metrics_mod.object_store_pull_out_bytes_counter()
        self._m_spill_restore_total = \
            metrics_mod.object_store_spill_restore_total_counter()
        self._m_spill_restore_bytes = \
            metrics_mod.object_store_spill_restore_bytes_counter()
        self._workers: Dict[bytes, _WorkerEntry] = {}
        # env_key -> FIFO of idle worker ids ('' = default environment)
        self._idle: Dict[str, List[bytes]] = {}
        self._spawn_reserved = 0  # in-flight spawns counted against the cap
        self._clients = ClientPool(name="node")
        self._stopped = threading.Event()
        self.server = RpcServer({
            "lease_worker": self._h_lease_worker,
            "return_worker": self._h_return_worker,
            "start_actor": self._h_start_actor,
            "kill_worker": self._h_kill_worker,
            "worker_ready": self._h_worker_ready,
            "read_object": self._h_read_object,
            "object_info": self._h_object_info,
            "read_chunk": self._h_read_chunk,
            "delete_object": self._h_delete_object,
            "store_stats": lambda p, c: self.store.stats(),
            "node_stats": self._h_node_stats,
            "profile_worker": self._h_profile_worker,
            "profile_burst": self._h_profile_burst,
            "list_workers": self._h_list_workers,
            "worker_fate": self._h_worker_fate,
            "ping": lambda p, c: "pong",
            "shutdown": self._h_shutdown,
        }, host=host, port=port, max_workers=32, name="node")
        self.address = self.server.address
        # worker deaths the head hasn't acknowledged yet (it may be down
        # mid-restart); flushed by the head-watch loop after reconnect
        self._dead_unreported: List[dict] = []
        self._head_incarnation: Optional[str] = None
        self._register_with_head(retrying=True)
        # watch the head for restarts: a new incarnation means fresh head
        # tables — re-register and hand over our still-running actor
        # workers for reconciliation (reference: raylet reconnect to a
        # restarted GCS, gcs_server/gcs_init_data.h rebuild path)
        threading.Thread(target=self._head_watch_loop, daemon=True,
                         name="node-head-watch").start()
        # reap idle workers past worker_idle_timeout_s (reference:
        # WorkerPool idle eviction, worker_pool.h:224)
        threading.Thread(target=self._idle_reap_loop, daemon=True,
                         name="node-idle-reap").start()
        # why a worker was killed (e.g. "oom"), kept for submitters that
        # see only a dropped connection and need the real cause
        self._fates: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        # cgroup-v2 worker isolation (best-effort; no-op without a
        # writable unified hierarchy — see runtime/cgroup.py)
        self.cgroups = None
        if cfg.worker_cgroup:
            from ray_tpu_torch.runtime.cgroup import CgroupManager
            self.cgroups = CgroupManager(session, root=cfg.cgroup_root)
            if not self.cgroups.enabled:
                self.cgroups = None
        if cfg.memory_monitor_refresh_ms > 0:
            # memory monitor + OOM worker killing (reference:
            # common/memory_monitor.h:52 polling + retriable-FIFO victim
            # policy, raylet/worker_killing_policy_retriable_fifo.h)
            threading.Thread(target=self._memory_monitor_loop, daemon=True,
                             name="node-mem-monitor").start()
        if cfg.hw_sampler_period_s > 0:
            # hardware telemetry: cpu%/RSS/cgroup/arena samples -> head
            # ring buffers (reference: reporter_agent.py poll loop)
            threading.Thread(target=self._hw_sampler_loop, daemon=True,
                             name="node-hw-sampler").start()
        # continuous wall-clock stack sampler; exports ride the hardware
        # sampler's telemetry_push into the head's ProfileStore
        try:
            from ray_tpu_torch.util import stack_profiler
            stack_profiler.ensure_started()
        except Exception:  # noqa: BLE001 — profiling never stops boot
            pass
        # structured log plane: the daemon's own diagnostics (OOM kills,
        # spawn failures) go to node-<id>.log + the head's LogStore, and
        # _log_dir is where spawned workers' .out/.err streams land —
        # the durable half of crash forensics
        self._log_dir: Optional[str] = None
        try:
            from ray_tpu_torch.util import log_plane
            if log_plane.ensure_started(
                    role="node", node=self.node_id[:12],
                    log_dir=log_plane.session_log_dir(session),
                    filename=f"node-{self.node_id[:12]}.log") is not None:
                self._log_dir = log_plane.session_log_dir(session)
                os.makedirs(self._log_dir, exist_ok=True)
                log_plane.get_logger().info(
                    f"node daemon started (session {session})")
        except Exception:  # noqa: BLE001 — logging never stops boot
            pass
        for _ in range(cfg.worker_pool_prestart):
            self._spawn_worker()

    # ------------------------------------------------------ head liveness

    def _register_with_head(self, retrying: bool = False) -> None:
        with self._lock:
            actor_workers = [
                {"worker_id": w.worker_id, "actor_id": w.actor_id,
                 "address": w.address}
                for w in self._workers.values()
                if w.state == "actor" and w.actor_id is not None
                and w.address is not None]
        payload = {
            "node_id": self.node_id, "address": self.address,
            "shm_name": self.shm_name, "resources": self.resources,
            "actor_workers": actor_workers,
        }
        client = self._clients.get(self.head_addr)
        reply = (client.call_retrying if retrying else client.call)(
            "register_node", payload)
        self._head_incarnation = (reply or {}).get("incarnation")
        # workers whose actors the (restarted) head disowned: reap them so
        # the pool doesn't leak orphans serving nobody
        for wid in (reply or {}).get("kill", ()):
            self._h_kill_worker({"worker_id": wid}, None)

    def _head_watch_loop(self) -> None:
        period = config_mod.GlobalConfig.node_head_watch_period_s
        client = self._clients.get(self.head_addr)
        while not self._stopped.wait(period):
            try:
                pong = client.call("ping", timeout=max(2.0, period * 4))
            except RpcError:
                continue  # head down/restarting: keep polling
            inc = pong.get("incarnation") if isinstance(pong, dict) else None
            try:
                if inc is not None and inc != self._head_incarnation:
                    self._register_with_head()
                self._flush_dead_reports()
            except RpcError:
                continue

    def _flush_dead_reports(self) -> None:
        with self._lock:
            pending, self._dead_unreported = self._dead_unreported, []
        for rep in pending:
            try:
                self._clients.get(self.head_addr).call("worker_died", rep)
            except RpcError:
                with self._lock:
                    self._dead_unreported.append(rep)

    # ------------------------------------------------------------ worker pool

    def _retire_locked(self, entry: "_WorkerEntry"):
        """Remove an idle worker from the pool books (caller holds the
        lock) and return its proc for termination outside the lock. The
        waiter thread's cleanup is idempotent against this removal."""
        entry.state = "stopping"
        self._workers.pop(entry.worker_id, None)
        pool = self._idle.get(entry.env_key, [])
        if entry.worker_id in pool:
            pool.remove(entry.worker_id)
        return entry.proc

    def _evict_one_idle_locked(self, exclude_env: str):
        """Free a pool slot by retiring the oldest idle worker of some
        OTHER environment (caller holds the lock). Without this, a pool
        full of idle default-env workers starves every runtime_env lease
        forever (the cap counts them but nothing reclaims them)."""
        for env_key, pool in self._idle.items():
            if env_key == exclude_env:
                continue
            while pool:
                entry = self._workers.get(pool[0])
                if entry is None or entry.state != "idle":
                    pool.pop(0)
                    continue
                return self._retire_locked(entry)
        return None

    def _idle_reap_loop(self) -> None:
        timeout_s = config_mod.GlobalConfig.worker_idle_timeout_s
        period = min(30.0, max(1.0, timeout_s / 4))
        while not self._stopped.wait(period):
            now = time.monotonic()
            procs = []
            with self._lock:
                for pool in self._idle.values():
                    for wid in list(pool):
                        entry = self._workers.get(wid)
                        if entry is None:
                            pool.remove(wid)
                            continue
                        if entry.state == "idle" and \
                                entry.idle_since is not None and \
                                now - entry.idle_since > timeout_s:
                            procs.append(self._retire_locked(entry))
            for proc in procs:
                try:
                    proc.terminate()
                except OSError:
                    pass

    def _spawn_worker(self, env_extra: Optional[Dict[str, str]] = None,
                      devices: Optional[list] = None,
                      env_key: str = "",
                      cwd: Optional[str] = None,
                      num_cpus: float = 0.0) -> _WorkerEntry:
        worker_id = WorkerID.from_random().binary()
        from ray_tpu_torch.runtime.spawn import child_env
        extra = {"RTPT_SESSION": self.session,
                 "RTPT_NODE_ID": getattr(self, "node_id", "")}
        if env_extra:
            extra.update(env_extra)
        env = child_env(extra)
        cmd = [sys.executable, "-m", "ray_tpu_torch.runtime.worker_main",
               self.address, self.head_addr, self.shm_name,
               worker_id.hex(), config_mod.GlobalConfig.to_json()]
        # durable raw streams: with the log plane on, the worker's
        # stdout/stderr land in worker-<id>.{out,err} so a SIGKILL'd
        # worker's dying words survive for the death-report tail
        # (reference: raylet redirects worker output into the session
        # log dir); without it, streams inherit as before
        out_path = err_path = log_path = None
        out_f = err_f = None
        log_dir = getattr(self, "_log_dir", None)
        if log_dir:
            wid12 = WorkerID(worker_id).hex()[:12]
            out_path = os.path.join(log_dir, f"worker-{wid12}.out")
            err_path = os.path.join(log_dir, f"worker-{wid12}.err")
            log_path = os.path.join(log_dir, f"worker-{wid12}.log")
            try:
                out_f = open(out_path, "ab")
                err_f = open(err_path, "ab")
            except OSError:
                out_f = err_f = None
                out_path = err_path = log_path = None
        try:
            proc = subprocess.Popen(
                cmd, env=env, cwd=cwd,
                stdout=out_f if out_f is not None else None,
                stderr=err_f if err_f is not None else None)
        finally:
            # child holds its own dups; parent copies must not leak
            for f in (out_f, err_f):
                if f is not None:
                    f.close()
        entry = _WorkerEntry(worker_id, proc, env_key=env_key)
        entry.out_path, entry.err_path = out_path, err_path
        entry.log_path = log_path
        if self.cgroups is not None:
            # post-fork attach (reference: cgroup_setup.h AddProcessToCgroup)
            # num_cpus is the lease's CPU request: it becomes the leaf's
            # cpu.weight, so a 2-CPU task outweighs a 0.5-CPU task under
            # contention (proportional, not a hard cap)
            entry.cgroup_leaf = self.cgroups.create_worker_group(
                WorkerID(worker_id).hex(),
                memory_bytes=config_mod.GlobalConfig
                .worker_memory_limit_bytes,
                num_cpus=num_cpus)
            self.cgroups.attach(entry.cgroup_leaf, proc.pid)
        entry.devices = devices
        with self._lock:
            self._workers[worker_id] = entry
            if devices is not None:
                self.devices.assigned[worker_id] = devices
        threading.Thread(target=self._wait_worker, args=(entry,),
                         daemon=True, name="node-waitpid").start()
        return entry

    def _wait_worker(self, entry: _WorkerEntry) -> None:
        entry.proc.wait()
        rc = entry.proc.returncode
        with self._lock:
            prev_state = entry.state
            entry.state = "dead"
            self._workers.pop(entry.worker_id, None)
            pool = self._idle.get(entry.env_key, [])
            if entry.worker_id in pool:
                pool.remove(entry.worker_id)
            if self.devices is not None:
                self.devices.release(entry.worker_id)
        entry.ready.set()
        if self.cgroups is not None:
            # kernel-enforced OOM (memory.max breach) leaves no trace in
            # our RSS poller — memory.events is the authoritative record
            ev = self.cgroups.memory_events(entry.cgroup_leaf)
            if ev.get("oom_kill", 0) > 0:
                self._record_fate(entry.worker_id, "oom")
            self.cgroups.remove_worker_group(entry.cgroup_leaf)
        if self._stopped.is_set() or prev_state == "stopping":
            return
        with self._lock:
            fate = self._fates.get(WorkerID(entry.worker_id).hex())
        report = {"worker_id": entry.worker_id, "node_id": self.node_id,
                  "reason": "oom-killed" if fate == "oom"
                            else f"exit code {rc}"}
        # crash forensics: attach the dead worker's dying words — the
        # tail of its raw stderr file plus the last structured-log lines
        # (both durable on THIS node's disk, so a SIGKILL loses nothing
        # the kernel already flushed) — for the worker_death journal
        tail_n = config_mod.GlobalConfig.log_death_tail_lines
        if tail_n > 0 and (entry.err_path or entry.log_path):
            from ray_tpu_torch.util import log_plane
            stderr_tail = log_plane.tail_lines(entry.err_path, tail_n)
            if stderr_tail:
                report["stderr_tail"] = stderr_tail
            log_tail = []
            for raw in log_plane.tail_lines(entry.log_path, tail_n):
                try:
                    log_tail.append(
                        log_plane.format_record(json.loads(raw)))
                except (ValueError, TypeError):
                    log_tail.append(raw)
            if log_tail:
                report["log_tail"] = log_tail
        try:
            self._clients.get(self.head_addr).call("worker_died", report)
        except RpcError:
            # head unreachable (likely restarting): queue the report so an
            # actor death during head downtime still triggers its restart
            with self._lock:
                self._dead_unreported.append(report)

    # --------------------------------------------------------- memory monitor

    @staticmethod
    def _rss_bytes(pid: int) -> Optional[int]:
        """Private RSS (resident minus shared pages): zero-copy views of
        shm-store objects must not count against a worker's cap — they are
        the node's arena, not the worker's memory."""
        try:
            with open(f"/proc/{pid}/statm") as f:
                fields = f.read().split()
            resident, shared = int(fields[1]), int(fields[2])
            return max(0, resident - shared) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            return None

    @staticmethod
    def _node_memory() -> Optional[tuple]:
        """(available, total) bytes from /proc/meminfo."""
        try:
            fields = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    fields[k] = int(v.strip().split()[0]) * 1024
            return fields["MemAvailable"], fields["MemTotal"]
        except (OSError, KeyError, ValueError):
            return None

    def _record_fate(self, worker_id: bytes, reason: str) -> None:
        with self._lock:
            self._fates[WorkerID(worker_id).hex()] = reason
            while len(self._fates) > 256:
                self._fates.popitem(last=False)

    def _h_worker_fate(self, p, ctx):
        with self._lock:
            return self._fates.get(p["worker_id"])

    def _oom_kill(self, entry: "_WorkerEntry", why: str) -> None:
        self._record_fate(entry.worker_id, "oom")
        from ray_tpu_torch.util import log_plane
        log_plane.get_logger().warning(
            f"MEMORY MONITOR: killing worker pid={entry.proc.pid} "
            f"({why})",
            worker=WorkerID(entry.worker_id).hex()[:12])
        try:
            entry.proc.kill()
        except OSError:
            pass

    def _memory_monitor_loop(self) -> None:
        cfg = config_mod.GlobalConfig
        period = cfg.memory_monitor_refresh_ms / 1000.0
        last_victim: Optional[bytes] = None
        victim_deadline = 0.0
        while not self._stopped.wait(period):
            limit = cfg.worker_memory_limit_bytes
            with self._lock:
                busy = [w for w in self._workers.values()
                        if w.state in ("leased", "actor")]
                fated = set(self._fates)
            # exclude workers already being killed: their RSS lingers
            # until the kernel reclaims, and re-selecting them (or their
            # neighbours) every tick is the cascade the grace below stops
            busy = [w for w in busy
                    if WorkerID(w.worker_id).hex() not in fated]
            # per-worker cap: deterministic, checked first
            if limit > 0:
                for w in busy:
                    rss = self._rss_bytes(w.proc.pid)
                    if rss is not None and rss > limit:
                        self._oom_kill(
                            w, f"rss {rss >> 20} MiB > limit "
                               f"{limit >> 20} MiB")
            # node-level pressure: ONE victim at a time, and no further
            # kills until the previous victim's process actually exited
            # (or a timeout passes) — /proc/meminfo lags SIGKILL reclaim
            # by several ticks, and killing on stale numbers wipes out
            # healthy workers (reference: MemoryMonitor waits for the
            # victim's death before re-evaluating)
            if last_victim is not None:
                with self._lock:
                    still_here = last_victim in self._workers
                if still_here and time.monotonic() < victim_deadline:
                    continue
                last_victim = None
            mem = self._node_memory()
            if mem is None:
                continue
            available, total = mem
            if total <= 0 or \
                    1.0 - available / total < cfg.memory_usage_threshold:
                continue
            # retriable-FIFO: newest leased (task) worker first, actors
            # only if no task worker exists (reference:
            # worker_killing_policy_retriable_fifo.h — retriable tasks
            # die before harder-to-restart work)
            victims = sorted((w for w in busy if w.state == "leased"),
                             key=lambda w: w.proc.pid, reverse=True) or \
                sorted((w for w in busy if w.state == "actor"),
                       key=lambda w: w.proc.pid, reverse=True)
            if victims:
                used_frac = 1.0 - available / total
                self._oom_kill(
                    victims[0],
                    f"node memory {used_frac:.0%} > "
                    f"{cfg.memory_usage_threshold:.0%}")
                last_victim = victims[0].worker_id
                victim_deadline = time.monotonic() + 10.0

    # --------------------------------------------------------- hw telemetry

    def _hw_sampler_loop(self) -> None:
        """Push one hardware-gauge batch per period over telemetry_push;
        the head lands each batch in its per-(node, metric) ring buffers
        (util/timeseries.py). Loss-tolerant by design: a down head just
        drops samples until it returns."""
        from ray_tpu_torch.runtime.hw_sampler import HardwareSampler
        from ray_tpu_torch.util import compile_tracker, log_plane, \
            stack_profiler
        period = config_mod.GlobalConfig.hw_sampler_period_s
        # the daemon itself never imports jax, so its tracker stays a
        # silent no-op — starting it anyway keeps the plane contract
        # uniform across processes (and live if that ever changes)
        try:
            compile_tracker.ensure_started(role="node",
                                           node=self.node_id[:12])
        except Exception:  # noqa: BLE001 — telemetry never stops boot
            pass

        def _worker_rows():
            with self._lock:
                return [{"worker_id": WorkerID(w.worker_id).hex(),
                         "pid": w.proc.pid, "state": w.state}
                        for w in self._workers.values()
                        if w.state != "dead"]

        sampler = HardwareSampler(
            cgroup_dir=self.cgroups.slice_dir
            if self.cgroups is not None else None,
            workers=_worker_rows,
            arena_stats=self.store.stats)
        while not self._stopped.wait(period):
            try:
                samples = sampler.sample()
                # the daemon's own collapsed-stack window rides the same
                # push (None when profiling is off or nothing sampled),
                # as do its structured-log window + staged storm events
                profiles = stack_profiler.drain_export()
                logs = log_plane.drain_export()
                journal = log_plane.drain_journal_events()
                compiles = compile_tracker.drain_export()
                journal = journal + \
                    compile_tracker.drain_journal_events()
                if samples or profiles or logs or journal or compiles:
                    # the metrics snapshot rides along so daemon-side
                    # counters (pull-out bytes, spill restores served)
                    # aggregate at the head like any worker's
                    self._clients.get(self.head_addr).oneway(
                        "telemetry_push", {
                            "worker": f"node:{self.node_id[:12]}",
                            "node": self.node_id, "role": "node",
                            "samples": samples, "profiles": profiles,
                            "logs": logs, "journal": journal,
                            "compiles": compiles,
                            "metrics": metrics_mod.snapshot()})
            except Exception:  # noqa: BLE001 — head down: keep sampling
                pass

    def _h_worker_ready(self, p, ctx):
        worker_id = p["worker_id"]
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None:
                return False
            entry.address = p["address"]
            # GPU workers never join the generic idle pool — leasing one
            # for a CPU task would strand its cards
            if entry.state == "starting" and entry.devices is None:
                entry.state = "idle"
                entry.idle_since = time.monotonic()
                self._idle.setdefault(entry.env_key, []).append(worker_id)
        entry.ready.set()
        return True

    def _h_lease_worker(self, p, ctx):
        """Pop an idle worker (spawning if under the cap); None = busy.

        GPU leases get a dedicated single-use worker spawned with
        CUDA_VISIBLE_DEVICES naming its allocated cards (visibility must be
        set before the process makes its CUDA context — reference:
        accelerators/nvidia_gpu.py); generic idle workers are never reused
        for cards and GPU workers never return to the generic pool. A GPU
        lease never falls back to a generic worker: a node without cards
        answers it as invalid.
        """
        cfg = config_mod.GlobalConfig
        renv = p.get("runtime_env") or None
        try:
            env_key, env_extra, cwd = self._prepare_runtime_env(renv)
        except RpcError:
            # transient: the head (KV holding the package) is unreachable —
            # report "busy" so the lease is retried, never a permanent
            # failure that kills the task/actor
            return None
        except Exception as e:  # noqa: BLE001 — missing package, bad zip…
            # structured reply, not a typed exception: a raised error would
            # bypass the head's RpcError handling and leak the resources it
            # acquired for this lease (same contract as invalid GPU counts)
            return {"invalid": f"runtime_env setup failed: {e}"}
        n_gpu = float(p.get("resources", {}).get("GPU", 0) or 0.0)
        n_cpu = float(p.get("resources", {}).get("CPU", 0) or 0.0)
        if n_gpu > 0:
            return self._lease_gpu_worker(n_gpu, cfg, env_extra=env_extra,
                                          cwd=cwd, num_cpus=n_cpu)
        with self._lock:
            pool = self._idle.setdefault(env_key, [])
            while pool:
                wid = pool.pop(0)
                entry = self._workers.get(wid)
                if entry is not None and entry.state == "idle":
                    # Liveness gate: a worker that died while pooled must
                    # never be handed out — the native transport fails
                    # pushes to a corpse in microseconds, so re-leasing
                    # one can burn a task's whole retry budget before the
                    # waitpid loop reports the death. NOTE: poll() alone
                    # can read None for a dead-but-unreaped child (the
                    # _wait_worker thread holds the waitpid lock), hence
                    # the /proc zombie check.
                    if _proc_dead(entry.proc):
                        continue  # the waitpid loop reports the death
                    entry.state = "leased"
                    return {"worker_id": wid, "worker_addr": entry.address}
            # count in-flight spawns too — concurrent lease RPCs must not
            # overshoot the pool cap between check and spawn
            evict_proc = None
            if len(self._workers) + self._spawn_reserved >= cfg.worker_pool_max:
                evict_proc = self._evict_one_idle_locked(env_key)
                if evict_proc is None:
                    return None  # pool genuinely busy: retry later
            self._spawn_reserved += 1
        if evict_proc is not None:
            try:
                evict_proc.terminate()
            except OSError:
                pass
        try:
            entry = self._spawn_worker(env_extra=env_extra, env_key=env_key,
                                       cwd=cwd, num_cpus=n_cpu)
        finally:
            with self._lock:
                self._spawn_reserved -= 1
        if not entry.ready.wait(timeout=cfg.rpc_connect_timeout_s * 3):
            return None
        with self._lock:
            if entry.state in ("starting", "idle"):
                pool = self._idle.get(entry.env_key, [])
                if entry.worker_id in pool:
                    pool.remove(entry.worker_id)
                entry.state = "leased"
                return {"worker_id": entry.worker_id,
                        "worker_addr": entry.address}
        return None

    def _prepare_runtime_env(self, renv):
        """(env_key, spawn-env additions, cwd) for a lease's runtime env.
        Materializes the working_dir package into the node cache on first
        use (reference: per-node runtime-env agent)."""
        from ray_tpu_torch.runtime import runtime_env as rtenv
        if not renv:
            return "", None, None
        env_key = rtenv.descriptor_key(renv)
        wd_path = None
        uri = renv.get("working_dir_uri")
        if uri:
            cache_root = os.path.join(
                config_mod.GlobalConfig.session_dir,
                f"rtenv_{self.session[:8]}")
            os.makedirs(cache_root, exist_ok=True)
            wd_path = rtenv.materialize(
                cache_root, uri,
                lambda k: self._clients.get(self.head_addr).call_retrying(
                    "kv_get", {"key": k}))
        return env_key, rtenv.worker_env(renv, wd_path), wd_path

    def _lease_gpu_worker(self, n_gpu: float, cfg, env_extra=None, cwd=None,
                          num_cpus: float = 0.0):
        from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
        try:
            GPUAcceleratorManager.validate_device_request(
                n_gpu, int(self.resources.get("GPU", 0)))
        except ValueError as e:
            # structured reply, not an exception: an invalid count must not
            # leak head-side acquisitions or crash client lease threads
            return {"invalid": str(e)}
        n_gpu = int(n_gpu)
        with self._lock:
            if len(self._workers) + self._spawn_reserved >= cfg.worker_pool_max:
                return None
            devices = self.devices.allocate(b"__reserving__", n_gpu)
            if devices is None:
                return None
            self.devices.assigned.pop(b"__reserving__", None)
            self._spawn_reserved += 1
        entry = None
        try:
            env = GPUAcceleratorManager.visibility_env(devices)
            if env_extra:
                env = {**env_extra, **env}
            entry = self._spawn_worker(env_extra=env, devices=devices,
                                       cwd=cwd, num_cpus=num_cpus)
        finally:
            with self._lock:
                self._spawn_reserved -= 1
                if entry is None:
                    # spawn raised after allocation — give the cards back
                    self.devices.release_devices(devices)
        if not entry.ready.wait(timeout=cfg.rpc_connect_timeout_s * 3):
            # stuck spawn: kill it so its cards free via _wait_worker
            # instead of the worker later joining the pool holding cards
            try:
                entry.proc.kill()
            except OSError:
                pass
            return None
        with self._lock:
            if entry.state in ("starting", "idle"):
                pool = self._idle.get(entry.env_key, [])
                if entry.worker_id in pool:
                    pool.remove(entry.worker_id)
                entry.state = "leased"
                return {"worker_id": entry.worker_id,
                        "worker_addr": entry.address}
        return None

    def _h_return_worker(self, p, ctx):
        with self._lock:
            entry = self._workers.get(p["worker_id"])
            if entry is None or entry.state == "dead":
                return False
            if _proc_dead(entry.proc):
                # returned a corpse (the usual reason a lease comes back
                # early): don't pool it — the waitpid loop reports it
                return False
            if entry.devices is not None:
                # GPU workers are single-use: their CUDA context already
                # holds specific cards — kill to free them
                entry.state = "stopping"
                proc = entry.proc
            else:
                entry.state = "idle"
                entry.idle_since = time.monotonic()
                pool = self._idle.setdefault(entry.env_key, [])
                if entry.worker_id not in pool:
                    pool.append(entry.worker_id)
                proc = None
        if proc is not None:
            try:
                proc.terminate()
            except OSError:
                pass
        return True

    def _h_start_actor(self, p, ctx):
        with self._lock:
            entry = self._workers.get(p["worker_id"])
        if entry is None or entry.address is None:
            raise RpcError("worker gone before actor start")
        with self._lock:
            entry.state = "actor"
            entry.actor_id = p.get("actor_id")
        self._clients.get(entry.address).call("become_actor", {
            "spec_bytes": p["spec_bytes"],
            "num_restarts": p.get("num_restarts", 0),
        })
        return True

    def _h_kill_worker(self, p, ctx):
        with self._lock:
            entry = self._workers.get(p["worker_id"])
        if entry is None:
            return False
        entry.proc.kill()
        return True

    def _h_list_workers(self, p, ctx):
        with self._lock:
            return [{"worker_id": w.worker_id.hex(), "state": w.state,
                     "address": w.address, "pid": w.proc.pid}
                    for w in self._workers.values()]

    def _h_node_stats(self, p, ctx):
        """psutil-style node report: cpu load, memory, disk, per-worker
        RSS — the reference's per-node reporter agent surface
        (dashboard/agent.py + reporter_agent.py), served straight from
        /proc instead of a separate agent process."""
        mem = self._node_memory()
        try:
            load1, load5, load15 = os.getloadavg()
        except OSError:
            load1 = load5 = load15 = None
        import shutil
        from ray_tpu_torch.runtime.object_plane import spill_dir_for
        spill = spill_dir_for(config_mod.GlobalConfig.session_dir,
                              self.shm_name)
        try:
            du = shutil.disk_usage(spill if os.path.isdir(spill) else "/")
            disk = {"total": du.total, "used": du.used, "free": du.free}
        except OSError:
            disk = None
        with self._lock:
            workers = [{"worker_id": w.worker_id.hex(), "state": w.state,
                        "pid": w.proc.pid,
                        "rss": self._rss_bytes(w.proc.pid)}
                       for w in self._workers.values()]
        return {
            "node_id": self.node_id,
            "cpus": os.cpu_count(),
            "load_avg": [load1, load5, load15],
            "mem_available": mem[0] if mem else None,
            "mem_total": mem[1] if mem else None,
            "disk": disk,
            "store": self.store.stats(),
            "workers": workers,
        }

    def _h_profile_worker(self, p, ctx):
        """On-demand stack dump of one worker (reference: dashboard
        reporter's py-spy profile_manager role): forwards to the worker's
        dump_stacks RPC."""
        wid = p["worker_id"]
        if isinstance(wid, str):
            wid = bytes.fromhex(wid)
        with self._lock:
            w = self._workers.get(wid)
            addr = w.address if w is not None else None
        if addr is None:
            raise ValueError(f"no live worker {wid.hex()} on this node")
        return self._clients.get(addr).call("dump_stacks", timeout=10.0)

    def _h_profile_burst(self, p, ctx):
        """Burst-capture leg of `profiles_record`: this daemon bursts
        itself while every (filtered) live worker bursts in parallel;
        rows come back tagged with node/worker ids so the head can
        attribute frames without knowing our topology."""
        from ray_tpu_torch.util.stack_profiler import burst_capture
        p = p or {}
        seconds = max(0.1, min(float(p.get("seconds", 2.0) or 2.0), 30.0))
        hz = float(p.get("hz", 99.0) or 99.0)
        worker_f = p.get("worker", "")
        node12 = self.node_id[:12]
        futs = []
        if p.get("include_workers", True):
            payload = {"seconds": seconds, "hz": hz}
            with self._lock:
                rows = [(WorkerID(w.worker_id).hex(), w.address)
                        for w in self._workers.values()
                        if w.state != "dead" and w.address]
            for wid, addr in rows:
                if worker_f and not wid.startswith(worker_f):
                    continue
                try:
                    futs.append((wid, self._clients.get(addr).call_async(
                        "profile_burst", payload)))
                except Exception:  # noqa: BLE001 — worker exiting
                    pass
        procs = []
        if p.get("include_self", True):
            procs.append({"key": f"node:{node12}", "role": "node",
                          "node": node12, "worker": "",
                          "export": burst_capture(seconds, hz)})
        for wid, fut in futs:
            try:
                export = fut.result(timeout=seconds + 10.0)
            except Exception:  # noqa: BLE001 — worker died mid-burst
                continue
            procs.append({"key": wid, "role": "worker", "node": node12,
                          "worker": wid[:12], "export": export})
        return {"procs": procs}

    # ----------------------------------------------------------- object plane

    def _h_read_object(self, p, ctx):
        """Serve an object's bytes in ONE frame (small objects only — the
        pull path switches to object_info/read_chunk above the chunk size;
        reference: ObjectManager::Push chunking, push_manager.h:30). Falls
        back to the node's spill directory for disk-overflowed objects."""
        view = self.store.get(p["object_id"])
        if view is None:
            data = self._read_spill(p["object_id"])
            if data is not None:
                self._m_spill_restore_total.inc()
                self._m_spill_restore_bytes.inc(len(data))
                self._m_pull_out_bytes.inc(len(data))
            return data
        try:
            data = bytes(view)
        finally:
            self.store.release(p["object_id"])
        self._m_pull_out_bytes.inc(len(data))
        return data

    def _h_object_info(self, p, ctx):
        """Size probe for the chunked pull path (None = not here)."""
        view = self.store.get(p["object_id"])
        if view is not None:
            try:
                return {"size": len(view)}
            finally:
                self.store.release(p["object_id"])
        try:
            return {"size": os.path.getsize(
                self._spill_path(p["object_id"])), "spilled": True}
        except OSError:
            return None

    def _h_read_chunk(self, p, ctx):
        """One chunk of a sealed (or spilled) object. Each chunk is an
        independent request, so many pipeline concurrently over the
        connection and a multi-GiB object never occupies a single frame
        or a matching-size contiguous reply buffer (reference: 64KiB-5MiB
        chunk streaming, object_manager.h / ObjectBufferPool)."""
        off, ln = p["offset"], p["length"]
        view = self.store.get(p["object_id"])
        if view is not None:
            try:
                data = bytes(view[off:off + ln])
            finally:
                self.store.release(p["object_id"])
            self._m_pull_out_bytes.inc(len(data))
            return data
        try:
            with open(self._spill_path(p["object_id"]), "rb") as f:
                f.seek(off)
                data = f.read(ln)
        except OSError:
            return None
        self._m_pull_out_bytes.inc(len(data))
        return data

    def _spill_path(self, oid: bytes) -> str:
        from ray_tpu_torch.core.config import GlobalConfig
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.runtime.object_plane import spill_file_path
        return spill_file_path(GlobalConfig.session_dir, self.store.name,
                               ObjectID(oid).hex())

    def _read_spill(self, oid: bytes):
        from ray_tpu_torch.core.config import GlobalConfig
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.runtime.object_plane import read_spill_file
        return read_spill_file(GlobalConfig.session_dir, self.store.name,
                               ObjectID(oid).hex())

    def _h_delete_object(self, p, ctx):
        """Owner-initiated free of a primary copy: drop the creator pin
        (held since create+seal — the primary-copy pin, reference: raylet
        pins primary copies until the owner frees), then delete. If readers
        still hold pins the store defers deletion to the last release."""
        oid = p["object_id"]
        try:
            import os
            os.unlink(self._spill_path(oid))
        except OSError:
            pass
        self.store.release(oid)
        return self.store.delete(oid)

    # ------------------------------------------------------------------ admin

    def _h_shutdown(self, p, ctx):
        threading.Thread(target=self.stop, daemon=True).start()
        return True

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            w.state = "stopping"
            try:
                w.proc.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + 3.0
        for w in workers:
            remaining = max(0.0, deadline - time.monotonic())
            try:
                w.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                w.proc.kill()
        if self.cgroups is not None:
            self.cgroups.shutdown()
        try:
            self._clients.get(self.head_addr).call(
                "unregister_node", {"node_id": self.node_id}, timeout=2.0)
        except RpcError:
            pass
        self.server.stop()
        self._clients.close_all()
        try:
            import shutil
            from ray_tpu_torch.core.config import GlobalConfig
            from ray_tpu_torch.runtime.object_plane import spill_dir_for
            shutil.rmtree(spill_dir_for(GlobalConfig.session_dir,
                                        self.store.name),
                          ignore_errors=True)
        except Exception:
            pass
        try:
            self.store.unlink()
        except Exception:
            pass
        self.store.close()


def main() -> None:
    """``python -m ray_tpu_torch.runtime.node <head_addr> <session> <json_args>``"""
    import signal

    head_addr = sys.argv[1]
    session = sys.argv[2]
    args = json.loads(sys.argv[3])
    if args.get("config"):
        config_mod.GlobalConfig.apply(args["config"])
    # chaos seam: lets lifecycle tests model a node that dies before it
    # ever registers (stillborn launch)
    from ray_tpu_torch.util.fault_injector import fire
    fire("node.boot")
    daemon = NodeDaemon(
        head_addr, session,
        resources=args.get("resources") or {"CPU": float(os.cpu_count() or 1)},
        object_store_bytes=args.get("object_store_bytes"),
        node_id=args.get("node_id"))
    signal.signal(signal.SIGTERM, lambda *_: daemon.stop())
    sys.stdout.write(f"RTPT_NODE_READY {daemon.address}\n")
    sys.stdout.flush()
    try:
        while not daemon._stopped.wait(1.0):
            pass
    except KeyboardInterrupt:
        daemon.stop()


if __name__ == "__main__":
    main()
