"""Per-node hardware sampler — CPU/RSS/cgroup/arena/GPU gauges.

Role-equivalent to the reference's per-node reporter agent poll loop
(reference: dashboard/modules/reporter/reporter_agent.py sampling psutil +
GPU stats on a period and shipping them to the metrics agent), served from
/proc directly: the node daemon runs one `HardwareSampler` on a ~2s period
and pushes each batch over the existing `telemetry_push` path; the head
lands the points in per-(node, metric) ring buffers (util/timeseries.py).

The procfs/cgroup roots are injectable so tests run against a faked tree;
the GPU probe NEVER imports torch and never creates a CUDA context (the
daemons own no card — see accelerators/gpu.py): it only reads device
memory when some other code in the process already initialized CUDA,
which is true in GPU workers and false in the node daemon and on CPU-only
hosts.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

Sample = dict  # {"metric": str, "value": float, "tags": {str: str}}


def read_proc_stat_cpu(procfs: str = "/proc") -> Optional[tuple]:
    """(busy_ticks, total_ticks) from the aggregate cpu line."""
    try:
        with open(os.path.join(procfs, "stat")) as f:
            first = f.readline().split()
        if first[:1] != ["cpu"]:
            return None
        ticks = [int(x) for x in first[1:]]
        total = sum(ticks)
        idle = ticks[3] + (ticks[4] if len(ticks) > 4 else 0)  # idle+iowait
        return total - idle, total
    except (OSError, ValueError, IndexError):
        return None


def read_pid_cpu_ticks(pid: int, procfs: str = "/proc") -> Optional[int]:
    """utime+stime ticks for one process (fields 14/15 of /proc/pid/stat;
    comm is parenthesized and may contain spaces — split after ')')."""
    try:
        with open(os.path.join(procfs, str(pid), "stat")) as f:
            rest = f.read().rsplit(")", 1)[1].split()
        # rest[0] is field 3 (state) -> utime is rest[11], stime rest[12]
        return int(rest[11]) + int(rest[12])
    except (OSError, ValueError, IndexError):
        return None


def read_pid_rss(pid: int, procfs: str = "/proc") -> Optional[int]:
    """Resident bytes from /proc/pid/statm (total resident, the operator
    view — the OOM monitor's private-RSS variant subtracts shm views)."""
    try:
        with open(os.path.join(procfs, str(pid), "statm")) as f:
            fields = f.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def read_meminfo(procfs: str = "/proc") -> Optional[tuple]:
    """(available, total) bytes."""
    try:
        fields = {}
        with open(os.path.join(procfs, "meminfo")) as f:
            for line in f:
                k, v = line.split(":", 1)
                fields[k] = int(v.strip().split()[0]) * 1024
        return fields["MemAvailable"], fields["MemTotal"]
    except (OSError, KeyError, ValueError):
        return None


def read_cgroup_cpu_usec(cg_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(cg_dir, "cpu.stat")) as f:
            for line in f:
                k, _, v = line.partition(" ")
                if k == "usage_usec":
                    return int(v)
    except (OSError, ValueError):
        pass
    return None


def read_cgroup_memory_current(cg_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(cg_dir, "memory.current")) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def read_cgroup_pressure(cg_dir: str, which: str = "cpu") -> Optional[float]:
    """avg10 of the `some` line of {cpu,memory,io}.pressure (PSI)."""
    try:
        with open(os.path.join(cg_dir, f"{which}.pressure")) as f:
            for line in f:
                if line.startswith("some"):
                    for part in line.split():
                        if part.startswith("avg10="):
                            return float(part[6:])
    except (OSError, ValueError):
        pass
    return None


def gpu_memory_samples() -> List[Sample]:
    """Device memory used/reserved/total per visible CUDA device — ONLY
    when torch is already imported in this process and has already made
    its CUDA context (never imports torch and never creates a context: a
    context costs device memory and the daemons own no card)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    out: List[Sample] = []
    try:
        if not torch.cuda.is_initialized():
            return []
        for i in range(torch.cuda.device_count()):
            tags = {"device": str(i)}
            out.append({"metric": "gpu_memory_used_bytes",
                        "value": float(torch.cuda.memory_allocated(i)),
                        "tags": tags})
            out.append({"metric": "gpu_memory_reserved_bytes",
                        "value": float(torch.cuda.memory_reserved(i)),
                        "tags": tags})
            out.append({"metric": "gpu_memory_limit_bytes",
                        "value": float(torch.cuda.get_device_properties(
                            i).total_memory),
                        "tags": tags})
    except Exception:  # noqa: BLE001 — a probe must never break telemetry
        return out
    return out


class HardwareSampler:
    """Stateful delta-based sampler; one per node daemon.

    workers(): -> [{"worker_id": hex, "pid": int, "state": str}, ...]
    arena_stats(): -> ShmStore.stats() dict (or {}).
    """

    def __init__(self, procfs: str = "/proc",
                 cgroup_dir: Optional[str] = None,
                 workers: Optional[Callable[[], List[dict]]] = None,
                 arena_stats: Optional[Callable[[], dict]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.procfs = procfs
        self.cgroup_dir = cgroup_dir
        self._workers = workers or (lambda: [])
        self._arena_stats = arena_stats or (lambda: {})
        self._clock = clock
        self._ncpu = os.cpu_count() or 1
        try:
            self._hz = os.sysconf("SC_CLK_TCK")
        except (ValueError, OSError):
            self._hz = 100
        # previous readings for the delta-based percentages
        self._prev_node_cpu: Optional[tuple] = None          # (busy, total)
        self._prev_pid_ticks: Dict[int, tuple] = {}          # pid -> (t, ticks)
        self._prev_cg_usec: Optional[tuple] = None           # (t, usec)
        # probes that already logged a failure (warn once, not per period)
        self._warned_probes: set = set()

    # -- individual probes (each returns a list of samples) ---------------

    def _node_cpu(self) -> List[Sample]:
        cur = read_proc_stat_cpu(self.procfs)
        if cur is None:
            return []
        prev, self._prev_node_cpu = self._prev_node_cpu, cur
        if prev is None or cur[1] <= prev[1]:
            return []
        busy_d, total_d = cur[0] - prev[0], cur[1] - prev[1]
        pct = 100.0 * max(0, busy_d) / max(1, total_d)
        return [{"metric": "node_cpu_percent", "value": round(pct, 2),
                 "tags": {}}]

    def _node_mem(self) -> List[Sample]:
        mem = read_meminfo(self.procfs)
        if mem is None:
            return []
        available, total = mem
        return [
            {"metric": "node_mem_used_bytes",
             "value": float(total - available), "tags": {}},
            {"metric": "node_mem_total_bytes", "value": float(total),
             "tags": {}},
        ]

    def _worker_samples(self) -> List[Sample]:
        out: List[Sample] = []
        now = self._clock()
        live_pids = set()
        for w in self._workers():
            pid = w.get("pid")
            if pid is None:
                continue
            live_pids.add(pid)
            wid = str(w.get("worker_id", pid))[:12]
            tags = {"worker": wid, "state": str(w.get("state", ""))}
            rss = read_pid_rss(pid, self.procfs)
            if rss is not None:
                out.append({"metric": "worker_rss_bytes",
                            "value": float(rss), "tags": tags})
            ticks = read_pid_cpu_ticks(pid, self.procfs)
            if ticks is not None:
                prev = self._prev_pid_ticks.get(pid)
                self._prev_pid_ticks[pid] = (now, ticks)
                if prev is not None and now > prev[0] \
                        and ticks >= prev[1]:
                    # ticks < prev means the pid was REUSED between
                    # passes (counter restarted from ~0): drop the
                    # garbage delta and let the fresh baseline above
                    # seed the next pass. Clamp the emitted percentage
                    # to the host's physical ceiling — a tick-counter
                    # hiccup must never graph a 4000%-CPU worker.
                    pct = 100.0 * (ticks - prev[1]) / self._hz \
                        / (now - prev[0])
                    pct = min(max(0.0, pct), 100.0 * self._ncpu)
                    out.append({"metric": "worker_cpu_percent",
                                "value": round(pct, 2),
                                "tags": tags})
        # forget exited pids so the delta table doesn't grow with churn
        for pid in [p for p in self._prev_pid_ticks if p not in live_pids]:
            del self._prev_pid_ticks[pid]
        return out

    def _cgroup_samples(self) -> List[Sample]:
        if not self.cgroup_dir:
            return []
        out: List[Sample] = []
        now = self._clock()
        usec = read_cgroup_cpu_usec(self.cgroup_dir)
        if usec is not None:
            prev, self._prev_cg_usec = self._prev_cg_usec, (now, usec)
            if prev is not None and now > prev[0]:
                pct = (usec - prev[1]) / 1e4 / (now - prev[0])
                out.append({"metric": "cgroup_cpu_percent",
                            "value": round(max(0.0, pct), 2), "tags": {}})
        mem = read_cgroup_memory_current(self.cgroup_dir)
        if mem is not None:
            out.append({"metric": "cgroup_mem_current_bytes",
                        "value": float(mem), "tags": {}})
        for which in ("cpu", "memory"):
            avg10 = read_cgroup_pressure(self.cgroup_dir, which)
            if avg10 is not None:
                out.append({"metric": f"cgroup_{which}_pressure_avg10",
                            "value": avg10, "tags": {}})
        return out

    def _arena_samples(self) -> List[Sample]:
        try:
            st = self._arena_stats() or {}
        except Exception:  # noqa: BLE001 — store closing during shutdown
            return []
        out: List[Sample] = []
        for key, metric in (("bytes_used", "object_store_used_bytes"),
                            ("capacity", "object_store_capacity_bytes"),
                            ("num_objects", "object_store_num_objects"),
                            ("total_evicted", "object_store_evictions")):
            if key in st:
                out.append({"metric": metric, "value": float(st[key]),
                            "tags": {}})
        return out

    def sample(self) -> List[Sample]:
        """One sampling pass; each call emits the current gauge batch
        (CPU percentages need a prior pass to have a delta, so the very
        first call omits them).

        Probes are ISOLATED: one raising probe (e.g. gpu_memory_samples
        mid-backend-shutdown) loses only its own gauges for that pass,
        never the whole batch — and logs once, not once per period."""
        out: List[Sample] = []
        for name, probe in (("node_cpu", self._node_cpu),
                            ("node_mem", self._node_mem),
                            ("workers", self._worker_samples),
                            ("cgroup", self._cgroup_samples),
                            ("arena", self._arena_samples),
                            ("gpu", gpu_memory_samples)):
            try:
                out += probe()
            except Exception as e:  # noqa: BLE001 — probe fault boundary
                if name not in self._warned_probes:
                    self._warned_probes.add(name)
                    logger.warning(
                        "hardware probe %s failed (suppressing repeats "
                        "for this probe): %r", name, e)
        ts = time.time()
        for s in out:
            s.setdefault("ts", ts)
        return out
