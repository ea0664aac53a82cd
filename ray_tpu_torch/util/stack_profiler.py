"""Cluster-wide wall-clock sampling profiler (the py-spy sense organ).

Role-equivalent to the reference's `ray stack` / py-spy integration
(reference: dashboard reporter profile_manager), but continuous and
cluster-wide: every process — head, node daemons, workers, drivers —
runs one `StackProfiler` daemon thread that samples
``sys._current_frames()`` at a low rate (default ~19 Hz; a prime-ish
rate so sampling never phase-locks with the 1 Hz/2 Hz periodic loops
it is meant to observe) and folds each thread's stack into a
collapsed-stack count table::

    mod.fn:line;mod.fn:line;mod.fn:line  count

The table is BOUNDED (`profile_table_size` distinct stacks): when it
is full, samples landing on unseen stacks are dropped and counted
exactly (``dropped``), so the denominator stays honest — a profile
always reports how much it did not see.  Every export is drained
atomically and rides the existing ``telemetry_push`` path to the
head's `ProfileStore` (per-process rings, merge-on-read), surfaced by
the ``profiles_dump`` RPC, ``/api/profile``, and
``python -m ray_tpu_torch profile`` (top-frames table, ``--flame`` collapsed
output, ``--speedscope`` JSON).

Burst mode (`burst_capture`) is the on-demand high-rate variant: a
synchronous capture at a caller-chosen rate for a bounded window,
independent of the continuous table — the CLI's ``--record SECONDS
--hz N`` fans it out to every selected process via ``profiles_record``.

Jax-free by construction: imported by the node daemon and the head,
which must never pull in the accelerator stack.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    "StackProfiler", "ProfileStore", "ensure_started", "drain_export",
    "burst_capture", "get_global", "stop_global", "merge_stacks",
    "top_frames", "to_speedscope",
]


def _fold_frame(frame) -> str:
    """One collapsed stack for ``frame``, root-first.

    Frames are ``module.function:line`` — line of the *currently
    executing* statement, so two hot call sites inside one function
    stay distinguishable in the flamegraph.
    """
    parts: List[str] = []
    f = frame
    while f is not None:
        mod = f.f_globals.get("__name__", "?")
        parts.append(f"{mod}.{f.f_code.co_name}:{f.f_lineno}")
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


def _sample_once(table: Dict[str, int], table_size: int,
                 skip_threads: frozenset) -> tuple:
    """Fold every live thread's stack into ``table``; returns
    (samples_taken, samples_dropped) for this pass."""
    taken = dropped = 0
    for tid, frame in sys._current_frames().items():
        if tid in skip_threads:
            continue
        taken += 1
        key = _fold_frame(frame)
        if key in table:
            table[key] += 1
        elif len(table) < table_size:
            table[key] = 1
        else:
            dropped += 1
    return taken, dropped


class StackProfiler:
    """Continuous low-rate sampler; one per process.

    ``export()`` atomically drains the fold table — callers get
    disjoint windows, so counts can be summed downstream without
    double-counting.
    """

    def __init__(self, hz: float = 19.0, table_size: int = 512,
                 clock: Callable[[], float] = time.monotonic):
        self.hz = max(0.1, float(hz))
        self.table_size = max(8, int(table_size))
        self._clock = clock
        self._lock = threading.Lock()
        self._table: Dict[str, int] = {}
        self._samples = 0
        self._dropped = 0
        self._window_start = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StackProfiler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="stack-profiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    @property
    def running(self) -> bool:
        return self._thread is not None

    def _run(self) -> None:
        interval = 1.0 / self.hz
        me = frozenset((threading.get_ident(),))
        while not self._stop.wait(interval):
            with self._lock:
                taken, dropped = _sample_once(
                    self._table, self.table_size, me)
                self._samples += taken
                self._dropped += dropped

    # -- draining ----------------------------------------------------------

    def export(self) -> Optional[dict]:
        """Drain the current window (None when nothing was sampled)."""
        now = self._clock()
        with self._lock:
            if not self._samples:
                self._window_start = now
                return None
            table, self._table = self._table, {}
            samples, self._samples = self._samples, 0
            dropped, self._dropped = self._dropped, 0
            start, self._window_start = self._window_start, now
        try:
            from ray_tpu_torch.util import metrics as metrics_mod
            metrics_mod.profile_samples_total_counter().inc(samples)
            if dropped:
                metrics_mod.profile_dropped_samples_total_counter() \
                    .inc(dropped)
        except Exception:  # noqa: BLE001 — telemetry must never fail
            pass
        return {"stacks": table, "samples": samples, "dropped": dropped,
                "hz": self.hz, "window_s": round(max(0.0, now - start), 3),
                "pid": os.getpid(), "ts": time.time()}


def burst_capture(seconds: float, hz: float = 99.0,
                  table_size: int = 4096) -> dict:
    """Synchronous on-demand capture: sample every live thread at ``hz``
    for ``seconds`` in the CALLING thread and return one export dict.
    Independent of the continuous profiler (own table, own budget) so a
    burst never skews the always-on profile."""
    seconds = max(0.0, min(float(seconds), 120.0))
    hz = max(1.0, min(float(hz), 1000.0))
    interval = 1.0 / hz
    me = frozenset((threading.get_ident(),))
    table: Dict[str, int] = {}
    samples = dropped = 0
    start = time.monotonic()
    deadline = start + seconds
    next_t = start
    while True:
        now = time.monotonic()
        if now >= deadline:
            break
        taken, drop = _sample_once(table, table_size, me)
        samples += taken
        dropped += drop
        next_t += interval
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
    return {"stacks": table, "samples": samples, "dropped": dropped,
            "hz": hz, "window_s": round(time.monotonic() - start, 3),
            "pid": os.getpid(), "ts": time.time(), "burst": True}


# -- process-wide singleton (started by head/node/worker bootstrap) --------

_global_lock = threading.Lock()
_global: Optional[StackProfiler] = None


def ensure_started(hz: Optional[float] = None,
                   table_size: Optional[int] = None) -> Optional[StackProfiler]:
    """Start (or return) this process's continuous profiler, honoring the
    `profile_enabled` / `profile_hz` / `profile_table_size` config knobs.
    Returns None when profiling is disabled."""
    global _global
    from ray_tpu_torch.core.config import GlobalConfig
    if not GlobalConfig.profile_enabled:
        return None
    with _global_lock:
        if _global is None:
            _global = StackProfiler(
                hz=hz if hz is not None else GlobalConfig.profile_hz,
                table_size=table_size if table_size is not None
                else GlobalConfig.profile_table_size)
            _global.start()
        return _global


def get_global() -> Optional[StackProfiler]:
    return _global


def stop_global() -> None:
    global _global
    with _global_lock:
        p, _global = _global, None
    if p is not None:
        p.stop()


def drain_export() -> Optional[dict]:
    """Drain this process's continuous profile (None when disabled or
    empty) — the telemetry flush's one-call hook."""
    p = _global
    return p.export() if p is not None else None


# -- head-side aggregation -------------------------------------------------


class ProfileStore:
    """Per-process export rings at the head, merged on read.

    Each reporting process (head, node daemons, workers, drivers) gets a
    bounded ring of drained windows; ``dump()`` merges a process's ring
    into one stack table and tags it with the process identity (role /
    node / worker), so the CLI can attribute every frame to the process
    it burned time in. LRU-bounded on processes so worker churn cannot
    grow the store without bound.
    """

    def __init__(self, ring: int = 8, max_procs: int = 256):
        self._ring = max(1, int(ring))
        self._max_procs = max(4, int(max_procs))
        self._lock = threading.Lock()
        # key -> {"meta": {...}, "exports": deque[export]}
        self._procs: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()

    def ingest(self, key: str, export: dict, role: str = "",
               node: str = "", worker: str = "") -> None:
        if not export or not isinstance(export, dict):
            return
        with self._lock:
            entry = self._procs.get(key)
            if entry is None:
                entry = {"meta": {}, "exports":
                         collections.deque(maxlen=self._ring)}
                self._procs[key] = entry
            entry["meta"] = {"role": role, "node": node, "worker": worker,
                             "pid": export.get("pid"), "ts": time.time()}
            entry["exports"].append(export)
            self._procs.move_to_end(key)
            while len(self._procs) > self._max_procs:
                self._procs.popitem(last=False)

    def dump(self, role: str = "", node: str = "", worker: str = "",
             top: int = 0) -> dict:
        """Merged per-process profiles, filtered by substring match on
        role / node / worker ids (empty filter matches all)."""
        with self._lock:
            items = [(k, dict(e["meta"]), list(e["exports"]))
                     for k, e in self._procs.items()]
        procs = []
        for key, meta, exports in items:
            if role and role not in (meta.get("role") or ""):
                continue
            if node and node not in (meta.get("node") or ""):
                continue
            if worker and worker not in (meta.get("worker") or key):
                continue
            stacks = merge_stacks([e.get("stacks") or {} for e in exports])
            if top and len(stacks) > top:
                keep = sorted(stacks.items(), key=lambda kv: -kv[1])[:top]
                stacks = dict(keep)
            procs.append({
                "key": key, **meta,
                "samples": sum(int(e.get("samples") or 0) for e in exports),
                "dropped": sum(int(e.get("dropped") or 0) for e in exports),
                "window_s": round(sum(float(e.get("window_s") or 0.0)
                                      for e in exports), 3),
                "stacks": stacks,
            })
        return {"procs": procs}

    def stats(self) -> dict:
        with self._lock:
            return {"procs": len(self._procs)}


# -- rendering helpers (shared by CLI / dashboard / bench) -----------------


def merge_stacks(tables: List[Optional[dict]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for t in tables:
        for stack, count in (t or {}).items():
            out[stack] = out.get(stack, 0) + int(count)
    return out


def top_frames(stacks: Dict[str, int], n: int = 20) -> List[dict]:
    """Self/cumulative attribution per frame over a collapsed table.

    ``self`` counts samples where the frame was the leaf; ``cum`` counts
    samples where it appeared anywhere on the stack (deduped within one
    stack so recursion never double-counts). Sorted by self, then cum.
    """
    self_c: Dict[str, int] = {}
    cum_c: Dict[str, int] = {}
    for stack, count in stacks.items():
        frames = stack.split(";")
        if not frames:
            continue
        leaf = frames[-1]
        self_c[leaf] = self_c.get(leaf, 0) + count
        for fr in set(frames):
            cum_c[fr] = cum_c.get(fr, 0) + count
    rows = [{"frame": fr, "self": self_c.get(fr, 0), "cum": cum}
            for fr, cum in cum_c.items()]
    rows.sort(key=lambda r: (-r["self"], -r["cum"], r["frame"]))
    return rows[:n] if n else rows


def to_speedscope(stacks: Dict[str, int], name: str = "ray_tpu_torch") -> dict:
    """Collapsed table -> speedscope 'sampled' profile JSON
    (https://www.speedscope.app/file-format-schema.json)."""
    frame_ix: Dict[str, int] = {}
    frames: List[dict] = []
    samples: List[List[int]] = []
    weights: List[int] = []
    for stack, count in sorted(stacks.items()):
        row = []
        for fr in stack.split(";"):
            ix = frame_ix.get(fr)
            if ix is None:
                ix = frame_ix[fr] = len(frames)
                frames.append({"name": fr})
            row.append(ix)
        samples.append(row)
        weights.append(int(count))
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled", "name": name, "unit": "none",
            "startValue": 0, "endValue": total,
            "samples": samples, "weights": weights,
        }],
        "name": name, "exporter": "ray_tpu_torch-profile",
    }
