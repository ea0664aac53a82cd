"""Compile/dispatch observability plane — the port's counterpart of
``ray_tpu/util/compile_tracker.py``.

It records compiles as structured records ``{callable_name,
module_fingerprint, arg shape/dtype signature, duration, backend, process
identity, ambient trace_id}`` in a bounded per-process ring with exact
drop accounting, detects **recompiles** (same callable, new signature —
the signature diff that caused the recompile is recorded with it), and
journals a once-per-excursion ``compile_storm`` cluster event when the
recompile rate crosses ``compile_storm_threshold`` per
``compile_storm_window_s``. ``CompileTracker.wrap(fn)`` detects compiles
by the callable's cache growth (a ``_cache_size`` probe) or signature
novelty; ``note_monitor_duration``/``note_cache_miss`` take durations
and cache misses reported by a compiler.

The port has two observation paths, as the JAX package has:

- ``CompileTracker.wrap(fn)``: the engine wraps its step functions
  (``llm.ragged_step``, ``llm.decode_loop``, ``llm.copy_page``, probed by
  the growth of its program set: a new step program is the port's
  compile) and ``dag.CompiledDAG`` its executions (``dag.compiled``: each
  new CUDA graph capture, or on the CPU each new input signature);
- ``note_phase``/``note_cache_miss``, the counterparts of the JAX
  package's ``jax.monitoring`` listener pair (``_on_jax_duration``,
  ``_on_jax_event``), called by the port's own compiles: ``ops/_kernels``
  reports each kernel library ``nvcc`` builds (one ``cache_miss``, its
  seconds as ``backend_compile``) and each library it loads (``load``:
  the dlopen and the binding of its entry points), ``dag.CompiledDAG`` a
  CUDA graph's capture and instantiation (``backend_compile``). A phase
  reported while a wrapped call is in flight on the same thread goes to
  that call's record (``phases``, ``backend_s``); otherwise a
  ``backend_compile`` becomes a nameless record and any other kind is
  only counted. On the CPU a ``CompiledDAG`` captures nothing, so it
  reports no phase where JAX's jit reports its compile.

A record's ``backend`` names the port's platform: "cuda" for a kernel
library's build or load and in a process that holds a CUDA context,
"cpu" otherwise. Importing this module imports neither jax nor torch —
node daemons and the head run it.

Exports drain through the existing ``telemetry_push`` into the head's
``CompileStore`` (``compiles_dump`` cursor RPC) and feed the
``xla_compile_seconds`` / ``xla_compiles_total{process,kind}`` /
``xla_recompiles_total`` series.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

# distinct callables tracked per process (LRU beyond this)
_MAX_CALLABLES = 256
# staged journal events kept between telemetry flushes
_MAX_JOURNAL = 64
# signature-novelty fallback: distinct signatures remembered per wrap
_MAX_SEEN_SIGS = 4096

_DTYPE_SHORT = {
    "float32": "f32", "float64": "f64", "float16": "f16",
    "bfloat16": "bf16", "int64": "i64", "int32": "i32", "int16": "i16",
    "int8": "i8", "uint64": "u64", "uint32": "u32", "uint16": "u16",
    "uint8": "u8", "bool": "bool", "complex64": "c64",
    "complex128": "c128", "int4": "i4", "uint4": "u4",
    "float8_e4m3fn": "f8_e4m3", "float8_e5m2": "f8_e5m2",
}


def _fmt_value(a: Any) -> str:
    """One argument's compile-relevant identity, jax-style: arrays as
    ``dtype[shape]`` (the jit cache key), Python scalars as their weak
    type name, everything else as its type name — never the value, so
    signatures stay bounded and safe to ship."""
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        # torch dtypes print as "torch.float32" and have no .name
        name = getattr(dtype, "name", None) or str(dtype).removeprefix(
            "torch.")
        short = _DTYPE_SHORT.get(name, name)
        try:
            dims = ",".join(str(int(d)) for d in shape)
        except Exception:  # noqa: BLE001 — abstract/symbolic dims
            dims = ",".join(str(d) for d in shape)
        return f"{short}[{dims}]"
    if isinstance(a, bool):
        return "bool"
    if isinstance(a, int):
        return "int"
    if isinstance(a, float):
        return "float"
    if a is None:
        return "None"
    if isinstance(a, (tuple, list)) and len(a) <= 8:
        inner = ",".join(_fmt_value(x) for x in a)
        return f"({inner})" if isinstance(a, tuple) else f"[{inner}]"
    return type(a).__name__


def signature_of(args: Sequence[Any], kwargs: Optional[dict] = None,
                 max_args: int = 64) -> List[str]:
    """Positional shape/dtype signature of a call — the abstract part
    of the jit cache key. Long arglists fold their tail into one
    ``+N more`` entry so a pathological pytree can't bloat records."""
    sig: List[str] = []
    for a in args[:max_args]:
        sig.append(_fmt_value(a))
    if len(args) > max_args:
        sig.append(f"+{len(args) - max_args} more")
    for k in sorted(kwargs or ()):
        if len(sig) >= max_args + 8:
            sig.append("+kwargs")
            break
        sig.append(f"{k}={_fmt_value(kwargs[k])}")
    return sig


def signature_diff(old: Optional[Sequence[str]], new: Sequence[str],
                   max_entries: int = 8) -> List[str]:
    """Positional diff between two signatures — the exact arguments
    whose shape/dtype change caused a recompile, as
    ``arg[i]: old -> new`` lines (capped; arity changes noted)."""
    if old is None:
        return []
    out: List[str] = []
    for i in range(min(len(old), len(new))):
        if old[i] != new[i]:
            out.append(f"arg[{i}]: {old[i]} -> {new[i]}")
            if len(out) >= max_entries:
                out.append("...")
                return out
    if len(old) != len(new):
        out.append(f"arity: {len(old)} -> {len(new)} args")
    return out


def fingerprint(name: str, signature: Sequence[str]) -> str:
    """Short stable id of one compiled program: callable × signature
    (what XLA caches one executable per). Equal fingerprints across
    processes mean the same program was built twice — wasted compile
    time a cross-process compilation cache would have saved."""
    h = hashlib.sha1(
        ("|".join([name] + list(signature))).encode("utf-8", "replace"))
    return h.hexdigest()[:12]


# thread-local in-flight attribution stack: CompileTracker.wrap pushes
# an accumulator dict around the wrapped call; ``note_phase`` adds
# compile-phase seconds to the top entry instead of recording an
# unattributed compile
_tls = threading.local()


class CompileTracker:
    """Bounded per-process ring of XLA compile records with exact drop
    accounting (``emitted == exported + stored + dropped`` always),
    per-callable recompile detection, and storm journaling."""

    def __init__(self, role: str = "", node: str = "", worker: str = "",
                 ring_records: int = 512, storm_threshold: int = 8,
                 storm_window_s: float = 60.0):
        self.role = role
        self.node = node
        self.worker = worker
        self.ring_records = max(int(ring_records), 1)
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque()
        self._emitted_total = 0
        self._exported_total = 0
        self._dropped_total = 0
        self._emitted_since = 0
        self._dropped_since = 0
        # a phase or cache miss counted since the last export: the
        # counts ride the next one even with no record (a library's load)
        self._counted_since = False
        # name -> {"compiles","recompiles","wall_s","measured_s",
        #          "last_sig","last_diff"}; LRU-bounded
        self._per_callable: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._counts: Dict[str, int] = {}
        self._recompile_ts: collections.deque = collections.deque()
        self._storm_active = False
        self._journal: List[dict] = []
        self._last_recompile: Optional[dict] = None

    # ------------------------------------------------------------ seam

    def wrap(self, fn: Callable, name: Optional[str] = None,
             probe: Optional[Callable[[], int]] = None) -> Callable:
        """The jit cache-miss seam: returns ``fn`` wrapped so each call
        that compiled (detected by cache growth via ``probe`` — default
        the jit's own ``_cache_size`` — or, probeless, by signature
        novelty) records a compile with this call's signature, wall
        duration, and whatever phase seconds ``note_phase`` attributed
        to it in flight."""
        label = name or getattr(fn, "__name__", None) or repr(fn)
        if probe is None:
            probe = getattr(fn, "_cache_size", None)
        seen: set = set()
        tracker = self

        def wrapped(*args, **kwargs):
            stack = getattr(_tls, "inflight", None)
            if stack is None:
                stack = _tls.inflight = []
            before: Optional[int] = None
            if probe is not None:
                try:
                    before = int(probe())
                except Exception:  # noqa: BLE001 — probe is best-effort
                    before = None
            sig: Optional[List[str]] = None
            if before is None:
                # probeless path needs the signature up front to test
                # novelty; the probed path defers it to actual misses
                sig = signature_of(args, kwargs)
            acc: Dict[str, float] = {}
            stack.append(acc)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                wall = time.perf_counter() - t0
                stack.pop()
                compiled = False
                if before is not None:
                    try:
                        compiled = int(probe()) > before
                    except Exception:  # noqa: BLE001
                        compiled = False
                elif sig is not None:
                    key = tuple(sig)
                    if key not in seen:
                        if len(seen) < _MAX_SEEN_SIGS:
                            seen.add(key)
                        compiled = True
                if not compiled and acc.get("backend_compile"):
                    # a compile was reported during this exact call —
                    # trust it over a stale probe
                    compiled = True
                if compiled:
                    if sig is None:
                        sig = signature_of(args, kwargs)
                    tracker.note_compile(label, sig, wall_s=wall,
                                         phases=acc)

        try:
            functools.update_wrapper(wrapped, fn)
        except Exception:  # noqa: BLE001 — jit objects lack some attrs
            pass
        wrapped.__rtpu_compile_wrapped__ = fn  # type: ignore[attr-defined]
        return wrapped

    # ------------------------------------------------------ recording

    def note_compile(self, name: str, signature: Sequence[str],
                     wall_s: float = 0.0,
                     phases: Optional[Dict[str, float]] = None,
                     backend: str = "", kind: str = "jit") -> dict:
        """Record one compile of ``name`` under ``signature``. Called
        by the wrap seam and by tests with synthetic signatures; safe
        from any thread. Returns the record (also ringed)."""
        now = time.time()
        sig = [str(s) for s in signature]
        phases = dict(phases or {})
        measured = round(sum(phases.values()), 6)
        if not backend:
            backend = platform()
        from ray_tpu_torch.util import trace_context
        ctx = trace_context.current()
        with self._lock:
            st = self._per_callable.get(name)
            if st is None:
                if len(self._per_callable) >= _MAX_CALLABLES:
                    self._per_callable.popitem(last=False)
                st = {"compiles": 0, "recompiles": 0, "wall_s": 0.0,
                      "measured_s": 0.0, "last_sig": None,
                      "last_diff": []}
                self._per_callable[name] = st
            else:
                self._per_callable.move_to_end(name)
            prev = st["last_sig"]
            recompile = prev is not None and prev != sig
            diff = signature_diff(prev, sig) if recompile else []
            st["compiles"] += 1
            st["wall_s"] += wall_s
            st["measured_s"] += measured
            st["last_sig"] = sig
            if recompile:
                st["recompiles"] += 1
                st["last_diff"] = diff
            rec = {"ts": round(now, 6), "name": name,
                   "fingerprint": fingerprint(name, sig),
                   "signature": sig, "kind": kind,
                   "duration_s": round(wall_s, 6),
                   "measured_s": measured,
                   "backend_s": round(phases.get("backend_compile",
                                                 0.0), 6),
                   "phases": {k: round(v, 6) for k, v in phases.items()},
                   "backend": backend, "pid": self.pid,
                   "trace_id": ctx[0] if ctx else "",
                   "recompile": recompile, "diff": diff,
                   "nth": st["compiles"]}
            self._append_locked(rec)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            if recompile:
                self._counts["recompile"] = \
                    self._counts.get("recompile", 0) + 1
                self._last_recompile = {"name": name, "diff": diff,
                                        "signature": sig,
                                        "ts": rec["ts"]}
                self._note_recompile_locked(now, name, diff)
        try:
            from ray_tpu_torch.util import metrics
            metrics.xla_compiles_total_counter().inc(
                tags={"process": self.role or "process", "kind": kind})
            if recompile:
                metrics.xla_recompiles_total_counter().inc()
            metrics.xla_compile_seconds_histogram().observe(
                measured if measured > 0 else wall_s)
        except Exception:  # noqa: BLE001 — metrics never block tracking
            pass
        return rec

    def note_monitor_duration(self, kind: str, duration: float,
                              backend: str = "") -> None:
        """An unattributed compile phase (no wrapped call in flight on
        this thread): count every phase; ring a record only for the
        backend-compile phase, so an unwrapped compile (a kernel
        library's build) still shows up — nameless — instead of
        vanishing."""
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._counted_since = True
            if kind == "backend_compile":
                self._append_locked({
                    "ts": round(time.time(), 6), "name": "",
                    "fingerprint": "", "signature": [], "kind": kind,
                    "duration_s": round(duration, 6),
                    "measured_s": round(duration, 6),
                    "backend_s": round(duration, 6),
                    "phases": {kind: round(duration, 6)},
                    "backend": backend or platform(),
                    "pid": self.pid, "trace_id": "",
                    "recompile": False, "diff": [], "nth": 0})
        try:
            from ray_tpu_torch.util import metrics
            metrics.xla_compiles_total_counter().inc(
                tags={"process": self.role or "process", "kind": kind})
            if kind == "backend_compile":
                metrics.xla_compile_seconds_histogram().observe(duration)
        except Exception:  # noqa: BLE001
            pass

    def note_cache_miss(self) -> None:
        with self._lock:
            self._counts["cache_miss"] = \
                self._counts.get("cache_miss", 0) + 1
            self._counted_since = True

    def _append_locked(self, rec: dict) -> None:
        self._emitted_total += 1
        self._emitted_since += 1
        if len(self._ring) >= self.ring_records:
            self._ring.popleft()
            self._dropped_total += 1
            self._dropped_since += 1
        self._ring.append(rec)

    def _note_recompile_locked(self, now: float, name: str,
                               diff: List[str]) -> None:
        # same excursion semantics as log_plane._note_error: prune the
        # sliding window, fire ONE journal event when the rate first
        # crosses the threshold, re-arm once it falls below half
        q = self._recompile_ts
        q.append(now)
        while q and now - q[0] > self.storm_window_s:
            q.popleft()
        storm = self.storm_threshold > 0 and \
            len(q) >= self.storm_threshold
        if storm and not self._storm_active:
            self._storm_active = True
            self._stage_journal_locked({
                "type": "compile_storm", "role": self.role,
                "node": self.node, "worker": self.worker,
                "pid": self.pid, "recompiles": len(q),
                "window_s": self.storm_window_s,
                "threshold": self.storm_threshold,
                "callable": name, "diff": diff})
        elif not storm and len(q) < max(1, self.storm_threshold // 2):
            self._storm_active = False

    def _stage_journal_locked(self, ev: dict) -> None:
        if len(self._journal) < _MAX_JOURNAL:
            self._journal.append(ev)

    def stage_journal_event(self, etype: str, **fields) -> None:
        """Stage an arbitrary cluster-journal event to ride the next
        telemetry flush (consumers: llm/engine.py's compile-invariant
        breach). Identity fields are stamped here so the head journal
        entry names the offending process without extra plumbing."""
        ev = {"type": etype, "role": self.role, "node": self.node,
              "worker": self.worker, "pid": self.pid}
        ev.update(fields)
        with self._lock:
            self._stage_journal_locked(ev)

    # ------------------------------------------------------- queries

    def callable_stats(self, name: str) -> Optional[dict]:
        """Cumulative per-callable compile accounting (compiles,
        recompiles, wall/measured seconds, last signature + diff)."""
        with self._lock:
            st = self._per_callable.get(name)
            return dict(st) if st is not None else None

    def last_recompile(self, prefix: str = "") -> Optional[dict]:
        """Most recent recompile (name, diff, signature, ts) —
        optionally only among callables whose name starts with
        ``prefix`` (e.g. ``"llm."`` for the engine's invariant)."""
        with self._lock:
            lr = self._last_recompile
            if lr is not None and lr["name"].startswith(prefix):
                return dict(lr)
            if not prefix:
                return None
            best = None
            for name, st in self._per_callable.items():
                if name.startswith(prefix) and st["recompiles"]:
                    best = {"name": name, "diff": list(st["last_diff"]),
                            "signature": list(st["last_sig"] or []),
                            "ts": 0.0}
            return best

    def stats(self) -> dict:
        with self._lock:
            return {"emitted": self._emitted_total,
                    "exported": self._exported_total,
                    "stored": len(self._ring),
                    "dropped": self._dropped_total,
                    "callables": len(self._per_callable),
                    "counts": dict(self._counts),
                    "storm_active": self._storm_active}

    # -------------------------------------------------------- export

    def export(self) -> Optional[dict]:
        """Atomically drain the ring for a telemetry flush. None when
        nothing was emitted, dropped or counted since the last export —
        a drop with an empty ring still exports, so the head's ledger
        never under-counts (log_plane contract), and so does a counted
        phase, so the head's counts stay current."""
        with self._lock:
            if not (self._emitted_since or self._dropped_since
                    or self._counted_since):
                return None
            records = list(self._ring)
            self._ring.clear()
            self._exported_total += len(records)
            out = {"pid": self.pid, "ts": round(time.time(), 6),
                   "records": records,
                   "emitted": self._emitted_since,
                   "dropped": self._dropped_since,
                   "counts": dict(self._counts)}
            self._emitted_since = 0
            self._dropped_since = 0
            self._counted_since = False
            return out

    def drain_journal_events(self) -> List[dict]:
        with self._lock:
            evs, self._journal = self._journal, []
            return evs


# ---------------------------------------------------------------------
# process-global tracker (pattern: stack_profiler/log_plane singletons)

_global_lock = threading.Lock()
_global: Optional[CompileTracker] = None


def ensure_started(role: str = "", node: str = "",
                   worker: str = "") -> Optional[CompileTracker]:
    """Start (or return) this process's tracker, honoring the
    ``compile_tracker_enabled`` knob — None when disabled. Identity
    fields stick from the first caller (worker bootstrap / node daemon
    / head / driver connect)."""
    global _global
    from ray_tpu_torch.core.config import GlobalConfig
    if not GlobalConfig.compile_tracker_enabled:
        return None
    with _global_lock:
        if _global is None:
            _global = CompileTracker(
                role=role, node=node, worker=worker,
                ring_records=GlobalConfig.compile_ring_records,
                storm_threshold=GlobalConfig.compile_storm_threshold,
                storm_window_s=GlobalConfig.compile_storm_window_s)
    return _global


def get_global() -> Optional[CompileTracker]:
    return _global


def stop_global() -> None:
    global _global
    with _global_lock:
        _global = None


def drain_export() -> Optional[dict]:
    """This process's compile window for the telemetry flush (None when
    the plane is off or nothing happened)."""
    tracker = _global
    if tracker is None:
        return None
    return tracker.export()


def drain_journal_events() -> List[dict]:
    """Staged compile_storm / invariant-breach events for the head's
    cluster journal ([] when none)."""
    tracker = _global
    if tracker is None:
        return []
    return tracker.drain_journal_events()


# ---------------------------------------------------------------------
# the port's compile phases: the counterpart of the JAX package's
# jax.monitoring listener pair (_on_jax_duration, _on_jax_event), called by
# the port's own compiles (ops/_kernels.py, dag.py)


def platform() -> str:
    """The port's platform for a record: "cuda" when this process holds a
    CUDA context, else "cpu" (torch read from ``sys.modules``, never
    imported here)."""
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            return "cuda"
    except Exception:  # noqa: BLE001 — a torch still being imported
        pass
    return "cpu"


def note_phase(kind: str, seconds: float, backend: str = "") -> None:
    """One compile phase of ``seconds`` (``backend_compile``, ``load``):
    added to the innermost wrapped call in flight on this thread, else
    to the process tracker's unattributed phases
    (``note_monitor_duration``); dropped when there is no tracker."""
    stack = getattr(_tls, "inflight", None)
    if stack:
        acc = stack[-1]
        acc[kind] = acc.get(kind, 0.0) + float(seconds)
        return
    tracker = get_global()
    if tracker is not None:
        tracker.note_monitor_duration(kind, float(seconds), backend)


def note_cache_miss() -> None:
    """One compile-cache miss (a kernel library missing from the build
    directory), counted by the process tracker, if any."""
    tracker = get_global()
    if tracker is not None:
        tracker.note_cache_miss()


# ---------------------------------------------------------------------
# head-side store


class CompileStore:
    """Head-side aggregation of per-process compile exports: an LRU of
    per-process rings (pattern: LogStore/ProfileStore), head-assigned
    monotonic ``seq`` per record (the ``after_seq`` follow cursor for
    ``compiles_dump``), substring filters, and an exact drop ledger
    combining process-side ring drops with head-side evictions."""

    def __init__(self, max_procs: int = 64, ring_records: int = 2048):
        self.max_procs = max_procs
        self.ring_records = ring_records
        self._lock = threading.Lock()
        self._procs: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._seq = 0
        self._dropped_total = 0

    def ingest(self, key: str, export: dict, role: str = "",
               node: str = "", worker: str = "") -> None:
        if not isinstance(export, dict):
            return
        records = export.get("records") or []
        with self._lock:
            entry = self._procs.get(key)
            if entry is None:
                if len(self._procs) >= self.max_procs:
                    _, old = self._procs.popitem(last=False)
                    self._dropped_total += len(old["ring"])
                entry = {"meta": {}, "ring": collections.deque(
                    maxlen=self.ring_records), "dropped": 0}
                self._procs[key] = entry
            else:
                self._procs.move_to_end(key)
            entry["meta"] = {"role": role, "node": node,
                             "worker": worker,
                             "pid": export.get("pid", 0),
                             "ts": export.get("ts", 0.0),
                             "counts": export.get("counts") or {}}
            dropped = int(export.get("dropped") or 0)
            entry["dropped"] += dropped
            self._dropped_total += dropped
            ring = entry["ring"]
            for rec in records:
                if not isinstance(rec, dict):
                    continue
                self._seq += 1
                rec = dict(rec)
                rec["seq"] = self._seq
                rec["role"] = role
                rec["node"] = node
                rec["worker"] = worker
                if len(ring) == ring.maxlen:
                    self._dropped_total += 1
                    entry["dropped"] += 1
                ring.append(rec)

    def dump(self, after_seq: int = 0, role: str = "", node: str = "",
             worker: str = "", callable: str = "",
             recompiles_only: bool = False, limit: int = 500,
             by_callable: bool = False) -> dict:
        """Merged records (seq order) with cursor + filters. ``limit``
        keeps the NEWEST matches, so a follow loop never misses records
        it could have had (same contract as ``logs_dump``). ``counts``:
        each matching process's latest phase and kind counts, by its
        store key (the port's addition: a library's ``load`` is counted,
        never ringed)."""
        out: List[dict] = []
        agg: Dict[str, dict] = {}
        counts: Dict[str, dict] = {}
        with self._lock:
            for key, entry in self._procs.items():
                m = entry["meta"]
                if role and role not in (m.get("role") or ""):
                    continue
                if node and node not in (m.get("node") or ""):
                    continue
                if worker and worker not in (m.get("worker") or ""):
                    continue
                counts[key] = dict(m.get("counts") or {})
                for rec in entry["ring"]:
                    if callable and callable not in rec.get("name", ""):
                        continue
                    if by_callable:
                        name = rec.get("name") or "<unattributed>"
                        a = agg.setdefault(name, {
                            "compiles": 0, "recompiles": 0,
                            "seconds": 0.0, "procs": set(),
                            "last_sig": [], "last_diff": []})
                        a["compiles"] += 1
                        a["seconds"] += rec.get("measured_s") or \
                            rec.get("duration_s") or 0.0
                        a["procs"].add(m.get("worker") or "")
                        if rec.get("recompile"):
                            a["recompiles"] += 1
                            a["last_diff"] = rec.get("diff") or []
                        a["last_sig"] = rec.get("signature") or []
                    if rec["seq"] <= after_seq:
                        continue
                    if recompiles_only and not rec.get("recompile"):
                        continue
                    out.append(rec)
            last_seq = self._seq
            dropped_total = self._dropped_total
            procs = len(self._procs)
        out.sort(key=lambda r: r["seq"])
        if limit and len(out) > limit:
            out = out[-limit:]
        result = {"records": out, "last_seq": last_seq,
                  "dropped_total": dropped_total, "procs": procs,
                  "counts": counts}
        if by_callable:
            for a in agg.values():
                a["procs"] = len(a["procs"])
                a["seconds"] = round(a["seconds"], 6)
            result["by_callable"] = agg
        return result

    def stats(self) -> dict:
        with self._lock:
            return {"procs": len(self._procs),
                    "records": sum(len(e["ring"])
                                   for e in self._procs.values()),
                    "dropped_total": self._dropped_total,
                    "last_seq": self._seq}
