"""Cluster-wide structured log plane (the sixth observability pillar).

Role-equivalent to the reference's log directory + log monitor + state
API logs (reference: python/ray/_private/log_monitor.py tails
``session_latest/logs`` into GCS pubsub; `ray logs` serves the files) —
redesigned as a structured dual-sink: every process (head, node
daemons, workers, drivers) installs ONE `StructuredLogger` emitting
JSON-lines records::

    {ts, level, role, node, worker, pid, trace_id, request_id,
     msg, fields}

with ambient correlation stamped at emit time — ``trace_id`` from
util/trace_context (the same contextvar task execution activates), and
``request_id`` from this module's request contextvar (activated by the
Serve/LLM path around a request's lifetime) — so one grep joins a log
line to its trace's span tree and its request's token timeline.

Sink (a): a per-node session log directory (``head.log``,
``node-<id>.log``, ``worker-<id>.log`` next to the worker's raw
``.out``/``.err`` streams) with size-capped rotation — durable, survives
the process, and is what crash forensics tails after a SIGKILL.

Sink (b): a bounded per-process ring with EXACT drop accounting
(``emitted == stored + dropped`` always holds; ``log_records_total
{level}`` / ``log_dropped_records_total`` keep the denominator honest —
same contract as the profiler's bounded fold table), drained atomically
by ``drain_export()`` and riding the existing ``telemetry_push`` path
(the profiler's ``"profiles"`` key pattern) into the head's `LogStore`:
severity-indexed, LRU-bounded per-process rings served by the
``logs_dump`` cursor RPC, ``/api/logs``, and ``python -m ray_tpu_torch logs``.

Error storms are first-class: every error record is fingerprinted
(message with digits/hex normalized out, so one bug is ONE fingerprint
across a thousand instances — ``log_errors_total{fingerprint}``), and a
rate spike past ``log_error_storm_threshold`` inside
``log_error_storm_window_s`` stages a ``log_error_storm`` journal event
(drained by ``drain_journal_events()``, sequenced at the head like any
cluster event).

Jax-free by construction: imported by the node daemon and the head,
which must never pull in the accelerator stack.
"""

from __future__ import annotations

import collections
import contextvars
import hashlib
import io
import json
import os
import re
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "StructuredLogger", "LogStore", "ensure_started", "get_global",
    "get_logger", "stop_global", "drain_export", "drain_journal_events",
    "activate_request", "deactivate_request", "current_request",
    "request_context", "error_fingerprint", "session_log_dir",
    "tail_lines", "format_record",
]

#: severity order for the ``--level`` floor filter
LEVELS: Dict[str, int] = {"debug": 10, "info": 20, "warning": 30,
                          "error": 40}

#: distinct error fingerprints tracked per process; the long tail folds
#: into "other" so a pathological workload cannot explode the tag space
_FINGERPRINT_CAP = 64


# -- ambient request correlation ------------------------------------------
#
# trace_id comes from util/trace_context (already ambient around every
# task body and Serve hop); request_id gets its own contextvar here,
# activated by the LLM serve path around one request's lifetime — a
# contextvar for the same reason the trace is one: async-replica
# coroutines interleave on a single loop thread.

_request_var: contextvars.ContextVar = contextvars.ContextVar(
    "rtpu_log_request", default="")


def activate_request(request_id: str):
    """Install a request id as ambient; returns a token for
    ``deactivate_request``."""
    return _request_var.set(str(request_id or ""))


def deactivate_request(token) -> None:
    try:
        _request_var.reset(token)
    except ValueError:  # token from another context: best-effort clear
        _request_var.set("")


def current_request() -> str:
    return _request_var.get()


class request_context:
    """``with request_context(rid):`` — ambient request-id scope."""

    def __init__(self, request_id: str):
        self._rid = request_id
        self._tok = None

    def __enter__(self):
        self._tok = activate_request(self._rid)
        return self

    def __exit__(self, *exc):
        deactivate_request(self._tok)
        return False


# -- error fingerprinting --------------------------------------------------

_NUM_RE = re.compile(r"0x[0-9a-fA-F]+|[0-9a-f]{8,}|\d+")


def error_fingerprint(msg: str) -> str:
    """Stable 12-hex id of an error MESSAGE SHAPE: numbers, addresses
    and long hex ids are normalized to '#' first, so 'worker 4f21 died
    rc=137' and 'worker 9ac3 died rc=1' dedup to one fingerprint."""
    norm = _NUM_RE.sub("#", str(msg))[:512]
    return hashlib.sha1(norm.encode("utf-8", "replace")).hexdigest()[:12]


# -- durable file sink -----------------------------------------------------


class _FileSink:
    """Append-only JSON-lines file with size-capped rotation
    (``path`` -> ``path.1`` ... ``path.<backups>``). Write failures are
    swallowed after disabling the sink: logging must never take down the
    process it observes."""

    def __init__(self, path: str, max_bytes: int, backups: int = 1):
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        self.backups = max(1, int(backups))
        self._lock = threading.Lock()
        self._f: Optional[io.TextIOWrapper] = None
        self._size = 0
        self._dead = False

    def _open(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = self._f.tell()

    def _rotate_locked(self) -> None:
        self._f.close()
        self._f = None
        for i in range(self.backups, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            try:
                os.replace(src, f"{self.path}.{i}")
            except OSError:
                pass
        self._open()

    def write_line(self, line: str) -> None:
        if self._dead:
            return
        data = line if line.endswith("\n") else line + "\n"
        try:
            with self._lock:
                if self._f is None:
                    self._open()
                elif self._size + len(data) > self.max_bytes:
                    self._rotate_locked()
                self._f.write(data)
                self._f.flush()
                self._size += len(data)
        except (OSError, ValueError):
            self._dead = True

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


# -- per-process structured logger ----------------------------------------


class StructuredLogger:
    """One per process; every record is dual-sunk (file + bounded ring).

    The ring drops the OLDEST record on overflow and counts the drop
    exactly, and ``export()`` drains ring + counters atomically — so
    across any sequence of exports, ``sum(emitted) == sum(len(records))
    + sum(dropped)`` holds to the record (the acceptance invariant).
    """

    def __init__(self, role: str = "", node: str = "", worker: str = "",
                 ring_size: int = 1024, sink: Optional[_FileSink] = None,
                 storm_threshold: int = 50, storm_window_s: float = 10.0):
        self.role = role
        self.node = node
        self.worker = worker
        self.pid = os.getpid()
        self.sink = sink
        self._ring_size = max(8, int(ring_size))
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque()
        self._emitted = 0          # records accepted this window
        self._dropped = 0          # ring overflow drops this window
        self.emitted_total = 0
        self.dropped_total = 0
        # error-storm detection: timestamps of recent errors; one
        # journal event per excursion, re-armed when the rate recovers
        self._storm_threshold = max(0, int(storm_threshold))
        self._storm_window_s = max(0.1, float(storm_window_s))
        self._errors_recent: collections.deque = collections.deque()
        self._storm_active = False
        self._journal_events: List[dict] = []
        self._fingerprints: Dict[str, int] = {}
        try:
            from ray_tpu_torch.util import metrics as metrics_mod
            self._m_records = metrics_mod.log_records_total_counter()
            self._m_dropped = \
                metrics_mod.log_dropped_records_total_counter()
            self._m_errors = metrics_mod.log_errors_total_counter()
        except Exception:  # noqa: BLE001 — metrics must never gate logs
            self._m_records = self._m_dropped = self._m_errors = None

    # -- emission ----------------------------------------------------------

    def log(self, level: str, msg: str, **fields) -> dict:
        level = level if level in LEVELS else "info"
        trace_id = ""
        try:
            from ray_tpu_torch.util import trace_context
            ctx = trace_context.current()
            if ctx is not None:
                trace_id = ctx[0]
        except Exception:  # noqa: BLE001
            pass
        rec = {"ts": time.time(), "level": level, "role": self.role,
               "node": self.node, "worker": self.worker, "pid": self.pid,
               "trace_id": trace_id, "request_id": current_request(),
               "msg": str(msg), "fields": fields or {}}
        if self._m_records is not None:
            try:
                self._m_records.inc(1, tags={"level": level})
            except Exception:  # noqa: BLE001
                pass
        if level == "error":
            self._note_error(rec)
        if self.sink is not None:
            try:
                self.sink.write_line(json.dumps(rec, default=str))
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            self._emitted += 1
            self.emitted_total += 1
            if len(self._ring) >= self._ring_size:
                self._ring.popleft()
                self._dropped += 1
                self.dropped_total += 1
                if self._m_dropped is not None:
                    try:
                        self._m_dropped.inc(1)
                    except Exception:  # noqa: BLE001
                        pass
            self._ring.append(rec)
        return rec

    def debug(self, msg: str, **fields) -> dict:
        return self.log("debug", msg, **fields)

    def info(self, msg: str, **fields) -> dict:
        return self.log("info", msg, **fields)

    def warning(self, msg: str, **fields) -> dict:
        return self.log("warning", msg, **fields)

    def error(self, msg: str, **fields) -> dict:
        return self.log("error", msg, **fields)

    def _note_error(self, rec: dict) -> None:
        fp = error_fingerprint(rec["msg"])
        with self._lock:
            if fp not in self._fingerprints and \
                    len(self._fingerprints) >= _FINGERPRINT_CAP:
                fp = "other"
            self._fingerprints[fp] = self._fingerprints.get(fp, 0) + 1
            now = rec["ts"]
            q = self._errors_recent
            q.append(now)
            while q and now - q[0] > self._storm_window_s:
                q.popleft()
            storm = self._storm_threshold > 0 and \
                len(q) >= self._storm_threshold
            fire = storm and not self._storm_active
            if fire:
                self._storm_active = True
                self._journal_events.append({
                    "type": "log_error_storm", "role": self.role,
                    "node": self.node, "worker": self.worker,
                    "errors": len(q),
                    "window_s": self._storm_window_s,
                    "fingerprint": fp})
            elif not storm and \
                    len(q) < max(1, self._storm_threshold // 2):
                self._storm_active = False  # re-arm after recovery
        rec["fields"].setdefault("fingerprint", fp)
        if self._m_errors is not None:
            try:
                self._m_errors.inc(1, tags={"fingerprint": fp})
            except Exception:  # noqa: BLE001
                pass

    # -- draining ----------------------------------------------------------

    def export(self) -> Optional[dict]:
        """Drain the ring window atomically (None when empty AND nothing
        was dropped — a window that only dropped still exports, so the
        head's drop ledger never undercounts)."""
        with self._lock:
            if not self._ring and not self._dropped:
                return None
            records, self._ring = list(self._ring), collections.deque()
            emitted, self._emitted = self._emitted, 0
            dropped, self._dropped = self._dropped, 0
        return {"records": records, "emitted": emitted,
                "dropped": dropped, "pid": self.pid, "ts": time.time()}

    def drain_journal_events(self) -> List[dict]:
        with self._lock:
            evs, self._journal_events = self._journal_events, []
        return evs

    def stats(self) -> dict:
        with self._lock:
            return {"emitted_total": self.emitted_total,
                    "dropped_total": self.dropped_total,
                    "buffered": len(self._ring),
                    "fingerprints": dict(self._fingerprints)}

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


class _NullLogger:
    """Plane disabled: swallow debug/info, keep warnings/errors visible
    on the REAL stderr (``sys.__stderr__`` — never a tee wrapper, so a
    worker's tee'd streams cannot recurse through us)."""

    role = node = worker = ""
    sink = None

    def log(self, level: str, msg: str, **fields) -> dict:
        if level in ("warning", "error"):
            try:
                import sys
                real = sys.__stderr__
                if real is not None:
                    real.write(f"{level.upper()}: {msg}\n")
                    real.flush()
            except (OSError, ValueError):
                pass
        return {}

    def debug(self, msg: str, **fields) -> dict:
        return self.log("debug", msg, **fields)

    def info(self, msg: str, **fields) -> dict:
        return self.log("info", msg, **fields)

    def warning(self, msg: str, **fields) -> dict:
        return self.log("warning", msg, **fields)

    def error(self, msg: str, **fields) -> dict:
        return self.log("error", msg, **fields)

    def export(self):
        return None

    def drain_journal_events(self):
        return []

    def stats(self):
        return {}

    def close(self):
        pass


_NULL = _NullLogger()


# -- process-wide singleton (installed by head/node/worker/driver boot) ----

_global_lock = threading.Lock()
_global: Optional[StructuredLogger] = None


def session_log_dir(session: str) -> str:
    """The per-node durable log directory for ``session`` under
    ``session_dir`` (one per host filesystem; daemons and workers of one
    session all write here)."""
    from ray_tpu_torch.core.config import GlobalConfig
    return os.path.join(GlobalConfig.session_dir, "logs",
                        session or "default")


def ensure_started(role: str = "", node: str = "", worker: str = "",
                   log_dir: Optional[str] = None,
                   filename: str = "") -> Optional[StructuredLogger]:
    """Install (or return) this process's structured logger, honoring the
    ``log_plane_enabled`` / ``log_ring_records`` / ``log_file_max_bytes``
    / ``log_file_backups`` / ``log_error_storm_*`` config knobs.
    Returns None when the plane is disabled."""
    global _global
    from ray_tpu_torch.core.config import GlobalConfig
    if not GlobalConfig.log_plane_enabled:
        return None
    with _global_lock:
        if _global is None:
            sink = None
            if log_dir and filename:
                sink = _FileSink(os.path.join(log_dir, filename),
                                 max_bytes=GlobalConfig.log_file_max_bytes,
                                 backups=GlobalConfig.log_file_backups)
            _global = StructuredLogger(
                role=role, node=node, worker=worker,
                ring_size=GlobalConfig.log_ring_records, sink=sink,
                storm_threshold=GlobalConfig.log_error_storm_threshold,
                storm_window_s=GlobalConfig.log_error_storm_window_s)
        return _global


def get_global() -> Optional[StructuredLogger]:
    return _global


def get_logger():
    """The process logger, or a null logger that keeps warnings/errors
    on real stderr — call sites never need an enabled-check."""
    return _global if _global is not None else _NULL


def stop_global() -> None:
    global _global
    with _global_lock:
        lg, _global = _global, None
    if lg is not None:
        lg.close()


def drain_export() -> Optional[dict]:
    """Drain this process's log window (None when disabled or empty) —
    the telemetry flush's one-call hook (rides ``telemetry_push`` under
    the ``"logs"`` key)."""
    lg = _global
    return lg.export() if lg is not None else None


def drain_journal_events() -> List[dict]:
    """Staged cluster events (error storms) for the telemetry flush's
    ``"journal"`` key; the head assigns seq/ts at arrival."""
    lg = _global
    return lg.drain_journal_events() if lg is not None else []


# -- head-side aggregation -------------------------------------------------


class LogStore:
    """Severity-indexed per-process record rings at the head.

    Each reporting process gets one ring PER SEVERITY (an error survives
    a flood of later debug lines — the forensically valuable records age
    out last), LRU-bounded on processes so worker churn cannot grow the
    store without bound. Records get a head-assigned, globally monotonic
    ``seq`` at ingest, which is the ``logs_dump`` follow cursor — same
    contract as the event journal's (ordering is the head's, not the
    reporters' clocks).
    """

    def __init__(self, ring: int = 2048, max_procs: int = 256):
        self._ring = max(8, int(ring))
        self._max_procs = max(4, int(max_procs))
        self._lock = threading.Lock()
        self._seq = 0
        # key -> {"meta": {...}, "rings": {level: deque}, "dropped": n,
        #         "counts": {level: n}}
        self._procs: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()

    def ingest(self, key: str, export: dict, role: str = "",
               node: str = "", worker: str = "") -> None:
        if not export or not isinstance(export, dict):
            return
        records = export.get("records") or []
        with self._lock:
            entry = self._procs.get(key)
            if entry is None:
                entry = {"meta": {}, "rings": {}, "dropped": 0,
                         "counts": {}}
                self._procs[key] = entry
            entry["meta"] = {"role": role, "node": node, "worker": worker,
                             "pid": export.get("pid"), "ts": time.time()}
            entry["dropped"] += int(export.get("dropped") or 0)
            for rec in records:
                if not isinstance(rec, dict):
                    continue
                self._seq += 1
                rec["seq"] = self._seq
                level = rec.get("level") or "info"
                ring = entry["rings"].get(level)
                if ring is None:
                    ring = entry["rings"][level] = \
                        collections.deque(maxlen=self._ring)
                ring.append(rec)
                entry["counts"][level] = \
                    entry["counts"].get(level, 0) + 1
            self._procs.move_to_end(key)
            while len(self._procs) > self._max_procs:
                self._procs.popitem(last=False)

    def dump(self, after_seq: int = 0, role: str = "", node: str = "",
             worker: str = "", level: str = "", since: float = 0.0,
             grep: str = "", trace: str = "", request: str = "",
             limit: int = 0) -> dict:
        """Merged, filtered records — oldest-first by head seq; ``limit``
        keeps the NEWEST N (the tail is the diagnostically valuable
        part); ``after_seq`` is the follow cursor. ``grep`` is a regex
        over the rendered msg; ``level`` a severity floor."""
        floor = LEVELS.get(level, 0)
        rx = re.compile(grep) if grep else None
        with self._lock:
            procs = [(k, dict(e["meta"]),
                      [list(r) for r in e["rings"].values()],
                      e["dropped"])
                     for k, e in self._procs.items()]
            last_seq = self._seq
        out: List[dict] = []
        dropped_total = 0
        for key, meta, rings, dropped in procs:
            if role and role not in (meta.get("role") or ""):
                continue
            if node and node not in (meta.get("node") or ""):
                continue
            if worker and worker not in (meta.get("worker") or key):
                continue
            dropped_total += dropped
            for ring in rings:
                for rec in ring:
                    if rec["seq"] <= after_seq:
                        continue
                    if floor and LEVELS.get(rec.get("level"), 20) < floor:
                        continue
                    if since and float(rec.get("ts") or 0.0) < since:
                        continue
                    if trace and trace not in (rec.get("trace_id") or ""):
                        continue
                    if request and \
                            request not in (rec.get("request_id") or ""):
                        continue
                    if rx is not None and \
                            not rx.search(str(rec.get("msg") or "")):
                        continue
                    out.append(rec)
        out.sort(key=lambda r: r["seq"])
        if limit and len(out) > limit:
            out = out[-limit:]
        return {"records": out, "last_seq": last_seq,
                "dropped_total": dropped_total}

    def stats(self) -> dict:
        with self._lock:
            return {"procs": len(self._procs), "last_seq": self._seq,
                    "dropped_total": sum(e["dropped"]
                                         for e in self._procs.values())}


# -- forensics + rendering helpers (shared by node / CLI / dashboard) ------


def tail_lines(path: Optional[str], n: int,
               max_bytes: int = 65536) -> List[str]:
    """Last ``n`` lines of a (possibly large) file — bounded read from
    the end, never the whole file. Missing/unreadable files are []."""
    if not path or n <= 0:
        return []
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            data = f.read(max_bytes + 1)
    except OSError:
        return []
    text = data.decode("utf-8", "replace")
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return lines[-n:]


def format_record(rec: dict) -> str:
    """One human line for a record (the CLI / death-tail render)."""
    ts = time.strftime("%H:%M:%S", time.localtime(rec.get("ts") or 0))
    who = rec.get("worker") or rec.get("node") or rec.get("role") or "?"
    line = f"{ts} {str(rec.get('level') or '?').upper():7s} " \
           f"{rec.get('role') or '?':6s} {who:12s} {rec.get('msg', '')}"
    fields = rec.get("fields") or {}
    if fields:
        kv = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        line += f"  [{kv}]"
    if rec.get("trace_id"):
        line += f"  trace={rec['trace_id'][:12]}"
    if rec.get("request_id"):
        line += f"  req={rec['request_id']}"
    return line
