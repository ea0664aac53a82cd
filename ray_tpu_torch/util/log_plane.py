"""Structured log plane — the port's own copy of the parts of
``ray_tpu/util/log_plane.py`` that the LLM server calls.

One ``StructuredLogger`` per process emits JSON-able records::

    {ts, level, role, node, worker, pid, trace_id, request_id,
     msg, fields}

with ambient correlation stamped at emit time — ``trace_id`` from
``util/trace_context`` and ``request_id`` from this module's request
contextvar (activated by the server around a request's lifetime) — so a
log line joins its request's flight-recorder record and its trace.

Records land in a bounded per-process ring with EXACT drop accounting
(``emitted == stored + dropped`` across any sequence of ``export()``
drains; ``log_records_total{level}`` / ``log_dropped_records_total``
keep the denominator honest).

The JAX package's file sink with rotation, its error fingerprints and
error-storm journal events, and the head-side store wait for a copy of
the runtime that drains them.
"""

from __future__ import annotations

import collections
import contextvars
import os
import threading
import time
from typing import Dict, Optional

from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import trace_context

#: records buffered per process between drains (the JAX package's
#: ``log_ring_records`` default)
RING_RECORDS = 1024

#: severity order for a ``--level`` floor filter
LEVELS: Dict[str, int] = {"debug": 10, "info": 20, "warning": 30,
                          "error": 40}


# -- ambient request correlation ------------------------------------------
#
# trace_id comes from util/trace_context; request_id gets its own
# contextvar here, activated by the LLM serve path around one request's
# lifetime — a contextvar for the same reason the trace is one: coroutines
# interleave on a single loop thread.

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


# -- per-process structured logger ----------------------------------------


class StructuredLogger:
    """One per process; every record lands in a bounded ring.

    The ring drops the OLDEST record on overflow and counts the drop
    exactly, and ``export()`` drains ring + counters atomically — so
    across any sequence of exports, ``sum(emitted) == sum(len(records))
    + sum(dropped)`` holds to the record.
    """

    def __init__(self, role: str = "", node: str = "", worker: str = "",
                 ring_size: int = 1024):
        self.role = role
        self.node = node
        self.worker = worker
        self.pid = os.getpid()
        self._ring_size = max(8, int(ring_size))
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque()
        self._emitted = 0          # records accepted this window
        self._dropped = 0          # ring overflow drops this window
        self.emitted_total = 0
        self.dropped_total = 0
        self._m_records = metrics_mod.log_records_total_counter()
        self._m_dropped = metrics_mod.log_dropped_records_total_counter()

    # -- emission ----------------------------------------------------------

    def log(self, level: str, msg: str, **fields) -> dict:
        level = level if level in LEVELS else "info"
        ctx = trace_context.current()
        rec = {"ts": time.time(), "level": level, "role": self.role,
               "node": self.node, "worker": self.worker, "pid": self.pid,
               "trace_id": ctx[0] if ctx is not None else "",
               "request_id": current_request(),
               "msg": str(msg), "fields": fields or {}}
        self._m_records.inc(1, tags={"level": level})
        with self._lock:
            self._emitted += 1
            self.emitted_total += 1
            if len(self._ring) >= self._ring_size:
                self._ring.popleft()
                self._dropped += 1
                self.dropped_total += 1
                self._m_dropped.inc(1)
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

    # -- draining ----------------------------------------------------------

    def export(self) -> Optional[dict]:
        """Drain the ring window atomically (None when empty AND nothing
        was dropped — a window that only dropped still exports, so a
        drop ledger never undercounts)."""
        with self._lock:
            if not self._ring and not self._dropped:
                return None
            records, self._ring = list(self._ring), collections.deque()
            emitted, self._emitted = self._emitted, 0
            dropped, self._dropped = self._dropped, 0
        return {"records": records, "emitted": emitted,
                "dropped": dropped, "pid": self.pid, "ts": time.time()}


class _NullLogger:
    """No logger installed yet: swallow debug/info, keep warnings/errors
    visible on the REAL stderr (``sys.__stderr__``)."""

    role = node = worker = ""

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


_NULL = _NullLogger()


# -- process-wide singleton ----------------------------------------------

_global_lock = threading.Lock()
_global: Optional[StructuredLogger] = None


def ensure_started(role: str = "", node: str = "",
                   worker: str = "") -> StructuredLogger:
    """Install (or return) this process's structured logger (a ring of
    ``RING_RECORDS``)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = StructuredLogger(role=role, node=node, worker=worker,
                                       ring_size=RING_RECORDS)
        return _global


def get_global() -> Optional[StructuredLogger]:
    return _global


def get_logger():
    """The process logger, or a null logger that keeps warnings/errors
    on real stderr — call sites never need an enabled-check."""
    return _global if _global is not None else _NULL
