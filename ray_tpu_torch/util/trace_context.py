"""Ambient W3C-style trace context — the port's own copy of
``ray_tpu/util/trace_context.py``.

A (trace_id, parent span_id) pair is the ambient context of the running
request; the LLM server stamps the ambient trace id onto the engine's
flight-recorder record and the log plane onto every record it emits, so
a request's log lines, its record and its trace share one id. The slot is
a contextvar: coroutines interleaved on one loop thread, and threads,
each keep their own trace identity.

Identifiers follow the W3C trace-context sizes: 32 hex chars for a trace
id, 16 for a span id.
"""

from __future__ import annotations

import contextvars
import os
from typing import Optional, Tuple

_current: contextvars.ContextVar = contextvars.ContextVar(
    "rtpu_trace_ctx", default=None)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def current() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span, or None outside any."""
    return _current.get()


def activate(trace_id, span_id):
    """Install a span as the ambient context; returns a token for
    ``deactivate``. Missing/empty ids (old-format frames) install None,
    so a mixed-version caller degrades to per-task traces, never an
    error."""
    if not trace_id or not span_id:
        return _current.set(None)
    return _current.set((str(trace_id), str(span_id)))


def deactivate(token) -> None:
    _current.reset(token)


def stamp(payload: dict) -> dict:
    """Stamp child trace-context fields onto an outgoing submit payload:
    the child joins the ambient trace (or roots a fresh one) and gets its
    own span id, which the executing worker records its span under and
    re-activates as the ambient parent for further nesting."""
    ctx = _current.get()
    if ctx is None:
        payload["trace_id"] = new_trace_id()
        payload["parent_span_id"] = ""
    else:
        payload["trace_id"] = ctx[0]
        payload["parent_span_id"] = ctx[1]
    payload["span_id"] = new_span_id()
    return payload
