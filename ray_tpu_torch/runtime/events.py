"""Task event buffer — per-task state transitions for the timeline.

Role-equivalent to the reference's TaskEventBuffer → GcsTaskManager path
(reference: src/ray/core_worker/task_event_buffer.h batching to
gcs_task_manager.h:88, surfaced as the dashboard timeline and
`ray timeline`): workers buffer (task, start, end) spans and the telemetry
thread flushes them to the head alongside metric snapshots; the CLI
exports Chrome-trace JSON.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List


class TaskEventBuffer:
    MAX_BUFFER = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = collections.deque()
        self._dropped = 0

    def record(self, *, name: str, task_id: str, kind: str,
               start: float, end: float, ok: bool, **extra: Any) -> None:
        """Record one span. ``extra`` carries optional fields — notably
        the trace context trio (trace_id/span_id/parent_span_id) the OTLP
        exporter links spans by; falsy values are dropped so old-format
        events keep their exact seed shape.

        The buffer is a ring: at MAX_BUFFER the OLDEST span is evicted so
        a busy flush interval keeps its newest events (refusing the new
        span instead would freeze the timeline at the interval's first
        4096 spans); the ``__dropped__`` meta marker reports the exact
        eviction count."""
        with self._lock:
            if len(self._events) >= self.MAX_BUFFER:
                self._events.popleft()
                self._dropped += 1
            e = {"name": name, "task_id": task_id, "kind": kind,
                 "start": start, "end": end, "ok": ok}
            for k, v in extra.items():
                if v:
                    e[k] = v
            self._events.append(e)

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._events = list(self._events), collections.deque()
            if self._dropped:
                out.append({"name": "__dropped__", "task_id": "",
                            "kind": "meta", "start": time.time(),
                            "end": time.time(), "ok": False,
                            "dropped": self._dropped})
                self._dropped = 0
            return out


def to_chrome_trace(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Chrome-trace 'X' (complete) events; load in chrome://tracing or
    Perfetto (reference: `ray timeline` output format)."""
    trace = []
    for e in events:
        trace.append({
            "name": e["name"],
            "cat": e.get("kind", "task"),
            "ph": "X",
            "ts": e["start"] * 1e6,
            "dur": max(e["end"] - e["start"], 0.0) * 1e6,
            "pid": e.get("node", "node"),
            "tid": e.get("worker", "worker"),
            "args": {"task_id": e.get("task_id", ""), "ok": e.get("ok")},
        })
    return trace


# ----------------------------------------------------------------------
# multi-plane Perfetto export — every observability plane as a named
# lane on ONE wall clock. All source timestamps are already epoch
# seconds (task spans carry start/end, compile records ts+duration,
# request records a t0_wall anchor plus relative offsets, journal
# entries ts), so interleaving is pure bookkeeping: stable integer
# pids/tids with 'M'-phase process_name/thread_name metadata.

_LANE_SPANS = 1        # task/actor/scheduler spans (pid per node)
_LANE_TRAIN = 2001     # train step + phase spans
_LANE_REQUESTS = 2002  # LLM request token timelines
_LANE_COMPILES = 2003  # XLA compile events
_LANE_JOURNAL = 2004   # cluster journal markers (instants)

_TRAIN_KINDS = ("train_step", "train_phase")


class _Tids:
    """Stable small thread ids per lane with thread_name metadata."""

    def __init__(self, trace: List[Dict[str, Any]], pid: int):
        self.trace = trace
        self.pid = pid
        self._ids: Dict[str, int] = {}

    def get(self, name: str) -> int:
        tid = self._ids.get(name)
        if tid is None:
            tid = len(self._ids) + 1
            self._ids[name] = tid
            self.trace.append({"ph": "M", "pid": self.pid, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": name or "?"}})
        return tid


def _lane(trace: List[Dict[str, Any]], pid: int, name: str) -> _Tids:
    trace.append({"ph": "M", "pid": pid, "name": "process_name",
                  "args": {"name": name}})
    return _Tids(trace, pid)


def to_perfetto(events: List[Dict[str, Any]],
                compiles: List[Dict[str, Any]] = None,
                requests: List[Dict[str, Any]] = None,
                journal: List[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One Perfetto/Chrome trace interleaving every plane: task-span
    trees (one pid per node), train step/phase times, LLM request token
    timelines (queue wait, first token, decode window), XLA compile
    events (one tid per process, recompiles carrying their signature
    diff), and cluster-journal markers as global instants. Returns the
    JSON-object trace format (``{"traceEvents": [...]}``) — the answer
    to "what was the whole cluster doing during this stall" in a single
    ``trace --perfetto out.json`` file."""
    trace: List[Dict[str, Any]] = []
    node_pids: Dict[str, int] = {}
    node_tids: Dict[str, _Tids] = {}
    train = _lane(trace, _LANE_TRAIN, "train: steps + phases")

    for e in events or []:
        if e.get("name") == "__dropped__":
            continue
        kind = e.get("kind", "task")
        start = float(e.get("start") or 0.0)
        dur = max(float(e.get("end") or 0.0) - start, 0.0)
        ev = {"name": e.get("name", "?"), "cat": kind, "ph": "X",
              "ts": start * 1e6, "dur": dur * 1e6,
              "args": {"task_id": e.get("task_id", ""),
                       "ok": e.get("ok")}}
        if e.get("trace_id"):
            ev["args"]["trace_id"] = e["trace_id"]
        if kind in _TRAIN_KINDS:
            ev["pid"] = _LANE_TRAIN
            ev["tid"] = train.get(
                "phases" if kind == "train_phase" else "steps")
        else:
            node = str(e.get("node", "") or "node")[:12]
            pid = node_pids.get(node)
            if pid is None:
                pid = _LANE_SPANS + len(node_pids)
                node_pids[node] = pid
                node_tids[node] = _lane(trace, pid,
                                        f"spans: node {node}")
            ev["pid"] = pid
            ev["tid"] = node_tids[node].get(
                str(e.get("worker", "") or "worker")[:12])
        trace.append(ev)

    if requests:
        lane = _lane(trace, _LANE_REQUESTS, "llm: requests")
        for r in requests:
            if not isinstance(r, dict) or not r.get("t0_wall"):
                continue
            t0 = float(r["t0_wall"])
            rid = str(r.get("rid", "?"))
            tid = lane.get(f"req {rid[:12]}")
            admits = r.get("admits") or []
            ttft = r.get("ttft")
            e2e = r.get("e2e") or r.get("age") or ttft or 0.0
            trace.append({
                "name": f"request {rid[:12]}", "cat": "llm_request",
                "ph": "X", "ts": t0 * 1e6,
                "dur": max(float(e2e), 0.0) * 1e6,
                "pid": _LANE_REQUESTS, "tid": tid,
                "args": {"trace_id": r.get("trace_id", ""),
                         "prompt_tokens": r.get("prompt_tokens"),
                         "generated": r.get("n_generated"),
                         "finish": r.get("finish_reason", ""),
                         "worker": r.get("worker", "")}})
            if admits:
                trace.append({
                    "name": "queue_wait", "cat": "llm_request",
                    "ph": "X", "ts": t0 * 1e6,
                    "dur": max(float(admits[0][0]), 0.0) * 1e6,
                    "pid": _LANE_REQUESTS, "tid": tid, "args": {}})
            if ttft is not None:
                trace.append({
                    "name": "first_token", "cat": "llm_request",
                    "ph": "i", "s": "t",
                    "ts": (t0 + float(ttft)) * 1e6,
                    "pid": _LANE_REQUESTS, "tid": tid, "args": {}})

    if compiles:
        lane = _lane(trace, _LANE_COMPILES, "xla: compiles")
        for c in compiles:
            if not isinstance(c, dict):
                continue
            end = float(c.get("ts") or 0.0)
            dur = float(c.get("duration_s") or
                        c.get("measured_s") or 0.0)
            proc = str(c.get("worker", "") or c.get("pid", "") or "?")
            name = c.get("name") or "<unattributed>"
            if c.get("recompile"):
                name = f"RECOMPILE {name}"
            trace.append({
                "name": name, "cat": "xla_compile", "ph": "X",
                "ts": max(end - dur, 0.0) * 1e6, "dur": dur * 1e6,
                "pid": _LANE_COMPILES, "tid": lane.get(str(proc)[:12]),
                "args": {"signature": c.get("signature"),
                         "diff": c.get("diff"),
                         "fingerprint": c.get("fingerprint", ""),
                         "kind": c.get("kind", ""),
                         "backend": c.get("backend", ""),
                         "trace_id": c.get("trace_id", "")}})

    if journal:
        lane = _lane(trace, _LANE_JOURNAL, "journal: cluster events")
        tid = lane.get("events")
        for j in journal:
            if not isinstance(j, dict) or not j.get("ts"):
                continue
            trace.append({
                "name": j.get("type", "event"), "cat": "journal",
                "ph": "i", "s": "g", "ts": float(j["ts"]) * 1e6,
                "pid": _LANE_JOURNAL, "tid": tid,
                "args": {k: v for k, v in j.items()
                         if k not in ("ts",) and
                         isinstance(v, (str, int, float, bool))}})

    return {"traceEvents": trace, "displayTimeUnit": "ms"}
