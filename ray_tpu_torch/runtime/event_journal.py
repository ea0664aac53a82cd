"""Cluster event journal — structured, ordered control-plane history.

Role-equivalent to the reference's GCS-side cluster-event log (reference:
src/ray/gcs/gcs_server/gcs_task_manager buffering task/worker failure
events, surfaced as `ray list cluster-events` via python/ray/util/state):
every significant cluster transition — node register/death, worker death
with its exit cause, actor restart/evict, object spill overflow, FastLease
grant failure, autoscaler decisions — lands here as ONE structured record.

Two properties the debugging workflows lean on:

* **Monotonic order.** ``seq`` is assigned under the journal lock at head
  arrival, so a dump is totally ordered even when events originate on
  different nodes (worker-side spill events ride ``telemetry_push`` and are
  sequenced when they land, like the reference's GCS arrival order). A
  follow cursor (``after_seq``) therefore never skips or repeats.
* **Trace cross-links.** Events are stamped with the ambient trace id when
  one exists (or the id the reporter carried), so `python -m ray_tpu_torch trace`
  and the journal can be joined on ``trace_id`` — e.g. a worker-death event
  and the actor-restart it caused share one id.

The ring is bounded (``cluster_event_journal_size``); ``stats()`` reports
both the total ever recorded and the kept window so consumers can tell
when history has been evicted.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List

from ray_tpu_torch.util import trace_context


class ClusterEventJournal:
    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(2, int(capacity)))
        self._seq = 0

    def record(self, type: str, trace_id: str = "",
               **fields: Any) -> Dict[str, Any]:
        """Append one event and return the stored record.

        ``seq``/``ts`` are assigned under the lock (head arrival time), so
        dumps are gap-free and monotonic; ``fields`` cannot override them.
        An empty ``trace_id`` picks up the ambient trace if one is active
        at the recording site.
        """
        if not trace_id:
            ctx = trace_context.current()
            if ctx is not None:
                trace_id = ctx[0]
        ev: Dict[str, Any] = {
            k: v for k, v in fields.items()
            if v is not None and k not in ("seq", "ts")}
        ev["type"] = str(type)
        ev["trace_id"] = trace_id
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            ev["ts"] = time.time()
            self._ring.append(ev)
        return ev

    def dump(self, after_seq: int = 0, type: str = "",
             limit: int = 0) -> List[Dict[str, Any]]:
        """Events with seq > after_seq, oldest first, optionally filtered
        by exact type; ``limit`` keeps the NEWEST n of the selection (the
        tail is what a bounded `events` render wants)."""
        with self._lock:
            out = [dict(e) for e in self._ring
                   if e["seq"] > after_seq and (not type or e["type"] == type)]
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"recorded": self._seq, "kept": len(self._ring)}
