"""Topic pub/sub broker hosted by the head.

Role-equivalent to the reference's GCS-side pub/sub (reference:
src/ray/pubsub/publisher.h:297 `Publisher`, subscriber.h long-poll
protocol): publishers push messages to named topics; subscribers
LONG-POLL with per-topic cursors and are woken as soon as anything new
arrives. The reference dedicates this machinery to internal channels
(object eviction, ref removal, logs, errors); here the same broker also
backs a user-facing topic API (`ray_tpu_torch.util.pubsub`) and the head's
cluster-event feed.

Design notes:
- Per-topic ring buffers (drop-oldest) bound memory under slow or dead
  subscribers — a cursor that fell off the ring resumes at the oldest
  retained message and the gap is reported, mirroring the reference's
  max-buffer publisher semantics.
- Cursors live with the SUBSCRIBER (client-side), not the broker, so the
  broker holds no per-subscriber state to leak when clients vanish; the
  long-poll wait is the only per-call state.
- Poll replies carry the broker ``epoch`` (the head incarnation): after
  a head restart sequence numbers restart at zero, and a subscriber
  holding old-incarnation cursors would otherwise stall silently (high
  stale cursor) or skip messages (low stale cursor). Epoch change tells
  the client to reset cursors.
- Blocking waits are capped by a slot semaphore: the broker shares the
  head's RPC thread pool, and unbounded 2s parks could pin every handler
  thread (the head-pool starvation hazard cluster_backend.py documents).
  Polls past the cap degrade to an immediate scan; the client just
  re-polls.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Tuple

#: server-side cap on one long-poll wait; clients re-poll in a loop, so
#: this bounds how long a poll occupies an RPC worker thread
MAX_POLL_WAIT_S = 2.0
#: at most this many polls may BLOCK concurrently (excess polls return
#: their scan immediately); keeps long-polls from starving the head pool
MAX_BLOCKED_POLLS = 8
DEFAULT_BUFFER = 1000


class PubsubBroker:
    def __init__(self, max_buffer: int = DEFAULT_BUFFER, epoch: int = 0):
        self._max = max_buffer
        self.epoch = epoch
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._wait_slots = threading.BoundedSemaphore(MAX_BLOCKED_POLLS)
        # topic -> deque[(seq, message)]; seq is 1-based and per-topic
        self._topics: Dict[str, collections.deque] = {}
        self._seq: Dict[str, int] = {}

    def publish(self, topic: str, message: Any) -> int:
        """Append to the topic ring; returns the message's sequence no."""
        with self._cv:
            buf = self._topics.get(topic)
            if buf is None:
                buf = collections.deque(maxlen=self._max)
                self._topics[topic] = buf
            seq = self._seq.get(topic, 0) + 1
            self._seq[topic] = seq
            buf.append((seq, message))
            self._cv.notify_all()
            return seq

    def _scan(self, cursors: Dict[str, int]) -> Dict[str, Any]:
        """Collect news per topic. Caller holds the lock. The per-topic
        seq check makes no-op wakeups O(topics) dict lookups, not
        O(ring) rescans (publish notify_all wakes every waiter)."""
        out: Dict[str, Any] = {}
        for topic, cursor in cursors.items():
            if self._seq.get(topic, 0) <= cursor:
                continue
            buf = self._topics.get(topic)
            if not buf:
                continue
            oldest = buf[0][0]
            dropped = max(0, oldest - int(cursor) - 1)
            msgs = [m for s, m in buf if s > cursor]
            if msgs or dropped:
                out[topic] = {"messages": msgs,
                              "cursor": self._seq[topic],
                              "dropped": dropped}
        return out

    def poll(self, cursors: Dict[str, int],
             timeout_s: float) -> Dict[str, Any]:
        """Messages with seq > cursor for each subscribed topic, blocking
        up to ``timeout_s`` (clamped) until at least one arrives.

        Returns {"epoch": E, "topics": {topic: {"messages": [...],
        "cursor": int, "dropped": n}}} — topics empty on timeout."""
        deadline = time.monotonic() + max(0.0, min(timeout_s,
                                                   MAX_POLL_WAIT_S))
        may_block = self._wait_slots.acquire(blocking=False)
        try:
            with self._cv:
                while True:
                    out = self._scan(cursors)
                    if out:
                        return {"epoch": self.epoch, "topics": out}
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not may_block:
                        return {"epoch": self.epoch, "topics": {}}
                    self._cv.wait(timeout=remaining)
        finally:
            if may_block:
                self._wait_slots.release()

    def topics(self) -> Dict[str, Any]:
        with self._lock:
            return {"epoch": self.epoch,
                    "topics": [(t, self._seq.get(t, 0))
                               for t in self._topics]}
