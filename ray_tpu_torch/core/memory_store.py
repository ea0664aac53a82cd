"""In-process memory store for small objects and pending futures.

Role-equivalent to the reference's CoreWorkerMemoryStore (reference:
src/ray/core_worker/store_provider/memory_store/memory_store.h:43): task
returns below the inline threshold live here in the owner process; larger
values are promoted to the node's shared-memory store. Get/Wait block on
per-object events; async waiters register callbacks.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID


class _Entry:
    __slots__ = ("event", "value", "is_error", "in_shm")

    def __init__(self):
        self.event = threading.Event()
        self.value: Any = None
        self.is_error = False
        self.in_shm = False  # value lives in the shm store, not here


class MemoryStore:
    def __init__(self):
        # reentrant: the cyclic collector may run an ObjectRef's __del__
        # inside any allocation here (an _Entry in _entry), and __del__
        # frees its object with delete(), which takes this lock again on
        # the same thread; a plain Lock deadlocks there (the JAX package's
        # local mode does, in most runs of a groupby)
        self._lock = threading.RLock()
        self._entries: Dict[ObjectID, _Entry] = {}
        self._callbacks: Dict[ObjectID, List[Callable[[], None]]] = {}
        # transient any-of waiters: oid -> set of Events; registered and
        # UNREGISTERED by each wait_any call, so repeated waits over the
        # same refs never accumulate state (per-call callbacks would)
        self._any_waiters: Dict[ObjectID, set] = {}

    def _entry(self, object_id: ObjectID) -> _Entry:
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                e = _Entry()
                self._entries[object_id] = e
            return e

    def put(self, object_id: ObjectID, value: Any, is_error: bool = False) -> None:
        e = self._entry(object_id)
        e.value = value
        e.is_error = is_error
        e.event.set()
        self._fire(object_id)

    def mark_in_shm(self, object_id: ObjectID) -> None:
        e = self._entry(object_id)
        e.in_shm = True
        e.event.set()
        self._fire(object_id)

    def _fire(self, object_id: ObjectID) -> None:
        with self._lock:
            cbs = self._callbacks.pop(object_id, [])
            waiters = self._any_waiters.get(object_id)
            if waiters:
                for ev in list(waiters):
                    ev.set()
        for cb in cbs:
            try:
                cb()
            except Exception:
                pass

    def wait_any(self, object_ids, timeout: Optional[float]) -> bool:
        """Block until ANY of the ids becomes ready (or timeout). The
        primitive under ray.wait: one Event registered across the set,
        removed on exit — no per-call residue (reference:
        CoreWorkerMemoryStore::GetAsync waiter sets)."""
        ev = threading.Event()
        registered = []
        try:
            with self._lock:
                for oid in object_ids:
                    e = self._entries.get(oid)
                    if e is not None and e.event.is_set():
                        return True
                    self._any_waiters.setdefault(oid, set()).add(ev)
                    registered.append(oid)
            return ev.wait(timeout)
        finally:
            with self._lock:
                for oid in registered:
                    ws = self._any_waiters.get(oid)
                    if ws is not None:
                        ws.discard(ev)
                        if not ws:
                            del self._any_waiters[oid]

    def collect_ready(self, object_ids, limit: Optional[int] = None) -> set:
        """One-lock bulk readiness probe: the subset of ids whose entries
        are sealed, stopping after ``limit`` hits. Lets wait() test 1k
        pending refs per wakeup with one lock acquisition instead of one
        per ref — and since tasks complete roughly in submission order,
        an early-exit scan over a submission-ordered pending list usually
        finds its hit near the front (O(1) amortized per wait round)."""
        with self._lock:
            out = set()
            entries = self._entries
            for oid in object_ids:
                e = entries.get(oid)
                if e is not None and e.event.is_set():
                    out.add(oid)
                    if limit is not None and len(out) >= limit:
                        break
            return out

    def wait_ready(self, object_id: ObjectID, timeout: Optional[float]) -> bool:
        return self._entry(object_id).event.wait(timeout)

    def is_ready(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.event.is_set()

    def get_if_ready(self, object_id: ObjectID) -> Optional[Tuple[Any, bool, bool]]:
        """Returns (value, is_error, in_shm) or None if pending."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.event.is_set():
                return None
            return (e.value, e.is_error, e.in_shm)

    def add_ready_callback(self, object_id: ObjectID, cb: Callable[[], None]) -> None:
        e = self._entry(object_id)
        with self._lock:
            if e.event.is_set():
                fire_now = True
            else:
                self._callbacks.setdefault(object_id, []).append(cb)
                fire_now = False
        if fire_now:
            cb()

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._entries.pop(object_id, None)
            self._callbacks.pop(object_id, None)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._entries

    def size(self) -> int:
        with self._lock:
            return len(self._entries)
