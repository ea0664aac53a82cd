"""Owner-based distributed reference counting.

Protocol distilled from the reference's ReferenceCounter (reference:
src/ray/core_worker/reference_count.h:66):
 - every object has exactly one owner (the worker that created it);
 - each process tracks *local* refs (ObjectRef instances alive in that
   process) and *submitted-task* refs (the object is an argument of an
   in-flight task);
 - a process that receives a ref from elsewhere is a *borrower*; the owner is
   told (borrow/unborrow messages) and keeps the object alive until all
   borrowers drop;
 - when an owned object's total count reaches zero, the owner frees the
   value (memory store entry and/or shm primary pin + delete) and — if
   lineage is enabled — may drop the creating task's spec.

This module is transport-agnostic: the worker injects `notify_owner` /
`free_object` callables at connect time.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set

from ray_tpu_torch.core.ids import ObjectID, WorkerID


class _Count:
    __slots__ = ("local", "submitted", "borrowers", "owned")

    def __init__(self, owned: bool):
        self.local = 0
        self.submitted = 0
        self.borrowers: Set[bytes] = set()
        self.owned = owned

    @property
    def total(self) -> int:
        return self.local + self.submitted + len(self.borrowers)


class ReferenceCounter:
    def __init__(self):
        self._lock = threading.RLock()
        self._counts: Dict[ObjectID, _Count] = {}
        # injected by the worker at connect time
        self.free_object: Callable[[ObjectID], None] = lambda _oid: None
        self.notify_owner_borrow: Callable[[ObjectID], None] = lambda _oid: None
        self.notify_owner_unborrow: Callable[[ObjectID], None] = lambda _oid: None

    # -- called by ObjectRef lifecycle hooks --

    def add_local(self, object_id: ObjectID, owned: Optional[bool] = None) -> None:
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                c = _Count(owned=bool(owned))
                self._counts[object_id] = c
            elif owned is not None:
                c.owned = owned
            c.local += 1

    def remove_local(self, object_id: ObjectID) -> None:
        to_free = None
        notify = None
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                return
            c.local -= 1
            if c.local <= 0 and c.submitted <= 0:
                if c.owned:
                    if len(c.borrowers) == 0:
                        to_free = object_id
                        del self._counts[object_id]
                else:
                    notify = object_id
                    del self._counts[object_id]
        if to_free is not None:
            self.free_object(to_free)
        if notify is not None:
            self.notify_owner_unborrow(notify)

    def on_ref_serialized(self, object_id: ObjectID) -> None:
        """A ref is being shipped elsewhere — pin until the peer reports in.

        We conservatively count an extra 'submitted' ref; the receiving
        process's borrow registration (owner side) supersedes it when the
        task completes.
        """
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                c = _Count(owned=False)
                self._counts[object_id] = c
            c.submitted += 1

    def on_serialized_ref_done(self, object_id: ObjectID) -> None:
        to_free = None
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                return
            c.submitted -= 1
            if c.total <= 0:
                if c.owned:
                    to_free = object_id
                del self._counts[object_id]
        if to_free is not None:
            self.free_object(to_free)

    def on_ref_deserialized(self, object_id: ObjectID) -> None:
        """This process received a ref from elsewhere: register as borrower."""
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                self._counts[object_id] = _Count(owned=False)
        self.notify_owner_borrow(object_id)

    # -- owner side: borrower registry (driven by RPC) --

    def add_borrower(self, object_id: ObjectID, borrower: bytes) -> None:
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                c = _Count(owned=True)
                self._counts[object_id] = c
            c.borrowers.add(borrower)

    def remove_borrower(self, object_id: ObjectID, borrower: bytes) -> None:
        to_free = None
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                return
            c.borrowers.discard(borrower)
            if c.total <= 0 and c.owned:
                to_free = object_id
                del self._counts[object_id]
        if to_free is not None:
            self.free_object(to_free)

    def mark_owned(self, object_id: ObjectID) -> None:
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                c = _Count(owned=True)
                self._counts[object_id] = c
            c.owned = True

    def untrack(self, object_id: ObjectID) -> None:
        """Forget an owned object that never got a live ObjectRef (e.g. an
        unconsumed streamed item being cleaned up) — without this the
        mark_owned entry lingers forever since no ref removal will fire."""
        with self._lock:
            self._counts.pop(object_id, None)

    def is_tracked(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._counts

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._counts)

    def counts_for(self, object_id: ObjectID) -> "Optional[dict]":
        """Per-object pin counts for the accounting directory, or None if
        this process doesn't track the object (e.g. a worker that sealed
        a return value owned by the submitter)."""
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                return None
            return {"local": c.local, "submitted": c.submitted,
                    "borrowers": len(c.borrowers), "owned": c.owned}

    def snapshot(self, limit: "Optional[int]" = None) -> dict:
        """Debug/telemetry view of the count table; ``limit`` bounds the
        under-lock work for large tables (telemetry samples)."""
        import itertools
        with self._lock:
            items = self._counts.items()
            if limit is not None:
                items = itertools.islice(items, limit)
            return {
                oid.hex(): {
                    "local": c.local,
                    "submitted": c.submitted,
                    "borrowers": len(c.borrowers),
                    "owned": c.owned,
                }
                for oid, c in items
            }
