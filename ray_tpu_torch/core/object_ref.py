"""ObjectRef — the distributed future handle.

Owner-centric futures (reference: the ownership model in
src/ray/core_worker/reference_count.h:66 and the NSDI'21 Ownership design):
every ref records the worker that created it (the *owner*). The owner holds
the authoritative value/metadata; any process holding the ref resolves it by
asking the owner (or the shared-memory store directly for sealed objects).

Refs are pickle-serializable; serialization registers a borrow with the local
ref-counter so distributed GC stays correct (see core/refcount.py).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ray_tpu_torch.core.ids import ObjectID, WorkerID

if TYPE_CHECKING:
    pass


class ObjectRef:
    __slots__ = ("_id", "_owner", "_weakly_referenced")

    def __init__(self, object_id: ObjectID, owner: Optional[WorkerID] = None,
                 _register: bool = True):
        self._id = object_id
        self._owner = owner or WorkerID.nil()
        self._weakly_referenced = not _register
        if _register:
            _get_refcounter_add()(object_id)

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def owner_id(self) -> WorkerID:
        return self._owner

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch.core.worker import global_worker
        return global_worker.as_future(self)

    def __await__(self):
        from ray_tpu_torch.core.worker import global_worker
        return global_worker.as_asyncio_future(self).__await__()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        # Serializing a ref hands it to another process: count a borrow.
        _get_refcounter_borrow()(self._id)
        return (_deserialize_ref, (self._id.binary(), self._owner.binary()))

    def __del__(self):
        if not self._weakly_referenced:
            try:
                _get_refcounter_remove()(self._id)
            except Exception:
                pass


def _deserialize_ref(id_binary: bytes, owner_binary: bytes) -> "ObjectRef":
    ref = ObjectRef(ObjectID(id_binary), WorkerID(owner_binary))
    # Receiving a ref from another process makes this process a borrower;
    # cluster mode wires this to an add_borrower RPC to the owner
    # (reference: ReferenceCounter borrower registration,
    # src/ray/core_worker/reference_count.h:66).
    _deserialized_hook(ref)
    return ref


# Indirection so ObjectRef stays importable before a worker exists; the worker
# installs real callbacks at connect time.
def _noop(_id):
    return None


_refcounter_add = _noop
_refcounter_remove = _noop
_refcounter_borrow = _noop
_deserialized_hook = _noop


def install_refcount_hooks(add, remove, borrow, deserialized=None) -> None:
    global _refcounter_add, _refcounter_remove, _refcounter_borrow
    global _deserialized_hook
    _refcounter_add = add
    _refcounter_remove = remove
    _refcounter_borrow = borrow
    _deserialized_hook = deserialized or _noop


def _get_refcounter_add():
    return _refcounter_add


def _get_refcounter_remove():
    return _refcounter_remove


def _get_refcounter_borrow():
    return _refcounter_borrow
