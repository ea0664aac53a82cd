"""ctypes bindings over the C++ runtime library.

Two components surface here:
 - ShmStore: per-node shared-memory object store (src/shm_store.cc; role of
   the reference's plasma store, src/ray/object_manager/plasma/store.h:55).
 - ClusterState: resource scheduler (src/scheduler.cc; role of the
   reference's ClusterResourceScheduler,
   src/ray/raylet/scheduling/cluster_resource_scheduler.h:44).
"""

from __future__ import annotations

import ctypes
import struct
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._native.build import build as _build_native

_lib = None

FIXED_POINT_UNIT = 10000

# error codes (mirror shm_store.cc)
OK = 0
ERR_EXISTS = -1
ERR_FULL = -2
ERR_NOT_FOUND = -3
ERR_NOT_SEALED = -4
ERR_TABLE_FULL = -5
ERR_SYS = -6
ERR_PINNED = -7


class _StoreStats(ctypes.Structure):
    _fields_ = [
        ("capacity", ctypes.c_uint64),
        ("bytes_used", ctypes.c_uint64),
        ("num_objects", ctypes.c_uint64),
        ("total_created", ctypes.c_uint64),
        ("total_evicted", ctypes.c_uint64),
        ("total_deleted", ctypes.c_uint64),
        ("eviction_bytes", ctypes.c_uint64),
    ]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _build_native()
    lib = ctypes.CDLL(path)
    # store
    lib.rtpu_store_create.restype = ctypes.c_void_p
    lib.rtpu_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.rtpu_store_attach.restype = ctypes.c_void_p
    lib.rtpu_store_attach.argtypes = [ctypes.c_char_p]
    lib.rtpu_store_close.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_unlink.argtypes = [ctypes.c_char_p]
    lib.rtpu_store_create_object.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.rtpu_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64)]
    lib.rtpu_store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(_StoreStats)]
    # scheduler
    lib.rtpu_cluster_new.restype = ctypes.c_void_p
    lib.rtpu_cluster_free.argtypes = [ctypes.c_void_p]
    lib.rtpu_cluster_set_spread_threshold.argtypes = [ctypes.c_void_p, ctypes.c_float]
    lib.rtpu_cluster_add_node.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.rtpu_cluster_remove_node.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_cluster_update_available.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.rtpu_cluster_acquire.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.rtpu_cluster_release.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.rtpu_cluster_schedule.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
    lib.rtpu_cluster_schedule_bundles.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_char_p]
    lib.rtpu_cluster_num_nodes.restype = ctypes.c_uint32
    lib.rtpu_cluster_num_nodes.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _release_pin(store: "ShmStore", key: bytes) -> None:
    """weakref.finalize target for guarded get() views. After close() has
    drained the guard table (releasing the pins itself), or at interpreter
    shutdown, this is a no-op."""
    try:
        # decrement AND release under one lock: close() closes/nulls _h
        # under the same lock, so the handle can't be freed between the
        # check and the ctypes call (advisor r2: null/dangling handle
        # passed to rtpu_store_release during the shutdown window)
        with store._guard_lock:
            n = store._guarded.get(key, 0)
            if n <= 0:
                return  # already drained by close()
            if n == 1:
                store._guarded.pop(key)
            else:
                store._guarded[key] = n - 1
            if store._h:
                store._lib.rtpu_store_release(store._h, key)
    except Exception:  # noqa: BLE001 — finalizers must never raise
        pass


class ObjectStoreFull(Exception):
    pass


class ObjectExists(Exception):
    pass


class ShmStore:
    """Zero-copy shared-memory object store client."""

    def __init__(self, handle: int, name: str, owner: bool):
        self._h = handle
        self.name = name
        self._owner = owner
        self._lib = _load()
        # outstanding guarded-get pins (key -> count): drained by close()
        # so a process exiting with live views doesn't leak shared
        # pin_counts in the arena (which would make delete_pending objects
        # unreclaimable for the node's lifetime)
        self._guard_lock = threading.Lock()
        self._guarded: Dict[bytes, int] = {}

    @classmethod
    def create(cls, name: str, capacity: int, slots: int = 1 << 16) -> "ShmStore":
        lib = _load()
        h = lib.rtpu_store_create(name.encode(), capacity, slots)
        if not h:
            raise OSError(f"failed to create shm store {name}")
        return cls(h, name, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmStore":
        lib = _load()
        h = lib.rtpu_store_attach(name.encode())
        if not h:
            raise OSError(f"failed to attach shm store {name}")
        return cls(h, name, owner=False)

    def create_object(self, object_id: bytes, size: int) -> memoryview:
        """Allocate a writable buffer; call seal() when done writing."""
        ptr = ctypes.c_void_p()
        rc = self._lib.rtpu_store_create_object(self._h, object_id, size,
                                                ctypes.byref(ptr))
        if rc == ERR_EXISTS:
            raise ObjectExists(object_id.hex())
        if rc == ERR_FULL or rc == ERR_TABLE_FULL:
            raise ObjectStoreFull(f"object store full creating {size} bytes")
        if rc != OK:
            raise OSError(f"create_object failed rc={rc}")
        return (ctypes.c_char * size).from_address(ptr.value)

    def seal(self, object_id: bytes) -> None:
        rc = self._lib.rtpu_store_seal(self._h, object_id)
        if rc != OK:
            raise OSError(f"seal failed rc={rc}")

    def put(self, object_id: bytes, data: bytes) -> None:
        buf = self.create_object(object_id, len(data))
        memoryview(buf).cast("B")[:] = data
        self.seal(object_id)

    def get(self, object_id: bytes, guard: bool = False) -> Optional[memoryview]:
        """Return a pinned zero-copy view, or None if absent/unsealed.

        ``guard=False``: caller must release() when done (byte-copy paths
        that read and immediately drop the view).

        ``guard=True``: the pin is released automatically when the LAST
        derived view dies. Every memoryview/numpy array sliced out of the
        returned view keeps the underlying ctypes exporter alive through
        the buffer protocol, so a weakref finalizer on the exporter fires
        exactly when no live Python object can still alias the arena
        memory. Without this, freeing the ObjectRef while zero-copy reads
        were still referenced let the arena reuse the region under them
        (reference equivalent: plasma buffers keep a client pin until the
        PlasmaBuffer is destructed).
        """
        h = self._h
        if not h:
            return None
        ptr = ctypes.c_void_p()
        size = ctypes.c_uint64()
        rc = self._lib.rtpu_store_get(h, object_id, ctypes.byref(ptr),
                                      ctypes.byref(size))
        if rc in (ERR_NOT_FOUND, ERR_NOT_SEALED):
            return None
        if rc != OK:
            raise OSError(f"get failed rc={rc}")
        arr = (ctypes.c_char * size.value).from_address(ptr.value)
        if guard:
            key = bytes(object_id)
            with self._guard_lock:
                self._guarded[key] = self._guarded.get(key, 0) + 1
            weakref.finalize(arr, _release_pin, self, key)
        return memoryview(arr).cast("B")

    def release(self, object_id: bytes) -> None:
        h = self._h  # snapshot: background threads may race close()
        if h:
            self._lib.rtpu_store_release(h, object_id)

    def contains(self, object_id: bytes) -> bool:
        # Snapshot the handle: fetch/resolve threads poll contains() and can
        # race shutdown's close(); a null handle must read as "absent", not
        # a native-deref crash.
        h = self._h
        return bool(h) and bool(self._lib.rtpu_store_contains(h, object_id))

    def delete(self, object_id: bytes) -> bool:
        h = self._h
        return bool(h) and self._lib.rtpu_store_delete(h, object_id) == OK

    def stats(self) -> dict:
        h = self._h
        if not h:
            return {}
        st = _StoreStats()
        self._lib.rtpu_store_stats(h, ctypes.byref(st))
        return {f[0]: getattr(st, f[0]) for f in _StoreStats._fields_}

    def close(self) -> None:
        # Drain outstanding guarded pins first: live views become
        # dangling (the caller is shutting down), but the shared arena
        # must see the pin_counts drop or delete_pending objects leak
        # until the node restarts. Drain + close + null all happen under
        # _guard_lock so a concurrent finalizer (which releases under the
        # same lock) can never use the handle after it is freed.
        with self._guard_lock:
            if not self._h:
                return
            drained, self._guarded = dict(self._guarded), {}
            for key, n in drained.items():
                for _ in range(n):
                    try:
                        self._lib.rtpu_store_release(self._h, key)
                    except Exception:  # noqa: BLE001
                        break
            self._lib.rtpu_store_close(self._h)
            self._h = None

    def unlink(self) -> None:
        _load().rtpu_store_unlink(self.name.encode())


def encode_resources(resources: Dict[str, float]) -> bytes:
    """Pack a resource dict into the scheduler wire format."""
    parts = [struct.pack("<I", len(resources))]
    for name, amount in resources.items():
        nb = name.encode()
        parts.append(struct.pack("<I", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<q", int(round(amount * FIXED_POINT_UNIT))))
    return b"".join(parts)


POLICY_HYBRID = 0
POLICY_SPREAD = 1
POLICY_RANDOM = 2
POLICY_NODE_AFFINITY = 3

STRATEGY_PACK = 0
STRATEGY_SPREAD = 1
STRATEGY_STRICT_PACK = 2
STRATEGY_STRICT_SPREAD = 3

_STRATEGY_BY_NAME = {
    "PACK": STRATEGY_PACK,
    "SPREAD": STRATEGY_SPREAD,
    "STRICT_PACK": STRATEGY_STRICT_PACK,
    "STRICT_SPREAD": STRATEGY_STRICT_SPREAD,
}


class ClusterState:
    """Resource bookkeeping + scheduling decisions (C++ backed)."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.rtpu_cluster_new()

    def __del__(self):
        try:
            if self._h:
                self._lib.rtpu_cluster_free(self._h)
        except Exception:
            pass

    def set_spread_threshold(self, t: float) -> None:
        self._lib.rtpu_cluster_set_spread_threshold(self._h, t)

    def add_node(self, node_id: str, resources: Dict[str, float]) -> None:
        enc = encode_resources(resources)
        rc = self._lib.rtpu_cluster_add_node(self._h, node_id.encode(), enc, len(enc))
        if rc != 0:
            raise ValueError(f"node {node_id} already present")

    def remove_node(self, node_id: str) -> None:
        self._lib.rtpu_cluster_remove_node(self._h, node_id.encode())

    def update_available(self, node_id: str, resources: Dict[str, float]) -> None:
        enc = encode_resources(resources)
        self._lib.rtpu_cluster_update_available(self._h, node_id.encode(), enc, len(enc))

    def acquire(self, node_id: str, resources: Dict[str, float]) -> bool:
        enc = encode_resources(resources)
        return self._lib.rtpu_cluster_acquire(self._h, node_id.encode(), enc, len(enc)) == 0

    def release(self, node_id: str, resources: Dict[str, float]) -> None:
        enc = encode_resources(resources)
        self._lib.rtpu_cluster_release(self._h, node_id.encode(), enc, len(enc))

    def schedule(self, resources: Dict[str, float], policy: int = POLICY_HYBRID,
                 affinity_node: str = "", soft: bool = False) -> Optional[str]:
        enc = encode_resources(resources)
        out = ctypes.create_string_buffer(64)
        rc = self._lib.rtpu_cluster_schedule(
            self._h, enc, len(enc), policy, affinity_node.encode(),
            1 if soft else 0, out)
        if rc != 0:
            return None
        return out.value.decode()

    def schedule_bundles(self, bundles: Sequence[Dict[str, float]],
                         strategy: str = "PACK") -> Optional[List[str]]:
        """All-or-nothing placement of bundle resource shapes.

        On success resources are acquired; caller releases per-bundle later.
        """
        parts = []
        for b in bundles:
            enc = encode_resources(b)
            parts.append(struct.pack("<Q", len(enc)))
            parts.append(enc)
        payload = b"".join(parts)
        out = ctypes.create_string_buffer(64 * len(bundles))
        rc = self._lib.rtpu_cluster_schedule_bundles(
            self._h, payload, len(payload), len(bundles),
            _STRATEGY_BY_NAME[strategy], out)
        if rc != 0:
            return None
        return [out[i * 64:(i + 1) * 64].split(b"\x00")[0].decode()
                for i in range(len(bundles))]

    def num_nodes(self) -> int:
        return self._lib.rtpu_cluster_num_nodes(self._h)
