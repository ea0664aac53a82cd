"""Serialization: cloudpickle + pickle-5 out-of-band buffers.

The JAX package's module, copied, with its one device touch point ported.
Mirrors the reference's split (reference: python/ray/_private/serialization.py):
 - metadata + pickled "in-band" bytes, plus a list of out-of-band buffers so
   large numpy arrays and torch tensors are written into the object store
   without an intermediate copy and read back zero-copy (mmap-backed views).
 - nested ObjectRefs found during pickling are recorded so the owner can track
   borrowers.
 - every ``torch.Tensor``, at any depth of the value, crosses as host memory
   and arrives as a CPU tensor of the same dtype, shape and bytes (the JAX
   package turns a ``jax.Array`` into host numpy the same way). A CUDA
   tensor is copied to the host first; its bytes ride out of band as a
   ``uint8`` buffer, and the receiver rebuilds the tensor from the bytes,
   the dtype and the shape (bf16 has no numpy dtype). A reader of a shm
   object gets a zero-copy view of the store, as the JAX package's numpy
   reads do; a read-only source (an inline value, a spill file) is copied,
   since a torch tensor cannot be read-only. This module never imports
   torch: it finds it in ``sys.modules`` (the daemons decode specs too).

Wire layout of a serialized object (the shm store stores exactly this):
    [8B header: n_buffers u32 | inband_len u32]
    [inband bytes]
    for each buffer: [8B length][raw bytes, 64B-aligned start]
"""

from __future__ import annotations

import pickle
import struct
import sys
from typing import Any, Callable, List, Optional, Tuple

import cloudpickle

_ALIGN = 64
_HEADER = struct.Struct("<II")
_BUFLEN = struct.Struct("<Q")


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class SerializedObject:
    __slots__ = ("inband", "buffers", "contained_refs")

    def __init__(self, inband: bytes, buffers: List[pickle.PickleBuffer],
                 contained_refs: list):
        self.inband = inband
        self.buffers = buffers
        self.contained_refs = contained_refs

    @property
    def total_bytes(self) -> int:
        size = _HEADER.size + len(self.inband)
        for buf in self.buffers:
            raw = buf.raw()
            size = _align(size) + _BUFLEN.size + raw.nbytes
        return size

    def write_to(self, dest: memoryview) -> int:
        """Write the wire format into `dest`; returns bytes written."""
        offset = 0
        _HEADER.pack_into(dest, offset, len(self.buffers), len(self.inband))
        offset += _HEADER.size
        dest[offset:offset + len(self.inband)] = self.inband
        offset += len(self.inband)
        for buf in self.buffers:
            raw = buf.raw()
            offset = _align(offset)
            _BUFLEN.pack_into(dest, offset, raw.nbytes)
            offset += _BUFLEN.size
            dest[offset:offset + raw.nbytes] = raw.cast("B")
            offset += raw.nbytes
        return offset

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_bytes)
        self.write_to(memoryview(out))
        return bytes(out)


class _RefTrackingPickler(cloudpickle.CloudPickler):
    """CloudPickler that records nested ObjectRefs into self.contained."""

    contained: list

    def persistent_id(self, obj):
        return None

    def reducer_override(self, obj):
        from ray_tpu_torch.core.object_ref import ObjectRef
        if isinstance(obj, ObjectRef):
            self.contained.append(obj)
            return NotImplemented
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            return _reduce_tensor(torch, obj)
        # Delegate to CloudPickler: its reducer_override is where
        # by-value pickling of local functions/lambdas/classes lives —
        # returning NotImplemented here would silently downgrade to
        # by-reference pickling, which breaks closures in task args.
        return super().reducer_override(obj)


#: exact types that plain-pickle cheaply and can never contain an ObjectRef
#: or an out-of-band buffer — the hot microbenchmark path (empty kwargs,
#: scalar args, tiny byte results) skips the CloudPickler entirely
_TRIVIAL_TYPES = frozenset(
    (type(None), bool, int, float, str, bytes, bytearray))


def serialize(value: Any) -> SerializedObject:
    t = type(value)
    if t in _TRIVIAL_TYPES or ((t is dict or t is tuple or t is list)
                               and not value):
        return SerializedObject(pickle.dumps(value, protocol=5), [], [])

    import io
    buffers: List[pickle.PickleBuffer] = []
    out = io.BytesIO()
    p = _RefTrackingPickler(out, protocol=5, buffer_callback=buffers.append)
    p.contained = []
    p.dump(value)
    return SerializedObject(out.getvalue(), buffers, p.contained)


def _reduce_tensor(torch, t):
    """Reduce a tensor to its host bytes: a strided tensor of the plain
    class (or a Parameter) as a ``uint8`` PickleBuffer (out of band under
    protocol 5) plus its dtype, shape and a leaf's grad flag (a non-leaf
    arrives detached: autograd does not cross processes); any other
    layout or subclass by torch's own reduction of its CPU copy."""
    if t.layout != torch.strided or t.is_quantized or \
            type(t) not in (torch.Tensor, torch.nn.Parameter):
        return t.detach().cpu().__reduce_ex__(5)
    host = t.detach().cpu().contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    dtype = str(host.dtype).rsplit(".", 1)[1]
    return _rebuild_tensor, (pickle.PickleBuffer(raw), dtype,
                             tuple(host.shape),
                             t.requires_grad and t.is_leaf,
                             type(t) is torch.nn.Parameter)


def _rebuild_tensor(buf, dtype: str, shape: tuple,
                    requires_grad: bool = False,
                    parameter: bool = False):
    """A CPU tensor over ``buf``'s bytes: a view of a writable buffer
    (zero copy: a shm object stays pinned while the tensor lives), a copy
    of a read-only one."""
    import torch
    mv = memoryview(buf).cast("B")
    if mv.nbytes == 0:
        flat = torch.empty(0, dtype=torch.uint8)
    else:
        flat = torch.frombuffer(bytearray(mv) if mv.readonly else mv,
                                dtype=torch.uint8)
    t = flat.view(getattr(torch, dtype)).reshape(shape)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def deserialize(data, position: int = 0) -> Any:
    """Deserialize from a bytes-like (possibly an mmap view — zero copy).

    Buffers are returned as memoryviews into `data`, so numpy arrays
    reconstructed by pickle alias the store memory (reference behavior:
    zero-copy numpy reads from plasma).
    """
    view = memoryview(data)
    n_buffers, inband_len = _HEADER.unpack_from(view, position)
    offset = position + _HEADER.size
    inband = view[offset:offset + inband_len]
    offset += inband_len
    bufs = []
    for _ in range(n_buffers):
        offset = _align(offset)
        (blen,) = _BUFLEN.unpack_from(view, offset)
        offset += _BUFLEN.size
        bufs.append(view[offset:offset + blen])
        offset += blen
    return pickle.loads(inband, buffers=bufs)


# ---------------------------------------------------------------------------
# Error payloads: stored objects can carry an exception instead of a value.
# Metadata byte 0 distinguishes (0 = value, 1 = error pickled in-band).

META_VALUE = 0
META_ERROR = 1


def serialize_error(exc: BaseException) -> SerializedObject:
    from ray_tpu_torch.exceptions import TaskError
    if not isinstance(exc, TaskError):
        exc = TaskError.from_exception(exc)
    try:
        return serialize(exc)
    except Exception:
        return serialize(TaskError(type(exc).__name__, repr(exc), "<unpicklable>"))
