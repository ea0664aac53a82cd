"""Ragged paged-KV attention — the PyTorch port of the ragged half of
``ray_tpu/ops/paged_attention.py``.

Ragged batch layout (the engine's step): q [T, Hq, D] holds R sequences'
query tokens concatenated; row r owns tokens q_start[r] ..
q_start[r]+q_len[r]-1 (disjoint spans; q_len 0 = inactive row; tokens
owned by no row are padding and produce zeros). Token j of row r sits at
absolute position kv_len[r]-q_len[r]+j and causally sees the first
kv_len[r]-q_len[r]+j+1 slots of the row's pages (its own chunk included:
the caller writes the chunk's K/V into the pages before attending).

Two implementations of one function:
  - ``ragged_paged_attention_reference``: plain PyTorch, a gather per row
    (the oracle, and what runs on CPU tensors);
  - ``_ragged_attention_cuda``: the hand-written CUDA kernel
    (``csrc/ragged_paged_attention.cu``, replacing the TPU's
    ``_ragged_kernel``), for CUDA tensors.
``ragged_paged_attention`` dispatches by the tensors' device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel, which raises on
anything it does not take — there is no fallback from the card.

int8 pools carry per-(page, head, slot) bf16 scales [P, Hkv, ps] and are
dequantized inside the attention.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.int8 import KV_SCALE_DTYPE, quantize_kv

_NEG_INF = float("-inf")

#: kernel launches made by the wrapper, and calls of the plain version on
#: CUDA tensors (a run that should only use the kernel checks it stays 0)
launch_counts = {"ragged_paged_attention": 0,
                 "ragged_paged_attention_reference_cuda": 0}


def _token_descriptors(q_start, q_len, kv_len, T: int):
    """Per-token (owning row, visible kv length) from per-row descriptors;
    a token no row owns gets row 0 and visible length 0."""
    tvec = torch.arange(T, dtype=torch.int32, device=q_start.device)
    in_row = (tvec[None, :] >= q_start[:, None]) & \
             (tvec[None, :] < (q_start + q_len)[:, None])       # [R, T]
    token_row = in_row.to(torch.int32).argmax(dim=0)            # first row
    owned = in_row.any(dim=0)
    tr = token_row.long()
    vis = kv_len[tr] - q_len[tr] + (tvec - q_start[tr]) + 1
    token_vis = torch.where(owned, vis, torch.zeros_like(vis))
    return token_row.to(torch.int32), token_vis.to(torch.int32)


def _safe_softmax(s):
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(torch.isneginf(s), torch.zeros_like(s), torch.exp(s - m))
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     q_start, q_len, kv_len, *,
                                     k_scale=None, v_scale=None,
                                     sm_scale: Optional[float] = None,
                                     max_q_len: Optional[int] = None,
                                     decode_rows: int = 0) -> torch.Tensor:
    """Gather-based ragged paged attention (the plain version).

    q: [T, Hq, D]; k/v_pages: [P, Hkv, ps, D] (int8 when scales given);
    k/v_scale: [P, Hkv, ps] or None; page_table: [R, max_pages];
    q_start/q_len/kv_len: [R].

    ``decode_rows``/``max_q_len`` are cost hints, not semantics, as in
    the JAX reference: the first ``decode_rows`` rows must have q_len <= 1
    and get one gathered score row each; the rest are computed on
    ``max_q_len``-sized blocks (default T).
    """
    if q.is_cuda:
        launch_counts["ragged_paged_attention_reference_cuda"] += 1
    T, Hq, D = q.shape
    R, max_pages = page_table.shape
    _, Hkv, ps, _ = k_pages.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    max_kv = max_pages * ps
    qpk = Hq // Hkv
    dev = q.device
    pt = page_table.long()
    q_start, q_len, kv_len = q_start.long(), q_len.long(), kv_len.long()

    # one page gather per row -> [R, Hkv, max_kv, D] fp32 (dequantized)
    kr = k_pages[pt].float()                     # [R, mp, Hkv, ps, D]
    vr = v_pages[pt].float()
    if k_scale is not None:
        kr = kr * k_scale[pt].float()[..., None]
        vr = vr * v_scale[pt].float()[..., None]
    kr = kr.permute(0, 2, 1, 3, 4).reshape(R, Hkv, max_kv, D)
    vr = vr.permute(0, 2, 1, 3, 4).reshape(R, Hkv, max_kv, D)

    out = torch.zeros(T, Hq, D, dtype=torch.float32, device=dev)
    tkv = torch.arange(max_kv, device=dev)

    Rd = decode_rows
    if Rd:
        idx = q_start[:Rd].clamp(0, T - 1)
        qd = q[idx].reshape(Rd, Hkv, qpk, D).float()
        s = torch.einsum("rgqd,rgtd->rgqt", qd, kr[:Rd]) * sm_scale
        active = q_len[:Rd] > 0
        vis = torch.where(active, kv_len[:Rd], torch.zeros_like(kv_len[:Rd]))
        s = s.masked_fill(tkv[None, None, None, :]
                          >= vis[:, None, None, None], _NEG_INF)
        od = torch.einsum("rgqt,rgtd->rgqd", _safe_softmax(s), vr[:Rd])
        od = torch.where(active[:, None, None], od.reshape(Rd, Hq, D), 0.0)
        out.index_add_(0, idx, od)

    if R - Rd:
        C = min(max_q_len if max_q_len is not None else T, T)
        qpad = torch.cat([q.float(), q.new_zeros(C, Hq, D,
                                                 dtype=torch.float32)])
        starts = q_start[Rd:].clamp(0, T)
        cvec = torch.arange(C, device=dev)
        dest = starts[:, None] + cvec[None, :]          # [Rp, C] < T + C
        qc = qpad[dest].reshape(-1, C, Hkv, qpk, D)
        s = torch.einsum("rcgqd,rgtd->rcgqt", qc, kr[Rd:]) * sm_scale
        in_chunk = cvec[None, :] < q_len[Rd:, None]     # [Rp, C]
        vis = kv_len[Rd:, None] - q_len[Rd:, None] + cvec[None, :] + 1
        vis = torch.where(in_chunk, vis, torch.zeros_like(vis))
        s = s.masked_fill(tkv[None, None, None, None, :]
                          >= vis[:, :, None, None, None], _NEG_INF)
        oc = torch.einsum("rcgqt,rgtd->rcgqd", _safe_softmax(s), vr[Rd:])
        oc = torch.where(in_chunk[:, :, None, None],
                         oc.reshape(-1, C, Hq, D), 0.0)
        buf = torch.zeros(T + C, Hq, D, dtype=torch.float32, device=dev)
        buf.index_add_(0, dest.reshape(-1), oc.reshape(-1, Hq, D))
        out = out + buf[:T]
    return out.to(q.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: head dims the CUDA kernel is instantiated for (Llama 3: 128)
KERNEL_HEAD_DIMS = (128,)


def _ragged_attention_cuda(q, k_pages, v_pages, page_table, q_start,
                           q_len, kv_len, k_scale, v_scale,
                           sm_scale: float) -> torch.Tensor:
    """Launch the CUDA kernel. Checks device, dtype, shape and contiguity
    and raises on what the kernel does not take. Page ids in
    ``page_table`` must lie in [0, P): the kernel reads them unchecked."""
    T, Hq, D = q.shape
    P, Hkv, ps, Dk = k_pages.shape
    R, max_pages = page_table.shape
    scales = k_scale is not None
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_table": page_table, "q_start": q_start,
               "q_len": q_len, "kv_len": kv_len}
    if scales:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes fp32 or bf16")
    if k_pages.dtype not in (q.dtype, torch.int8) \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pool dtypes {k_pages.dtype}/{v_pages.dtype}: the "
                        f"kernel takes pools in q's dtype ({q.dtype}) or "
                        f"int8, both alike")
    if (k_pages.dtype == torch.int8) != scales:
        raise TypeError("int8 pools need k_scale/v_scale, fp pools none")
    if v_pages.shape != k_pages.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is built for "
                         f"{KERNEL_HEAD_DIMS}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("pools must start on 16 bytes (vector loads)")
    if scales and (k_scale.dtype != KV_SCALE_DTYPE
                   or v_scale.dtype != KV_SCALE_DTYPE
                   or k_scale.shape != (P, Hkv, ps)
                   or v_scale.shape != (P, Hkv, ps)):
        raise ValueError(f"scales must be {KV_SCALE_DTYPE} [P, Hkv, ps]")
    for name in ("page_table", "q_start", "q_len", "kv_len"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if q_start.shape != (R,) or q_len.shape != (R,) or kv_len.shape != (R,):
        raise ValueError(f"row descriptors must be [R={R}]")

    out = torch.empty_like(q)
    lib = _kernels.load("ragged_paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the kernel derives each token's row and visible length itself
        # (what _token_descriptors computes), so no per-token tensors
        rc = lib.ragged_paged_attention(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if scales else None,
            v_scale.data_ptr() if scales else None,
            page_table.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(),
            T, R, Hq, Hkv, ps, D, max_pages, float(sm_scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention launch failed: "
            f"{lib.kernel_error_string(rc).decode()} (cudaError {rc})")
    if T:
        launch_counts["ragged_paged_attention"] += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_table, q_start,
                           q_len, kv_len, *, k_scale=None, v_scale=None,
                           sm_scale: Optional[float] = None,
                           max_q_len: Optional[int] = None,
                           decode_rows: int = 0,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Mixed prefill+decode attention over a ragged token batch in ONE
    launch. CUDA tensors go to the kernel, CPU tensors to the plain
    version. ``impl`` pins the choice and raises where it cannot hold:
    "kernel" on CPU tensors, "reference" on CUDA tensors (compare against
    the plain version by calling ``ragged_paged_attention_reference``).
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.shape[1] % k_pages.shape[1]:
        raise ValueError(
            f"q heads {q.shape[1]} not a multiple of kv heads "
            f"{k_pages.shape[1]}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if impl not in (None, "kernel", "reference"):
        raise ValueError(f"impl must be 'kernel' or 'reference', "
                         f"got {impl!r}")
    if q.is_cuda:
        if impl == "reference":
            raise ValueError("impl='reference' runs on CPU tensors only")
        return _ragged_attention_cuda(q, k_pages, v_pages, page_table,
                                      q_start, q_len, kv_len, k_scale,
                                      v_scale, sm_scale)
    if impl == "kernel":
        raise ValueError("impl='kernel' needs CUDA tensors; CPU tensors "
                         "run the plain version")
    return ragged_paged_attention_reference(
        q, k_pages, v_pages, page_table, q_start, q_len, kv_len,
        k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale,
        max_q_len=max_q_len, decode_rows=decode_rows)


def write_ragged_kv(k_pages, v_pages, k_t, v_t, token_page, token_slot,
                    k_scale=None, v_scale=None):
    """Scatter a ragged batch's per-token K/V into the page pool, IN PLACE
    (the JAX version returns updated copies of donated buffers; here the
    given tensors are written and returned).

    k_t/v_t: [T, Hkv, D]; token_page/token_slot: [T] destination page and
    in-page slot — padding tokens all point at page 0, the scratch page:
    those duplicate writes land in any order, which is harmless only
    because page 0 is never read as valid. With int8 pools
    (``k_scale``/``v_scale`` [P, Hkv, ps] given) rows quantize with
    per-(token, head) scales and the scales scatter alongside. Returns
    (k_pages, v_pages, k_scale, v_scale).
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    page, slot = token_page.long(), token_slot.long()
    # advanced indices at axes 0 and 2 are separated by a basic slice, so
    # the indexed destination is [T, Hkv, D]
    if k_scale is not None:
        kq, ks = quantize_kv(k_t)                 # [T, Hkv, D], [T, Hkv]
        vq, vs = quantize_kv(v_t)
        k_pages[page, :, slot, :] = kq
        v_pages[page, :, slot, :] = vq
        k_scale[page, :, slot] = ks.to(k_scale.dtype)
        v_scale[page, :, slot] = vs.to(v_scale.dtype)
    else:
        k_pages[page, :, slot, :] = k_t.to(k_pages.dtype)
        v_pages[page, :, slot, :] = v_t.to(v_pages.dtype)
    return k_pages, v_pages, k_scale, v_scale
