"""Paged-KV attention — the PyTorch port of ``ray_tpu/ops/paged_attention.py``,
both halves: the decode op ``paged_attention`` (one query token per
sequence) and the ragged op ``ragged_paged_attention`` (the engine's step).

The KV cache is a pool of pages [P, Hkv, ps, D]; a sequence's cache is the
pages named by its row of ``page_table``.

Decode: q [B, Hq, D], one token per sequence, sees the first seq_lens[b]
slots of its pages (at most the table's max_pages * ps); the table's
unused tail may hold anything, since no decode version reads a page id
past the sequence's length. Three implementations of one function:
  - ``paged_attention_reference``: plain PyTorch, a gather per sequence,
    fp32 softmax (the counterpart of the JAX reference; a length-0 row
    gives 0, where the JAX reference gives NaN and its kernel 0);
  - ``_paged_decode_reference``: plain PyTorch that walks the pages as the
    TPU's ``_decode_kernel`` does (online softmax page by page, p rounded
    to v's dtype before p·v), each split of ``pages_per_split`` pages
    with its own state, the splits merged as the CUDA kernel merges them;
  - ``_paged_attention_cuda``: the hand-written CUDA kernel
    (``csrc/paged_attention.cu``, replacing ``_decode_kernel``; bf16 pools
    walk a ring of pages filled by TMA copies, ``csrc/paged_ring.cuh``),
    split over pages as ``decode_plan`` says from the shapes, for CUDA
    tensors.
``paged_attention`` dispatches by the tensors' device, as the ragged op.

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
    ``_ragged_kernel``), for CUDA tensors. For bf16 q its grid is planned
    here from the shapes and the engine's static hints (``ragged_plan``):
    decode rows split over pages, prefill rows in tiles of tokens x query
    heads on the tensor cores.
``ragged_paged_attention`` dispatches by the tensors' device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel, which raises on
anything it does not take — there is no fallback from the card.

int8 pools carry per-(page, head, slot) bf16 scales [P, Hkv, ps] and are
dequantized inside the attention.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.int8 import KV_SCALE_DTYPE, quantize_kv

_NEG_INF = float("-inf")

#: kernel launches made by the wrapper, and calls of the plain version on
#: CUDA tensors (a run that should only use the kernel checks it stays 0);
#: "ragged_paged_attention_int8" counts the ragged launches on int8 pools
#: again, apart (they are in "ragged_paged_attention" as well)
launch_counts = {"ragged_paged_attention": 0,
                 "ragged_paged_attention_int8": 0,
                 "ragged_paged_attention_reference_cuda": 0,
                 "paged_attention": 0,
                 "paged_attention_reference_cuda": 0}
_count_lock = threading.Lock()


def _count(name: str) -> None:
    """One more in ``launch_counts[name]``; under a lock, since wrappers
    run on several threads at once (the runtime's actors and trials)."""
    with _count_lock:
        launch_counts[name] += 1


def add_launches(delta) -> None:
    """Add each ``delta[name]`` to ``launch_counts[name]`` (a CUDA graph's
    replay launches what its capture counted once: ``dag.CompiledDAG``)."""
    with _count_lock:
        for name, n in delta.items():
            launch_counts[name] += n


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
        _count("ragged_paged_attention_reference_cuda")
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
#: head dims the CUDA kernels are instantiated for (Llama 3: 128; the JAX
#: package's serving benchmark, bench_llm.py: 64)
KERNEL_HEAD_DIMS = (64, 128)
#: page sizes and query heads per kv head of the split walk
#: (paged_split.cuh), which the decode op and the bf16 ragged kernel run
DECODE_PAGE_SIZES = (8, 16, 32)
DECODE_Q_PER_KV = (1, 2, 4, 8)


def check_kernel_geometry(Hq: int, Hkv: int, D: int, page_size: int,
                          q_dtype, kv_dtype, *, decode_op: bool = False
                          ) -> None:
    """Raise (ValueError, TypeError) on an attention geometry the CUDA
    kernels are not built for: the ragged op (the engine's), or with
    ``decode_op`` the decode op. Both wrappers call it before a launch,
    and ``InferenceEngine`` at construction on a CUDA device, so a
    server never starts on a geometry its first step would refuse.

    q in fp32 or bf16; pools in q's dtype, or (ragged op only) int8; head
    dim in KERNEL_HEAD_DIMS; the decode op and the bf16 ragged kernel also
    need a page size in DECODE_PAGE_SIZES and a query-head group in
    DECODE_Q_PER_KV (the fp32 ragged kernel takes any)."""
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} kv "
                         f"heads")
    if q_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q_dtype}: the kernels take fp32 or bf16")
    pools = (q_dtype,) if decode_op else (q_dtype, torch.int8)
    if kv_dtype not in pools:
        raise TypeError(f"pool dtypes {kv_dtype}: the kernel takes pools in "
                        f"q's dtype ({q_dtype})"
                        + ("" if decode_op else " or int8"))
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernels are built for "
                         f"{KERNEL_HEAD_DIMS}")
    if (decode_op or q_dtype == torch.bfloat16) and (
            page_size not in DECODE_PAGE_SIZES
            or Hq // Hkv not in DECODE_Q_PER_KV):
        raise ValueError(f"page size {page_size}, {Hq // Hkv} query heads "
                         f"per kv head: the kernels are built for pages of "
                         f"{DECODE_PAGE_SIZES} and {DECODE_Q_PER_KV}")


def _check_placement(q, tensors) -> None:
    """Raise unless every tensor of {name: tensor} is contiguous and on
    q's device."""
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _on_card(q, impl: Optional[str]) -> bool:
    """Whether a dispatcher runs its kernel (CUDA tensors) or its plain
    version (CPU tensors). ``impl`` pins the choice and raises where it
    cannot hold: "kernel" on CPU tensors, "reference" on CUDA tensors."""
    if impl not in (None, "kernel", "reference"):
        raise ValueError(f"impl must be 'kernel' or 'reference', "
                         f"got {impl!r}")
    if q.is_cuda and impl == "reference":
        raise ValueError("impl='reference' runs on CPU tensors only")
    if not q.is_cuda and impl == "kernel":
        raise ValueError("impl='kernel' needs CUDA tensors; CPU tensors "
                         "run the plain version")
    return q.is_cuda


#: rows of one prefill tile of the bf16 ragged kernel: BM tokens x the
#: Hq / Hkv query heads of one kv head (one 64-row warpgroup tile)
RAGGED_TILE_ROWS = 64
#: pages each decode block of the bf16 ragged kernel walks
RAGGED_PAGES_PER_SPLIT = 8


class RaggedPlan(NamedTuple):
    """The bf16 ragged kernel's grid for one call."""
    decode_rows: int     # rows [0, decode_rows) take the decode splits
    block_tokens: int    # BM: tokens of a prefill tile
    q_blocks: int        # nb: q blocks per (prefill row, kv head)
    prefill_blocks: int  # (R - decode_rows) * nb * Hkv
    splits: int          # decode splits per (row, kv head)
    decode_blocks: int   # decode_rows * Hkv * splits


def ragged_plan(T: int, R: int, Hq: int, Hkv: int, max_pages: int,
                decode_rows: int = 0, max_q_len: Optional[int] = None,
                pages_per_split: int = RAGGED_PAGES_PER_SPLIT
                ) -> RaggedPlan:
    """The bf16 ragged kernel's grid from the shapes and the engine's
    static hints alone, so the host reads nothing back. Rows [0,
    decode_rows) (q_len <= 1 by contract) are decode rows, split over
    pages; the split count comes from the table's shape. Every other row
    gets nb = ceil(C / BM) prefill blocks per kv head, C = min(max_q_len
    or T, T); a block covers its row's q blocks b, b + nb, ... up to the
    row's q_len, so a hint that is too small costs time, never a token."""
    Rd = min(max(int(decode_rows), 0), R)
    bm = RAGGED_TILE_ROWS // (Hq // Hkv)
    C = T if max_q_len is None else min(max(int(max_q_len), 1), T)
    nb = max(1, -(-C // bm))
    S = _n_splits(max_pages, pages_per_split)
    return RaggedPlan(Rd, bm, nb, (R - Rd) * nb * Hkv, S, Rd * Hkv * S)


def ragged_prefill_block(plan: RaggedPlan, R: int, Hkv: int, i: int):
    """(row, first q block, kv head) of prefill block i, as the kernel
    maps it: kv head fastest, then row, the last q blocks (which see the
    most keys) first."""
    rest, Rp = i // Hkv, R - plan.decode_rows
    return (plan.decode_rows + rest % Rp, plan.q_blocks - 1 - rest // Rp,
            i % Hkv)


def _ragged_attention_cuda(q, k_pages, v_pages, page_table, q_start,
                           q_len, kv_len, k_scale, v_scale,
                           sm_scale: float, decode_rows: int = 0,
                           max_q_len: Optional[int] = None,
                           pages_per_split: int = RAGGED_PAGES_PER_SPLIT
                           ) -> torch.Tensor:
    """Launch the CUDA kernel (for bf16 q two launches, planned by
    ``ragged_plan``; fp32 q takes the first port's one-block-per-token
    kernel and ignores the hints). Checks device, dtype, shape and
    contiguity and raises on what the kernel does not take. Page ids in
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
    _check_placement(q, tensors)
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pool dtypes {k_pages.dtype}/{v_pages.dtype}: the "
                        f"kernel takes both alike")
    if v_pages.shape != k_pages.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    check_kernel_geometry(Hq, Hkv, D, ps, q.dtype, k_pages.dtype)
    if (k_pages.dtype == torch.int8) != scales:
        raise TypeError("int8 pools need k_scale/v_scale, fp pools none")
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

    if max_pages < 1 or int(decode_rows) < 0 or pages_per_split < 1:
        raise ValueError(f"max_pages {max_pages}, decode_rows {decode_rows}"
                         f", pages_per_split {pages_per_split}")
    tiles = q.dtype == torch.bfloat16
    if tiles and (q.data_ptr() % 16 or scales and (
            k_scale.data_ptr() % 16 or v_scale.data_ptr() % 16)):
        raise ValueError("q and the scales must start on 16 bytes (vector "
                         "loads)")

    plan = ragged_plan(T, R, Hq, Hkv, max_pages, decode_rows, max_q_len,
                       pages_per_split)
    # every token is written: by its row's block, or with 0 by the
    # kernel's second launch (fp32: by its own block)
    out = torch.empty_like(q)
    work = torch.empty(plan.decode_rows * Hq * plan.splits * (D + 2),
                       dtype=torch.float32, device=q.device) \
        if tiles and plan.decode_rows and plan.splits > 1 else None
    _kernels.launch(
        "ragged_paged_attention", "ragged_paged_attention", q.device,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], q, k_pages,
        v_pages, k_scale, v_scale, page_table, q_start, q_len, kv_len, out,
        work, T, R, Hq, Hkv, ps, D, max_pages, plan.decode_rows,
        plan.q_blocks, pages_per_split, float(sm_scale))
    if T:
        _count("ragged_paged_attention")
        if scales:
            _count("ragged_paged_attention_int8")
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_table, q_start,
                           q_len, kv_len, *, k_scale=None, v_scale=None,
                           sm_scale: Optional[float] = None,
                           max_q_len: Optional[int] = None,
                           decode_rows: int = 0,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Mixed prefill+decode attention over a ragged token batch in ONE
    call (one count in ``launch_counts``; for bf16 q the kernel makes two
    CUDA launches). CUDA tensors go to the kernel, CPU tensors to the
    plain version. ``decode_rows`` and ``max_q_len`` are static cost
    hints, as in the JAX package: rows [0, decode_rows) must have q_len <=
    1. ``impl`` pins the choice and raises where it cannot hold: "kernel"
    on CPU tensors, "reference" on CUDA tensors (compare against the plain
    version by calling ``ragged_paged_attention_reference``).
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.shape[1] % k_pages.shape[1]:
        raise ValueError(
            f"q heads {q.shape[1]} not a multiple of kv heads "
            f"{k_pages.shape[1]}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if _on_card(q, impl):
        return _ragged_attention_cuda(q, k_pages, v_pages, page_table,
                                      q_start, q_len, kv_len, k_scale,
                                      v_scale, sm_scale, decode_rows,
                                      max_q_len)
    return ragged_paged_attention_reference(
        q, k_pages, v_pages, page_table, q_start, q_len, kv_len,
        k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale,
        max_q_len=max_q_len, decode_rows=decode_rows)


# ------------------------------------------------------------------ decode

#: slots of one stage of the bf16 decode kernel's page ring: ring::kSlots
#: of paged_ring.cuh, which the library reports as
#: paged_decode_stage_slots() (a card test holds the two equal)
DECODE_STAGE_SLOTS = 32
#: the decode plan's floor: a split walks at least 2 stages, one for each
#: consumer warp
DECODE_MIN_SPLIT_SLOTS = 2 * DECODE_STAGE_SLOTS
#: SMs of an NVIDIA H100 SXM, the card the plan's sweep of split sizes was
#: measured on (PERF.md, chip_compare.py decode and chip_smoke.py phase 3b)
H100_SMS = 132
#: blocks the decode plan fills the grid with at most: 8 an SM (six
#: blocks of the ring walk fit an SM at head dim 128; 4 an SM lost 12% at
#: batch A in that sweep)
DECODE_TARGET_BLOCKS = 8 * H100_SMS


class DecodePlan(NamedTuple):
    """The decode kernel's grid for one call."""
    pages_per_split: int
    splits: int          # ceil(max_pages / pages_per_split)
    blocks: int          # B * Hkv * splits


def decode_plan(B: int, Hq: int, Hkv: int, max_pages: int, ps: int
                ) -> DecodePlan:
    """The decode kernel's split size from the shapes alone, so the host
    reads no lengths: the floor (DECODE_MIN_SPLIT_SLOTS slots), doubled
    while the grid of B x Hkv x splits blocks would exceed
    DECODE_TARGET_BLOCKS, at most the table. At the serving widths (Hkv 8,
    pages of 16) a batch of 8 x 2048 tokens gets 8 pages a split, 8 x 8192
    tokens 32; bench_llm.py's widths (pages of 32, 512 tokens) 2."""
    if Hkv < 1 or Hq % Hkv or ps < 1 or B < 0 or max_pages < 0:
        raise ValueError(f"decode plan of B {B}, Hq {Hq}, Hkv {Hkv}, "
                         f"max_pages {max_pages}, page size {ps}")
    pps = max(1, DECODE_MIN_SPLIT_SLOTS // ps)
    while pps < max_pages and \
            B * Hkv * _n_splits(max_pages, pps) > DECODE_TARGET_BLOCKS:
        pps *= 2
    pps = max(1, min(pps, max_pages))
    S = _n_splits(max_pages, pps)
    return DecodePlan(pps, S, B * Hkv * S)


def _decode_pages(page_table, seq_lens, ps: int):
    """Visible slots per sequence (at most the table's max_pages * ps)
    and the table with every page past them replaced by page 0, so that
    a gather never sees the unused tail's ids."""
    max_pages = page_table.shape[1]
    lens = seq_lens.long().clamp(0, max_pages * ps)
    covered = torch.arange(max_pages, device=page_table.device)[None, :] \
        < ((lens + ps - 1) // ps)[:, None]
    return lens, torch.where(covered, page_table.long(), 0)


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens, *,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Gather-based paged decode attention (the plain version).

    q: [B, Hq, D], one decode token per sequence; k/v_pages:
    [P, Hkv, ps, D]; page_table: [B, max_pages] (unused tail: any);
    seq_lens: [B] valid KV slots (incl. the current token). Returns
    [B, Hq, D] in q's dtype; a length-0 row gives 0.
    """
    if q.is_cuda:
        _count("paged_attention_reference_cuda")
    B, Hq, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    max_pages = page_table.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    lens, pt = _decode_pages(page_table, seq_lens, ps)
    k = k_pages[pt].permute(0, 2, 1, 3, 4).reshape(B, Hkv, -1, D).float()
    v = v_pages[pt].permute(0, 2, 1, 3, 4).reshape(B, Hkv, -1, D).float()
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bgqd,bgtd->bgqt", qg, k) * sm_scale
    pos = torch.arange(max_pages * ps, device=q.device)
    s = s.masked_fill(pos[None, None, None, :] >= lens[:, None, None, None],
                      _NEG_INF)
    o = torch.einsum("bgqt,bgtd->bgqd", _safe_softmax(s), v)
    return o.reshape(B, Hq, D).to(q.dtype)


def _n_splits(max_pages: int, pages_per_split: int) -> int:
    return max(1, -(-max_pages // pages_per_split))


def _paged_decode_reference(q, k_pages, v_pages, page_table, seq_lens,
                            sm_scale: float,
                            pages_per_split: Optional[int] = None
                            ) -> torch.Tensor:
    """The decode kernel's plain version: ``_decode_kernel``'s body, page
    by page, for each split of ``pages_per_split`` pages (None: one split,
    the TPU kernel's single walk), then the kernel's merge.

    Per page: fp32 scores scaled after the product, slots at or past the
    length masked, m_new = max(m, page max), p = 0 where s is -inf, the
    rescale 0 while m is -inf, l summing the unrounded p, p rounded to v's
    dtype before an fp32 p·v. Merge over splits in order:
    o = sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i, 1e-30), empty
    splits (m = -inf) skipped.
    """
    if q.is_cuda:
        _count("paged_attention_reference_cuda")
    B, Hq, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    max_pages = page_table.shape[1]
    pps = max(1, max_pages if pages_per_split is None else pages_per_split)
    S = _n_splits(max_pages, pps)
    dev = q.device
    lens, pt = _decode_pages(page_table, seq_lens, ps)
    pt = torch.cat([pt, pt.new_zeros(B, S * pps - max_pages)], 1)
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    m = torch.full((S, B, Hkv, Hq // Hkv), _NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(*m.shape, D, device=dev)
    col = torch.arange(ps, device=dev)
    for t in range(pps):                      # the splits walk together
        pages = torch.arange(S, device=dev) * pps + t           # [S]
        valid = lens[None, :] - pages[:, None] * ps             # [S, B]
        ids = pt[:, pages].T                                    # [S, B]
        s = torch.einsum("bgqd,sbgtd->sbgqt", qg,
                         k_pages[ids].float()) * sm_scale
        s = s.masked_fill(col >= valid[..., None, None, None], _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(torch.isneginf(s), 0.0,
                        torch.exp(s - m_new[..., None]))
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_new))
        pv = torch.einsum("sbgqt,sbgtd->sbgqd", p.to(v_pages.dtype).float(),
                          v_pages[ids].float())
        live = (valid > 0)[..., None, None]   # the page holds a valid slot
        l = torch.where(live, l * corr + p.sum(-1), l)
        acc = torch.where(live[..., None], acc * corr[..., None] + pv, acc)
        m = torch.where(live, m_new, m)
    M = m.amax(0)
    w = torch.where(torch.isneginf(m), 0.0,
                    torch.exp(m - torch.where(torch.isneginf(M), 0.0, M)))
    o = (w[..., None] * acc).sum(0) / (w * l).sum(0).clamp_min(1e-30)[
        ..., None]
    return o.reshape(B, Hq, D).to(q.dtype)


def _paged_attention_cuda(q, k_pages, v_pages, page_table, seq_lens,
                          sm_scale: float,
                          pages_per_split: Optional[int] = None
                          ) -> torch.Tensor:
    """Launch the decode kernel (and its merge, when there is more than
    one split), split as ``decode_plan`` says unless ``pages_per_split``
    is given. Checks device, dtype, shape and contiguity and raises on
    what the kernel does not take. Page ids a sequence covers must lie in
    [0, P): the kernel reads them unchecked, and no others."""
    B, Hq, D = q.shape
    P, Hkv, ps, Dk = k_pages.shape
    Bt, max_pages = page_table.shape
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_table": page_table, "seq_lens": seq_lens}
    _check_placement(q, tensors)
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pool dtypes {k_pages.dtype}/{v_pages.dtype}: the "
                        f"kernel takes both alike")
    for name in ("page_table", "seq_lens"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if v_pages.shape != k_pages.shape or Dk != D or Hq % Hkv \
            or Bt != B or seq_lens.shape != (B,):
        raise ValueError(f"shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"page_table {tuple(page_table.shape)}, seq_lens "
                         f"{tuple(seq_lens.shape)}")
    check_kernel_geometry(Hq, Hkv, D, ps, q.dtype, k_pages.dtype,
                          decode_op=True)
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError("q and the pools must start on 16 bytes (vector "
                         "loads)")
    if pages_per_split is None:
        pages_per_split = decode_plan(B, Hq, Hkv, max_pages,
                                      ps).pages_per_split
    if pages_per_split < 1:
        raise ValueError(f"pages_per_split {pages_per_split} < 1")

    out = torch.empty_like(q)
    if B == 0:
        return out
    S = _n_splits(max_pages, pages_per_split)
    # each split's (m, l, acc) per query head, merged by the second launch
    work = torch.empty(B * Hq * S * (D + 2), dtype=torch.float32,
                       device=q.device) if S > 1 else None
    _kernels.launch("paged_attention", "paged_attention", q.device,
                    _DTYPE_CODES[q.dtype], q, k_pages, v_pages, page_table,
                    seq_lens, out, work, B, P, Hq, Hkv, ps, D, max_pages,
                    pages_per_split, float(sm_scale))
    _count("paged_attention")
    return out


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    sm_scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Decode attention, one query token per sequence, over its pages.
    CUDA tensors go to the kernel, CPU tensors to
    ``paged_attention_reference``. ``impl`` pins the choice and raises
    where it cannot hold: "kernel" on CPU tensors, "reference" on CUDA
    tensors (compare against the plain versions by calling them)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.shape[1] % k_pages.shape[1]:
        raise ValueError(
            f"q heads {q.shape[1]} not a multiple of kv heads "
            f"{k_pages.shape[1]}")
    if _on_card(q, impl):
        return _paged_attention_cuda(q, k_pages, v_pages, page_table,
                                     seq_lens, sm_scale)
    return paged_attention_reference(q, k_pages, v_pages, page_table,
                                     seq_lens, sm_scale=sm_scale)


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
