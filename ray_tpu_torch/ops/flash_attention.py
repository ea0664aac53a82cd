"""Flash attention, forward and backward — the PyTorch port of
``ray_tpu/ops/flash_attention.py``.

  flash_attention(q, k, v)        [B, L, H, D] -> [B, L, H, D]
  flash_attention_block(q, k, v)  -> (o, lse [B, H, Lq]), lse differentiable

The forward saves each row's logsumexp; the backward recomputes
p = exp(s - lse) tile by tile from it, so no [L, L] score matrix is kept
in either pass. Three functions of ``[BH, L, D]`` tensors carry the work,
each with two implementations:
  - plain PyTorch (``_fwd_reference``, ``_bwd_reference``): the oracle and
    what runs on CPU tensors. They compute what the TPU kernels' bodies
    compute, block by block (``blk_q`` x ``blk_k``), not what
    ``blockwise_attention`` computes: the fp32 score is scaled, not q;
  - hand-written CUDA kernels for CUDA tensors: ``csrc/flash_attention_fwd.cu``
    (replacing the TPU's ``_fwd_kernel``) and ``csrc/flash_attention_bwd.cu``
    (``_dq_kernel`` and ``_dkv_kernel``; bf16 at head dim 128 runs the
    Hopper designs ``flash_fwd_sm90_kernel``, ``flash_dq_sm90_kernel`` and
    ``flash_dkv_sm90_kernel``, each built for two tiles, ``KERNEL_TILES``).
    They take any length, masking the last q tile and key tile; the
    wrappers raise on what they do not take, a tile not built included.
    There is no fallback from the card to the plain versions.
``_fwd_call`` / ``_bwd_call`` dispatch by the tensors' device.

Tiles. ``blk_q``/``blk_k`` block the plain versions, as the JAX package's
block the Pallas kernels; the CUDA kernels then launch their default tiles.
``blk_q=None, blk_k=None`` take the entry ``autotune_blocks`` cached for
the call's (Lq, Lk, head dim, dtype, platform), a ``FlashTiles`` (a pair
per kernel): on the CPU the JAX package's pick, blocking the plain
versions; on the card each kernel's fastest built variant. Without an
entry, 256 and the default tiles, as before any sweep.

``blockwise_attention`` is the pure-torch online-softmax scan over key
blocks, [B, L, H, D], as in the JAX package (q scaled in its own dtype).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.ops import _kernels

_NEG_INF = float("-inf")

#: kernel launches made by the wrappers, and calls of the plain versions on
#: CUDA tensors (a run that should only use the kernels checks they stay 0)
launch_counts = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
                 "flash_attention_dkv": 0,
                 "flash_attention_fwd_reference_cuda": 0,
                 "flash_attention_bwd_reference_cuda": 0}
_count_lock = threading.Lock()


#: the kernel launches by tile variant, {(entry point, (blk_q, blk_k)):
#: n}, counted beside ``launch_counts`` (not by ``add_launches``)
variant_launches: Dict[tuple, int] = {}


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


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the CUDA kernels are instantiated for (Llama: 128; bf16 at 64
#: takes the first designs, the Hopper designs being built for 128 only)
KERNEL_HEAD_DIMS = (64, 128)
#: the backward kernels read lse and delta as [BH, Lq rounded up to this],
#: the padding zeros, so that every 64-row piece comes whole and aligned
LSE_PAD = 64

# ---------------------------------------------------------- tile variants

#: the flash kernels, by the JAX package's names: ``_fwd_kernel``,
#: ``_dq_kernel``, ``_dkv_kernel``
FLASH_KERNELS = ("fwd", "dq", "dkv")
_ENTRY = {"fwd": "flash_attention_fwd", "dq": "flash_attention_dq",
          "dkv": "flash_attention_dkv"}


class FlashTiles(NamedTuple):
    """A (blk_q, blk_k) pair per flash kernel, in the JAX kernels' roles:
    fwd and dq own blk_q query rows a block and stream blk_k keys a tile,
    dk/dv owns blk_k keys a block and streams blk_q query rows. On CUDA
    tensors each names the variant its kernel launches; on CPU tensors it
    blocks that kernel's plain version (there the three are equal: the
    JAX package shares one pair across its kernels)."""
    fwd: Tuple[int, int]
    dq: Tuple[int, int]
    dkv: Tuple[int, int]

    @classmethod
    def uniform(cls, blocks) -> "FlashTiles":
        blocks = tuple(blocks)
        return cls(blocks, blocks, blocks)


#: the Hopper designs' variants (bf16, head dim 128): kernel -> {tile:
#: ring slots}, the default first. fwd: 128-key k/v tiles through 2
#: slots, or 64-key tiles through 4; dq: 64-key k/v tiles through 4 slots,
#: or 128-key tiles (two 64-key steps each) through 2; dk/dv: 64-row q/do
#: tiles through 2 slots, or 128-row tiles (two 64-row steps) through 2.
SM90_VARIANTS = {"fwd": {(128, 128): 2, (128, 64): 4},
                 "dq": {(128, 64): 4, (128, 128): 2},
                 "dkv": {(64, 128): 2, (128, 128): 2}}
#: the tiles each kernel is built for, by (dtype, head dim), the default
#: first; the first designs (fp32, and head dim 64) have one tile each
KERNEL_TILES = {
    (torch.bfloat16, 128): {k: tuple(v) for k, v in SM90_VARIANTS.items()},
    (torch.bfloat16, 64): dict.fromkeys(FLASH_KERNELS, ((64, 64),)),
    (torch.float32, 64): dict.fromkeys(FLASH_KERNELS, ((32, 32),)),
    (torch.float32, 128): dict.fromkeys(FLASH_KERNELS, ((32, 32),)),
}
#: the shared memory a block may opt into on Hopper: 227 KB of the SM's
#: 256 KB (the kernels are built for sm_90a, so for Hopper only)
HOPPER_SMEM_OPTIN = 232_448
_HOPPER_KINDS = ("H100", "H200", "H800")


def default_tiles(dtype, head_dim: int) -> FlashTiles:
    """Each kernel's first tile in ``KERNEL_TILES``: what it launches
    unless a tuned entry or a caller names another."""
    table = KERNEL_TILES.get((dtype, head_dim))
    if table is None:
        raise ValueError(f"no flash kernel is built for {dtype} at head "
                         f"dim {head_dim}")
    return FlashTiles(*(table[k][0] for k in FLASH_KERNELS))


def tile_variants(dtype, head_dim: int) -> list:
    """Every built tile of the three kernels at (dtype, head dim), as
    FlashTiles: the i-th of each kernel, the defaults first (a kernel with
    fewer tiles repeats its last)."""
    table = KERNEL_TILES[(dtype, head_dim)]
    n = max(len(t) for t in table.values())
    return [FlashTiles(*(table[k][min(i, len(table[k]) - 1)]
                         for k in FLASH_KERNELS)) for i in range(n)]


def _kernel_tile(kernel: str, dtype, head_dim: int, tile=None):
    """The tile a launch takes: ``tile``, or the kernel's default; raises
    for one the kernel was not built for."""
    built = KERNEL_TILES[(dtype, head_dim)][kernel]
    tile = built[0] if tile is None else tuple(tile)
    if tile not in built:
        raise ValueError(f"flash {kernel} kernel: tile {tile} not built for "
                         f"{dtype} at head dim {head_dim} (built: {built})")
    return tile


def smem_limit(kind: str) -> int:
    """The shared memory a block may opt into on a device kind (a card's
    name): Hopper's 227 KB; 0 for every other kind, the CPU included,
    where no variant of these kernels runs."""
    return HOPPER_SMEM_OPTIN if any(h in kind for h in _HOPPER_KINDS) else 0


def _est_smem_bytes(kernel: str, blk_q: int, blk_k: int, head_dim: int,
                    dtype) -> int:
    """The dynamic shared memory a launch of the kernel's tile variant
    takes: the layouts of ``csrc/flash_attention_{fwd,bwd}.cu`` (a card
    test holds it equal to the libraries' own ``kSmem``). Hopper designs:
    [rows][64] bf16 boxes of 128-byte rows, the ring, lse and delta, the
    mbarriers and 1024 bytes for aligning the base; first designs: the
    padded tiles of ``flash_attention.cuh``."""
    if (dtype, head_dim) == (torch.bfloat16, 128):
        stages = SM90_VARIANTS[kernel].get((blk_q, blk_k))
        if stages is None:
            raise ValueError(f"flash {kernel}: tile {(blk_q, blk_k)} not "
                             f"built")
        def box(rows):
            return rows * 128
        if kernel == "fwd":   # q, then k and v tiles per slot
            body = 2 * box(blk_q) + stages * 2 * 2 * box(blk_k)
        elif kernel == "dq":  # q, do, lse and delta, then k and v per slot
            body = 4 * box(blk_q) + 8 * blk_q + stages * 2 * 2 * box(blk_k)
        else:                 # k, v, then q, do, lse, delta per slot
            slot = -(-(4 * box(blk_q) + 8 * blk_q) // 1024) * 1024
            body = 4 * box(blk_k) + stages * slot
        bars = 1 + (2 if kernel == "dkv" else 4) * stages
        return body + 8 * bars + 1024
    itemsize = dtype.itemsize
    block = 64 if itemsize == 2 else 32
    if (blk_q, blk_k) != (block, block) or (dtype, head_dim) not in \
            KERNEL_TILES:
        raise ValueError(f"flash {kernel}: tile {(blk_q, blk_k)} not built "
                         f"for {dtype} at head dim {head_dim}")
    pad = 16 // itemsize
    tile_t = itemsize * block * (head_dim + pad)   # q, k, v, do tiles
    tile_s = 4 * block * (block + 4)               # fp32 scores
    tile_p = itemsize * block * (block + pad)      # p, ds
    tile_o = 4 * block * (head_dim + 4)            # fp32 accumulators
    row = 4 * block                                # one float a row
    return {"fwd": 3 * tile_t + tile_s + tile_p + tile_o + 3 * row,
            "dq": 4 * tile_t + 2 * tile_s + tile_p + tile_o + 2 * row,
            "dkv": 4 * tile_t + 2 * tile_s + 2 * tile_p + 2 * tile_o
            + 2 * row}[kernel]


def kernel_candidates(head_dim: int, dtype, kind: str) -> Dict[str, list]:
    """The card's candidates for each kernel: its built tiles
    (``KERNEL_TILES``) whose shared memory fits the device kind's opt-in
    limit, default first; empty where none is built or fits. A function
    of its arguments alone (no card needed)."""
    limit = smem_limit(kind)
    table = KERNEL_TILES.get((dtype, head_dim), {})
    return {k: [t for t in table.get(k, ())
                if _est_smem_bytes(k, *t, head_dim, dtype) <= limit]
            for k in FLASH_KERNELS}


def _finite_max(m):
    """The running max with -inf (a row that has seen only masked scores)
    read as 0, so exp(s - max) is exp(-inf) = 0 for masked s and never
    exp(-inf - -inf): the TPU kernels' guards, without NaNs that a where()
    would keep in its gradient."""
    return torch.where(torch.isneginf(m), torch.zeros_like(m), m)


# ---------------------------------------------------------------- blockwise


def blockwise_attention(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        block_k: int = 256) -> torch.Tensor:
    """Online-softmax attention, scanning KV blocks; [B, L, H, D] layout.
    q is scaled in its own dtype (the scale rounded to it) before the fp32
    products, as the JAX scan does; output in q's dtype."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    blk = min(block_k, Lk)
    if Lk % blk:
        raise ValueError(f"seq len {Lk} not divisible by block_k {blk}")
    dev = q.device
    qpos = torch.arange(Lq, device=dev)
    qs = (q * torch.tensor(sm_scale, dtype=q.dtype, device=dev)).float()
    o = torch.zeros(B, Lq, H, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, Lq), _NEG_INF, device=dev)
    l = torch.zeros(B, H, Lq, device=dev)
    for k0 in range(0, Lk, blk):
        s = torch.einsum("bqhd,bkhd->bhqk", qs, k[:, k0:k0 + blk].float())
        if causal:
            kpos = k0 + torch.arange(blk, device=dev)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        mf = _finite_max(m_new)
        p = torch.exp(s - mf[..., None])
        corr = torch.exp(m - mf)
        l = l * corr + p.sum(-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(v.dtype).float(),
            v[:, k0:k0 + blk].float())
        m = m_new
    o = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype)


def pick_block(L: int, preferred: int = 256, min_block: int = 8
               ) -> Optional[int]:
    """Largest block size <= preferred that divides L; None when no
    divisor >= min_block exists (the JAX package's Mosaic floor is 8)."""
    for b in (preferred, 128, 64, 32, 16, 8, 4, 2, 1):
        if min_block <= b <= preferred and L % b == 0:
            return min(b, L)
    return None


# ----------------------------------------------------- the plain versions


def _blocks(Lq: int, Lk: int, blk_q: int, blk_k: int):
    """The blocks the dispatchers take, as the JAX package: each at most
    L, and dividing it."""
    blk_q, blk_k = min(blk_q, Lq), min(blk_k, Lk)
    if Lq % blk_q or Lk % blk_k:
        raise ValueError(f"L ({Lq},{Lk}) must divide blocks ({blk_q},{blk_k})")
    return blk_q, blk_k


def _scores(qb, kb, q0, k0, causal, sm_scale):
    """s = (q . k in fp32) * sm_scale for one block pair, -inf where a
    query (position from 0) precedes the key (causal)."""
    s = torch.bmm(qb, kb.transpose(1, 2)) * sm_scale
    if causal:
        qpos = q0 + torch.arange(qb.shape[1], device=qb.device)
        kpos = k0 + torch.arange(kb.shape[1], device=qb.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], _NEG_INF)
    return s


def _fwd_reference(q, k, v, causal: bool, sm_scale: float,
                   blk_q: int = 256, blk_k: int = 256):
    """Plain flash forward on [BH, L, D]: (o in q's dtype, lse fp32
    [BH, Lq]), block by block as the TPU's ``_fwd_kernel``. A block that
    does not divide L leaves a shorter last block, as the CUDA kernels'
    masked last tiles do (the dispatchers take only dividing blocks)."""
    if q.is_cuda:
        _count("flash_attention_fwd_reference_cuda")
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    blk_q, blk_k = min(blk_q, Lq), min(blk_k, Lk)
    kf, vf = k.float(), v.float()
    o = torch.empty_like(q)
    lse = torch.empty(BH, Lq, dtype=torch.float32, device=q.device)
    for q0 in range(0, Lq, blk_q):
        qb = q[:, q0:q0 + blk_q].float()
        rows = qb.shape[1]          # the last block may be shorter
        acc = torch.zeros(BH, rows, D, dtype=torch.float32, device=q.device)
        m = torch.full((BH, rows), _NEG_INF, device=q.device)
        l = torch.zeros(BH, rows, device=q.device)
        for k0 in range(0, Lk, blk_k):
            if causal and k0 > q0 + blk_q - 1:
                break   # above the diagonal: skipped, as the kernel does
            s = _scores(qb, kf[:, k0:k0 + blk_k], q0, k0, causal, sm_scale)
            m_new = torch.maximum(m, s.amax(-1))
            mf = _finite_max(m_new)
            p = torch.exp(s - mf[..., None])        # a masked score gives 0
            corr = torch.exp(m - mf)                # 0 while m is -inf
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.bmm(
                p.to(v.dtype).float(), vf[:, k0:k0 + blk_k])
            m = m_new
        l = l.clamp_min(1e-30)
        o[:, q0:q0 + blk_q] = (acc / l[..., None]).to(q.dtype)
        lse[:, q0:q0 + blk_q] = m + torch.log(l)
    return o, lse


def _bwd_reference(q, k, v, lse, do, delta, causal: bool, sm_scale: float,
                   blk_q: int = 256, blk_k: int = 256):
    """Plain flash backward on [BH, L, D]: (dq, dk, dv) in q's, k's and
    v's dtypes from the forward's lse and delta = rowsum(do * o) - dlse,
    block by block as the TPU's ``_dq_kernel`` and ``_dkv_kernel``: p in
    do's dtype before p^T . do, ds in k's / q's dtype before each product,
    fp32 sums. Blocks as in ``_fwd_reference``."""
    if q.is_cuda:
        _count("flash_attention_bwd_reference_cuda")
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    blk_q, blk_k = min(blk_q, Lq), min(blk_k, Lk)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros(BH, Lq, D, dtype=torch.float32, device=q.device)
    dk = torch.zeros(BH, Lk, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Lq, blk_q):
        qs = slice(q0, q0 + blk_q)
        for k0 in range(0, Lk, blk_k):
            if causal and k0 > q0 + blk_q - 1:
                break
            ks = slice(k0, k0 + blk_k)
            s = _scores(qf[:, qs], kf[:, ks], q0, k0, causal, sm_scale)
            p = torch.exp(s - lse[:, qs, None])
            dv[:, ks] += torch.bmm(p.to(do.dtype).float().transpose(1, 2),
                                   dof[:, qs])
            dp = torch.bmm(dof[:, qs], vf[:, ks].transpose(1, 2))
            ds = p * (dp - delta[:, qs, None])
            dq[:, qs] += torch.bmm(ds.to(k.dtype).float(), kf[:, ks]) \
                * sm_scale
            dk[:, ks] += torch.bmm(ds.to(q.dtype).float().transpose(1, 2),
                                   qf[:, qs]) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ the kernels


def _check_kernel_inputs(q, k, v, rows=(), stats=()):
    """Raise on what the CUDA kernels do not take. q [BH, Lq, D], k/v
    [BH, Lk, D]; ``rows`` are further [BH, Lq, D] tensors in q's dtype,
    ``stats`` fp32 [BH, Lq] ones, both as (name, tensor)."""
    tensors = [("q", q), ("k", k), ("v", v), *rows, *stats]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (vector loads)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype}: the kernels take fp32 or bf16")
    for name, t in [("k", k), ("v", v), *rows]:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}: the "
                            f"kernels take one dtype")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("the kernels take [BH, L, D] tensors")
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    if k.shape != (BH, Lk, D) or v.shape != k.shape or any(
            t.shape != q.shape for _, t in rows):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    for name, t in stats:
        if t.dtype != torch.float32 or t.shape != (BH, Lq):
            raise ValueError(f"{name} must be fp32 [BH, Lq] = {(BH, Lq)}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernels are built for "
                         f"{KERNEL_HEAD_DIMS}")
    if Lq < 1 or Lk < 1:
        raise ValueError(f"L ({Lq},{Lk}) must be at least 1")
    return BH, Lq, Lk, D


def _launch(library: str, entry: str, device, *args) -> None:
    """Call a kernel's C entry point with tensors passed as pointers, on
    the device's current stream; raise if the launch failed."""
    _kernels.launch(library, entry, device, *args)
    _count(entry)


def _launch_tile(library: str, entry: str, tile, device, *args) -> None:
    """``_launch`` of the tile variant ``tile``: (blk_q, blk_k) go in
    before sm_scale, the last of ``args``; counted in ``variant_launches``
    too."""
    *rest, sm_scale = args
    _launch(library, entry, device, *rest, *tile, sm_scale)
    with _count_lock:
        key = (entry, tuple(tile))
        variant_launches[key] = variant_launches.get(key, 0) + 1


def _fwd_cuda(q, k, v, causal: bool, sm_scale: float, tile=None):
    """The forward kernel's variant ``tile`` (default: the first built)."""
    BH, Lq, Lk, D = _check_kernel_inputs(q, k, v)
    tile = _kernel_tile("fwd", q.dtype, D, tile)
    o = torch.empty_like(q)
    lse = torch.empty(BH, Lq, dtype=torch.float32, device=q.device)
    _launch_tile("flash_attention_fwd", "flash_attention_fwd", tile,
                 q.device, _DTYPE_CODES[q.dtype], q, k, v, o, lse, BH, Lq,
                 Lk, D, int(causal), float(sm_scale))
    return o, lse


def _launch_dq(q, k, v, do, lse, delta, dq, causal: bool, sm_scale: float,
               tile) -> None:
    """The dq kernel's variant ``tile`` into dq; lse and delta padded to
    LSE_PAD columns (``_bwd_cuda`` pads them)."""
    BH, Lq, D = q.shape
    _launch_tile("flash_attention_bwd", "flash_attention_dq", tile,
                 q.device, _DTYPE_CODES[q.dtype], q, k, v, do, lse, delta,
                 dq, BH, Lq, k.shape[1], D, int(causal), float(sm_scale))


def _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal: bool,
                sm_scale: float, tile) -> None:
    """The dk/dv kernel's variant ``tile`` into dk and dv, as
    ``_launch_dq``."""
    BH, Lq, D = q.shape
    _launch_tile("flash_attention_bwd", "flash_attention_dkv", tile,
                 q.device, _DTYPE_CODES[q.dtype], q, k, v, do, lse, delta,
                 dk, dv, BH, Lq, k.shape[1], D, int(causal),
                 float(sm_scale))


def _bwd_cuda(q, k, v, lse, do, delta, causal: bool, sm_scale: float,
              tiles=None):
    """The dq and dk/dv kernels, at ``tiles.dq`` and ``tiles.dkv``
    (default: each kernel's first built tile)."""
    BH, Lq, Lk, D = _check_kernel_inputs(
        q, k, v, rows=[("do", do)], stats=[("lse", lse), ("delta", delta)])
    dq_tile = _kernel_tile("dq", q.dtype, D, tiles and tiles.dq)
    dkv_tile = _kernel_tile("dkv", q.dtype, D, tiles and tiles.dkv)
    pad = -Lq % LSE_PAD
    if pad:   # a copy of BH * Lq floats, only where 64 does not divide Lq
        lse, delta = (torch.nn.functional.pad(t, (0, pad))
                      for t in (lse, delta))
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_dq(q, k, v, do, lse, delta, dq, causal, sm_scale, dq_tile)
    _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, sm_scale, dkv_tile)
    return dq, dk, dv


def _fwd_call(q, k, v, causal: bool, sm_scale: float, blk_q: int = 256,
              blk_k: int = 256, tiles: Optional[FlashTiles] = None):
    """Flash forward on [BH, L, D] -> (o, lse [BH, Lq]): the kernel for
    CUDA tensors, the plain version for CPU tensors. The blocks must
    divide L on both (the kernel launches its default tile). ``tiles``,
    when given, takes their place: ``tiles.fwd`` is the kernel's variant,
    or the plain version's blocks."""
    Lq, Lk = q.shape[1], k.shape[1]
    if tiles is None:
        blk_q, blk_k = _blocks(Lq, Lk, blk_q, blk_k)
    if q.is_cuda:
        return _fwd_cuda(q, k, v, causal, sm_scale, tiles and tiles.fwd)
    if tiles is not None:
        blk_q, blk_k = _blocks(Lq, Lk, *tiles.fwd)
    return _fwd_reference(q, k, v, causal, sm_scale, blk_q, blk_k)


def _bwd_call(q, k, v, o, lse, do, causal: bool, sm_scale: float,
              blk_q: int = 256, blk_k: int = 256, dlse=None,
              tiles: Optional[FlashTiles] = None):
    """Flash backward on [BH, L, D] -> (dq, dk, dv). delta is a plain
    reduction outside the kernels, as in the JAX package; an lse
    cotangent folds into it: ds = p (dp - delta + dlse), since
    d lse / d s = p. ``tiles`` as in ``_fwd_call``: ``tiles.dq`` and
    ``tiles.dkv`` for the two kernels, or their plain versions' blocks."""
    Lq, Lk = q.shape[1], k.shape[1]
    if tiles is None:
        blk_q, blk_k = _blocks(Lq, Lk, blk_q, blk_k)
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    if q.is_cuda:
        return _bwd_cuda(q, k, v, lse, do, delta, causal, sm_scale, tiles)
    if tiles is None:
        return _bwd_reference(q, k, v, lse, do, delta, causal, sm_scale,
                              blk_q, blk_k)
    dq_blocks = _blocks(Lq, Lk, *tiles.dq)
    dkv_blocks = _blocks(Lq, Lk, *tiles.dkv)
    dq, dk, dv = _bwd_reference(q, k, v, lse, do, delta, causal, sm_scale,
                                *dkv_blocks)
    if dq_blocks != dkv_blocks:
        dq = _bwd_reference(q, k, v, lse, do, delta, causal, sm_scale,
                            *dq_blocks)[0]
    return dq, dk, dv


# ----------------------------------------------------- public, with autograd


def _bhl(x):
    """[B, L, H, D] -> contiguous [B·H, L, D], a copy: the kernels take that
    layout (reading [B, L, H, D] through strides would save the copy)."""
    B, L, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, L, D).contiguous()


def _blhd(x, B: int, H: int):
    BH, L, D = x.shape
    return x.reshape(B, H, L, D).transpose(1, 2)


class _FlashBlock(torch.autograd.Function):
    """(o, lse) of q against one KV block; the backward runs the dq and
    dk/dv kernels (or their plain versions) with lse's cotangent folded
    into delta, as ``flash_attention_block``'s custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, blk_q, blk_k, tiles):
        B, Lq, H, _ = q.shape
        qb, kb, vb = _bhl(q), _bhl(k), _bhl(v)
        o, lse = _fwd_call(qb, kb, vb, causal, sm_scale, blk_q, blk_k, tiles)
        ctx.save_for_backward(qb, kb, vb, o, lse)
        ctx.args = (causal, sm_scale, blk_q, blk_k, tiles, B, H)
        ctx.set_materialize_grads(False)
        return _blhd(o, B, H), lse.reshape(B, H, Lq)

    @staticmethod
    def backward(ctx, do, dlse):
        qb, kb, vb, o, lse = ctx.saved_tensors
        causal, sm_scale, blk_q, blk_k, tiles, B, H = ctx.args
        do = torch.zeros_like(o) if do is None else _bhl(do)
        if dlse is not None:
            dlse = dlse.reshape(lse.shape)
        dq, dk, dv = _bwd_call(qb, kb, vb, o, lse, do, causal, sm_scale,
                               blk_q, blk_k, dlse=dlse, tiles=tiles)
        return (_blhd(dq, B, H), _blhd(dk, B, H), _blhd(dv, B, H),
                None, None, None, None, None)


def _resolve_blocks(q, k, blk_q, blk_k):
    """(blk_q, blk_k, tiles) of a call, as the JAX package resolves its
    blocks: both given, they block the plain versions (the kernels launch
    their default tiles); None takes the tuned entry of this shape
    (``get_tuned_blocks``), whole when both are None, its forward pair
    for the one that is; without an entry, 256."""
    if blk_q is not None and blk_k is not None:
        return blk_q, blk_k, None
    tuned = get_tuned_blocks(q.shape[1], k.shape[1], q.shape[-1], q.dtype,
                             q.device)
    if tuned is None:
        return (256 if blk_q is None else blk_q,
                256 if blk_k is None else blk_k, None)
    if blk_q is None and blk_k is None:
        return (*tuned.fwd, tuned)
    return (tuned.fwd[0] if blk_q is None else blk_q,
            tuned.fwd[1] if blk_k is None else blk_k, None)


def flash_attention_block(q, k, v, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          blk_q: Optional[int] = 256,
                          blk_k: Optional[int] = 256, *,
                          tiles: Optional[FlashTiles] = None):
    """Fused attention of q [B, Lq, H, D] against ONE KV block: returns
    (o [B, Lq, H, D], lse [B, H, Lq]). lse is differentiable: its
    cotangent (nonzero when block results are merged by log-sum-exp)
    folds into the backward's delta, so the same kernels serve both.
    ``blk_q``/``blk_k`` None: the tuned entry, as ``flash_attention``;
    ``tiles`` names each kernel's tile outright (the blocks then unused)."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if tiles is None:
        blk_q, blk_k, tiles = _resolve_blocks(q, k, blk_q, blk_k)
    return _FlashBlock.apply(q, k, v, causal, scale, blk_q, blk_k, tiles)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    blk_q: Optional[int] = 256,
                    blk_k: Optional[int] = 256) -> torch.Tensor:
    """[B, L, H, D] flash attention, forward and backward through the
    kernels on CUDA tensors (the plain versions on CPU tensors). The
    facade over ``flash_attention_block``: the discarded lse has no
    cotangent. ``blk_q``/``blk_k`` block the plain versions; None uses
    the tuned entry for this (L, head dim, dtype, platform) when
    ``autotune_blocks`` cached one (each kernel's variant on the card),
    else 256 and the kernels' default tiles."""
    return flash_attention_block(q, k, v, causal, sm_scale, blk_q, blk_k)[0]


# ------------------------------------------------------- block autotuning
#
# Sweep and cache per (Lq, Lk, head_dim, dtype, platform), as the JAX
# package does. On the CPU the candidates are the JAX package's (divisor
# pairs ranked by their distance from 256 x 256) and nothing is timed
# unless asked; on the card they are each kernel's built variants that fit
# its shared memory, and a sweep times each kernel's on its own (a sum of
# candidates, not a product).

_BLOCK_CACHE: dict = {}
_BLOCK_SIZES = (512, 256, 128, 64, 32, 16, 8)
#: the JAX package's model of its Pallas kernels' resident VMEM and its
#: budget (12 MB a core): kept for the CPU's candidate list, which is the
#: JAX package's (the plain versions block as those kernels do)
_PALLAS_VMEM_BUDGET = 12 * 1024 * 1024
#: the most recent measured sweep: {kernel: {tile: ms}}
last_sweep: Dict[str, Dict[tuple, float]] = {}
#: the heads a sweep times each variant on: the JAX package's 8 heads at
#: L 2048 would fill less than one wave of the card's 132 SMs
SWEEP_HEADS = 64


def clear_block_cache() -> None:
    _BLOCK_CACHE.clear()


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _device(device=None) -> torch.device:
    """``device``; None is the card (the port's default device), which
    raises without one (``resolve_device``), as asking for "cuda" does:
    nothing here falls back to the CPU by itself."""
    return resolve_device("cuda" if device is None else device)


def _platform(device=None) -> str:
    """The cache key's platform: "cpu", or the card's name."""
    device = _device(device)
    if device.type != "cuda":
        return device.type
    index = device.index
    return _card_name(torch.cuda.current_device() if index is None
                      else index)


def _block_cache_key(Lq, Lk, head_dim, dtype, device=None):
    return (int(Lq), int(Lk), int(head_dim),
            str(dtype).removeprefix("torch."), _platform(device))


def get_tuned_blocks(Lq, Lk, head_dim, dtype,
                     device=None) -> Optional[FlashTiles]:
    """Cache-only lookup of a tuned ``FlashTiles`` (no sweep); None when
    this shape was never tuned on this platform."""
    return _BLOCK_CACHE.get(_block_cache_key(Lq, Lk, head_dim, dtype,
                                             device))


def _est_pallas_vmem_bytes(blk_q: int, blk_k: int, D: int,
                           itemsize: int) -> int:
    """The JAX package's resident-VMEM model of its Pallas kernels:
    operand blocks in their dtype + fp32 accumulators and score tiles."""
    operand = itemsize * (2 * blk_q * D + 2 * blk_k * D)
    accum = 4 * (3 * blk_q * D + 2 * blk_q * 128 + 2 * blk_q * blk_k)
    return operand + accum


def block_candidates(Lq: int, Lk: int, head_dim: int,
                     dtype=torch.bfloat16) -> list:
    """The CPU's candidates, the JAX package's: (blk_q, blk_k) pairs that
    divide the lengths, at least 8, within the Pallas VMEM model, the
    heuristic's best first (closest to 256 x 256). The card's are
    ``kernel_candidates``."""
    itemsize = dtype.itemsize
    qs = [b for b in _BLOCK_SIZES if b <= Lq and Lq % b == 0]
    ks = [b for b in _BLOCK_SIZES if b <= Lk and Lk % b == 0]
    pairs = [(bq, bk) for bq in qs for bk in ks
             if _est_pallas_vmem_bytes(bq, bk, head_dim, itemsize)
             <= _PALLAS_VMEM_BUDGET]
    return sorted(pairs, key=lambda p: (abs(p[0] - 256) + abs(p[1] - 256),
                                        -(p[0] * p[1])))


def kernels_supported(device=None) -> bool:
    """True when the Hopper kernels can run on ``device`` (default: the
    card; raises without one): a CUDA device of compute capability 9.0."""
    device = _device(device)
    return device.type == "cuda" and \
        torch.cuda.get_device_capability(device) == (9, 0)


def _time_blocks(Lq, Lk, D, dtype, blk_q, blk_k, *, kernel: str = "fwd",
                 device=None, bh: int = SWEEP_HEADS, reps: int = 3) -> float:
    """Device ms of one kernel's variant (blk_q, blk_k): one launch on
    random [bh, L, D] inputs, causal, warmed, the median of ``reps``, each
    between CUDA events behind a ~1 ms spin, so the host's enqueue is not
    counted (chip_smoke.py's ``time_ms``), on ``SWEEP_HEADS`` heads.
    Raises where there is no card: there is no kernel to time. A launch
    that fails raises too."""
    device = _device(device)
    if device.type != "cuda":
        raise RuntimeError("_time_blocks times a CUDA kernel; on "
                           f"{device} there is none")
    g = torch.Generator(device=device).manual_seed(0)
    q, do = (torch.randn(bh, Lq, D, generator=g, device=device).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, Lk, D, generator=g, device=device).to(dtype)
            for _ in range(2))
    scale = D ** -0.5
    tile = (blk_q, blk_k)
    if kernel == "fwd":
        def run():
            _fwd_cuda(q, k, v, True, scale, tile)
    else:
        o, lse = _fwd_cuda(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1)
        pad = -Lq % LSE_PAD
        lse, delta = (torch.nn.functional.pad(t, (0, pad))
                      for t in (lse, delta))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if kernel == "dq":
            def run():
                _launch_dq(q, k, v, do, lse, delta, dq, True, scale, tile)
        else:
            def run():
                _launch_dkv(q, k, v, do, lse, delta, dk, dv, True, scale,
                            tile)
    run()
    torch.cuda.synchronize(device)
    times = []
    with torch.cuda.device(device):
        for _ in range(reps):
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def autotune_blocks(Lq: int, Lk: Optional[int] = None, head_dim: int = 64,
                    dtype=torch.bfloat16, *, measure: Optional[bool] = None,
                    device=None) -> Optional[FlashTiles]:
    """Pick each flash kernel's tile at this shape and cache the
    ``FlashTiles`` per (Lq, Lk, head_dim, dtype, platform); ``device``
    (default: the card; raises without one) names the platform.

    On the CPU: the JAX package's pick, shared by the three kernels (the
    heuristic's best, or with ``measure`` the fastest by ``_time_blocks``,
    which raises there); None when no block >= 8 divides the lengths. On
    the card: each kernel's candidates (``kernel_candidates``), timed one
    kernel at a time where there are two or more and ``measure`` is on;
    None when a kernel has none. ``measure`` None times only where the
    kernels run (``kernels_supported``). A candidate that fails raises: a
    listed variant is built and fits, so a failure is a fault. Call this
    eagerly (before a training step): the callers only read the cache."""
    Lk = Lq if Lk is None else Lk
    key = _block_cache_key(Lq, Lk, head_dim, dtype, device)
    if key in _BLOCK_CACHE:
        return _BLOCK_CACHE[key]
    if measure is None:
        measure = kernels_supported(device)
    if key[-1] == "cpu":
        cands = block_candidates(Lq, Lk, head_dim, dtype)
        if not cands:
            return None
        best = cands[0]
        if measure and len(cands) > 1:
            best = min(cands, key=lambda bk: _time_blocks(
                Lq, Lk, head_dim, dtype, *bk, device=device))
        tiles = FlashTiles.uniform(best)
    else:
        cands = kernel_candidates(head_dim, dtype, key[-1])
        if not all(cands.values()):
            return None
        picks = {}
        for kern, tiles_k in cands.items():
            picks[kern] = tiles_k[0]
            if measure and len(tiles_k) > 1:
                ms = {t: _time_blocks(Lq, Lk, head_dim, dtype, *t,
                                      kernel=kern, device=device)
                      for t in tiles_k}
                last_sweep[kern] = ms
                picks[kern] = min(ms, key=ms.get)
        tiles = FlashTiles(**picks)
    _BLOCK_CACHE[key] = tiles
    return tiles


def check_shard_geometry(q, k, v) -> None:
    """Raise unless q, k and v are one rank's plain [B, L, H, D] shards of
    one shape that the kernels take on the card (a head dim in
    ``KERNEL_HEAD_DIMS``, fp32 or bf16): a shard the kernels cannot take
    fails here, before any launch, and never falls back to the plain
    version."""
    from torch.distributed.tensor import DTensor
    for name, t in (("q", q), ("k", k), ("v", v)):
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a DTensor: flash_attention_sharded "
                            f"takes this rank's local shard")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)}: the shards must be "
                             f"[B, L, H, D] of q's shape {tuple(q.shape)}")
    if q.is_cuda:
        if q.shape[-1] not in KERNEL_HEAD_DIMS:
            raise ValueError(f"head dim {q.shape[-1]}: the kernels are "
                             f"built for {KERNEL_HEAD_DIMS}")
        if q.dtype not in _DTYPE_CODES:
            raise TypeError(f"dtype {q.dtype}: the kernels take fp32 or "
                            f"bf16")


def flash_attention_sharded(q, k, v, mesh, *, causal: bool = True):
    """Flash attention on this rank's shard of a mesh: q, k and v are the
    local [B / (dp * fsdp), L, H / tp, D] tensors (batch over dp and
    fsdp, heads over tp, the sequence whole), and each rank runs the
    kernels on its own, as the JAX package's ``shard_map`` runs them per
    shard. Raises when sp > 1 (the sequence is sharded: ring attention's
    case). No collective runs here."""
    from ray_tpu_torch.parallel.mesh import axis_size
    if axis_size(mesh, "sp") > 1:
        raise ValueError("flash_attention_sharded cannot shard the sequence "
                         "axis; sp > 1 needs ring attention")
    check_shard_geometry(q, k, v)
    # blk None: the tuned entry of the shard's shape, as the JAX package's
    # shard_map passes
    return flash_attention(q, k, v, causal, blk_q=None, blk_k=None)
