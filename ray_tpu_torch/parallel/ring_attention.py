"""Ring attention: blockwise attention with the KV blocks rotating around
the ``sp`` ring — the PyTorch port of ``ray_tpu/parallel/ring_attention.py``.

Each ``sp`` rank holds one contiguous block of the sequence (rank r the
positions [r·L/sp, (r+1)·L/sp)). Over ``sp`` rotations every rank
attends its queries to the KV block it holds, then passes that block on
(``collectives.ppermute_shift`` of K and V stacked into one tensor: rank
i's block goes to rank i + 1, so at rotation t rank idx holds the block
of rank (idx - t) mod sp). Causal attention skips the blocks from later
ranks; every rank still calls the shift on every rotation but the last
(no rank uses the last one's result, and a collective one rank skips
would hang the others). For the same reason the last block held is tied
into the output with weight 0 (``collectives.tie``): autograd then runs every
shift's backward on every rank, in the chain's order, even where a rank
attended none of the blocks it passed on.

Two paths, as in the JAX package:
  - the einsum ring (``use_kernel=False``; what CPU tensors run by
    default): fp32 scores per block, online softmax statistics
    (``_block_update``), normalized at the end;
  - the fused ring (CUDA tensors by default): per rotation one
    ``ops.flash_attention.flash_attention_block`` call (the flash kernels
    on the card; causal on the diagonal block, non-causal on earlier
    blocks), whose normalized output and logsumexp merge into the running
    result by log-sum-exp (``_merge_blocks``). The lse stays
    differentiable: its cotangent folds into the backward kernels' delta.
    ``ring_rotation`` is one rotation's work.

The JAX package's Mosaic fallback warning and its strict switch have no
counterpart: on the card a shard the kernels cannot take raises
(``check_shard_geometry``), and nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.parallel.collectives import ppermute_shift, tie
from ray_tpu_torch.parallel.mesh import axis_index, axis_size

_NEG_INF = float("-inf")

#: the path the last ring_attention call took ("fused" | "einsum")
_LAST_PATH = {"path": None}


def last_ring_path() -> Optional[str]:
    return _LAST_PATH["path"]


def _finite(m):
    """-inf read as 0, so exp(x - m) never meets -inf - -inf."""
    return torch.where(torch.isneginf(m), torch.zeros_like(m), m)


def _block_update(o, m, l, s, v):
    """One online-softmax accumulation step.

    o: [B, Lq, H, D] fp32 running numerator; m, l: [B, H, Lq] running max
    and denominator; s: [B, H, Lq, Lk] scores (-inf where masked);
    v: [B, Lk, H, D]."""
    m_new = torch.maximum(m, s.amax(-1))
    mf = _finite(m_new)
    p = torch.exp(s - mf[..., None])          # a masked score gives 0
    corr = torch.exp(m - mf)                  # 0 while m is -inf
    l_new = l * corr + p.sum(-1)
    o_new = o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float())
    return o_new, m_new, l_new


def _merge_blocks(o1, lse1, o2, lse2):
    """Log-sum-exp merge of two normalized attention results.

    o*: [B, Lq, H, D] fp32 (softmax-normalized); lse*: [B, H, Lq] fp32.
    An lse of -inf marks "no keys seen yet" and weighs 0."""
    m = torch.maximum(lse1, lse2)
    mf = _finite(m)
    w1, w2 = torch.exp(lse1 - mf), torch.exp(lse2 - mf)
    denom = (w1 + w2).clamp_min(1e-30)
    wt1 = (w1 / denom).transpose(1, 2)[..., None]
    wt2 = (w2 / denom).transpose(1, 2)[..., None]
    return o1 * wt1 + o2 * wt2, m + torch.log(denom)


def fused_blocks(Lq: int, Lk: int, head_dim: int, dtype, device=None):
    """The fused ring's blocks per rotation, as the JAX package's
    ``_resolve_fused_blocks``: the tuned entry of the shard's shape
    (``ops.flash_attention.autotune_blocks``, the shared cache) when one
    is cached, a ``FlashTiles``; otherwise the divisor heuristic of
    interpret mode, (blk_q, blk_k): the largest divisor up to 256, no
    floor, which blocks the plain versions (the CUDA kernels then launch
    their default tiles)."""
    from ray_tpu_torch.ops.flash_attention import get_tuned_blocks, pick_block
    tuned = get_tuned_blocks(Lq, Lk, head_dim, dtype, device)
    if tuned is not None:
        return tuned
    return pick_block(Lq, min_block=1), pick_block(Lk, min_block=1)


def ring_rotation(q, kt, vt, o, lse, src: int, idx: int, causal: bool,
                  sm_scale: float, blocks=None):
    """One rotation of the fused ring on the rank ``idx``, holding the KV
    block ``kt``/``vt`` of rank ``src``: (o, lse) with that block
    attended and merged in. Causal: the diagonal block (src == idx)
    attends causally, an earlier one (src < idx) fully, a later one is
    skipped (o and lse come back as they were). o: [B, Lq, H, D] fp32,
    lse: [B, H, Lq] fp32 (-inf before the first block). ``blocks``: what
    ``fused_blocks`` gives (a tuned ``FlashTiles``, or a pair)."""
    if causal and src > idx:
        return o, lse
    from ray_tpu_torch.ops.flash_attention import (FlashTiles,
                                                   flash_attention_block)
    blocks = blocks or fused_blocks(q.shape[1], kt.shape[1], q.shape[-1],
                                    q.dtype, q.device)
    tiles = blocks if isinstance(blocks, FlashTiles) else None
    blk_q, blk_k = tiles.fwd if tiles else blocks
    ob, lb = flash_attention_block(q, kt, vt, causal and src == idx,
                                   sm_scale, blk_q, blk_k, tiles=tiles)
    return _merge_blocks(o, lse, ob.float(), lb)


def _ring_fused(q, k, v, mesh, axis_name, causal, sm_scale):
    n = axis_size(mesh, axis_name)
    idx = axis_index(mesh, axis_name)
    B, Lq, H, D = q.shape
    blocks = fused_blocks(Lq, k.shape[1], D, q.dtype, q.device)
    o = torch.zeros(B, Lq, H, D, dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Lq), _NEG_INF, device=q.device)
    kv = torch.stack([k, v])
    for t in range(n):
        o, lse = ring_rotation(q, kv[0], kv[1], o, lse, (idx - t) % n, idx,
                               causal, sm_scale, blocks)
        if t < n - 1:
            kv = ppermute_shift(kv, mesh, axis_name)
    return tie(o, kv).to(q.dtype)


def _ring_einsum(q, k, v, mesh, axis_name, causal, sm_scale):
    n = axis_size(mesh, axis_name)
    idx = axis_index(mesh, axis_name)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    qf = q.float() * sm_scale
    o = torch.zeros(B, Lq, H, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Lq), _NEG_INF, device=q.device)
    l = torch.zeros(B, H, Lq, device=q.device)
    qpos = idx * Lq + torch.arange(Lq, device=q.device)
    kv = torch.stack([k, v])
    for t in range(n):
        src = (idx - t) % n
        # blocks strictly in the future are fully masked: skip their work
        if not causal or src <= idx:
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kv[0].float())
            if causal:
                kpos = src * Lk + torch.arange(Lk, device=q.device)
                s = s.masked_fill(qpos[:, None] < kpos[None, :], _NEG_INF)
            o, m, l = _block_update(o, m, l, s, kv[1])
        if t < n - 1:
            kv = ppermute_shift(kv, mesh, axis_name)
    o = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return tie(o, kv).to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = True, sm_scale: Optional[float] = None,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Ring attention over ``axis_name`` on this rank's blocks.

    q, k, v: [B, L_local, H, D], contiguous sequence blocks in ring order
    along the axis. Returns [B, L_local, H, D] in q's dtype.

    use_kernel: the fused ring (flash blocks) or the einsum ring; None
    takes the fused ring for CUDA tensors and the einsum ring for CPU
    tensors. True on CPU tensors runs the fused ring's structure over
    the plain flash versions."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if use_kernel is None:
        use_kernel = q.is_cuda
    _LAST_PATH["path"] = "fused" if use_kernel else "einsum"
    fn = _ring_fused if use_kernel else _ring_einsum
    return fn(q, k, v, mesh, axis_name, causal, sm_scale)


def ring_attention_sharded(q, k, v, mesh, *, causal: bool = True,
                           seq_axis: str = "sp",
                           use_kernel: Optional[bool] = None
                           ) -> torch.Tensor:
    """Ring attention on this rank's shard of a mesh: the local
    [B / (dp·fsdp), L / sp, H / tp, D] tensors (batch over dp and fsdp,
    the sequence over ``seq_axis``, heads over tp), as the JAX
    ``shard_map`` wrapper hands each device its block. On the card a
    shard the flash kernels cannot take raises before any launch."""
    from ray_tpu_torch.ops.flash_attention import check_shard_geometry
    check_shard_geometry(q, k, v)
    return ring_attention(q, k, v, mesh, seq_axis, causal,
                          use_kernel=use_kernel)
