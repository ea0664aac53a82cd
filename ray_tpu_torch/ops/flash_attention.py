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
    ``flash_dkv_sm90_kernel``). They pick their own tiles and take any
    length, masking the last q tile and key tile; the wrappers raise on
    what they do not take. There is no fallback from the
    card to the plain versions.
``_fwd_call`` / ``_bwd_call`` dispatch by the tensors' device.

``blockwise_attention`` is the pure-torch online-softmax scan over key
blocks, [B, L, H, D], as in the JAX package (q scaled in its own dtype).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ray_tpu_torch.ops import _kernels

_NEG_INF = float("-inf")

#: kernel launches made by the wrappers, and calls of the plain versions on
#: CUDA tensors (a run that should only use the kernels checks they stay 0)
launch_counts = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
                 "flash_attention_dkv": 0,
                 "flash_attention_fwd_reference_cuda": 0,
                 "flash_attention_bwd_reference_cuda": 0}
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


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the CUDA kernels are instantiated for (Llama: 128; bf16 at 64
#: takes the first designs, the Hopper designs being built for 128 only)
KERNEL_HEAD_DIMS = (64, 128)
#: the backward kernels read lse and delta as [BH, Lq rounded up to this],
#: the padding zeros, so that every 64-row piece comes whole and aligned
LSE_PAD = 64


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


def _fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    BH, Lq, Lk, D = _check_kernel_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(BH, Lq, dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", "flash_attention_fwd", q.device,
            _DTYPE_CODES[q.dtype], q, k, v, o, lse, BH, Lq, Lk, D,
            int(causal), float(sm_scale))
    return o, lse


def _bwd_cuda(q, k, v, lse, do, delta, causal: bool, sm_scale: float):
    BH, Lq, Lk, D = _check_kernel_inputs(
        q, k, v, rows=[("do", do)], stats=[("lse", lse), ("delta", delta)])
    code = _DTYPE_CODES[q.dtype]
    pad = -Lq % LSE_PAD
    if pad:   # a copy of BH * Lq floats, only where 64 does not divide Lq
        lse, delta = (torch.nn.functional.pad(t, (0, pad))
                      for t in (lse, delta))
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd", "flash_attention_dq", q.device, code,
            q, k, v, do, lse, delta, dq, BH, Lq, Lk, D, int(causal),
            float(sm_scale))
    _launch("flash_attention_bwd", "flash_attention_dkv", q.device, code,
            q, k, v, do, lse, delta, dk, dv, BH, Lq, Lk, D, int(causal),
            float(sm_scale))
    return dq, dk, dv


def _fwd_call(q, k, v, causal: bool, sm_scale: float, blk_q: int = 256,
              blk_k: int = 256):
    """Flash forward on [BH, L, D] -> (o, lse [BH, Lq]): the kernel for
    CUDA tensors, the plain version for CPU tensors. The blocks must
    divide L on both (the kernel tiles its own way)."""
    blk_q, blk_k = _blocks(q.shape[1], k.shape[1], blk_q, blk_k)
    if q.is_cuda:
        return _fwd_cuda(q, k, v, causal, sm_scale)
    return _fwd_reference(q, k, v, causal, sm_scale, blk_q, blk_k)


def _bwd_call(q, k, v, o, lse, do, causal: bool, sm_scale: float,
              blk_q: int = 256, blk_k: int = 256, dlse=None):
    """Flash backward on [BH, L, D] -> (dq, dk, dv). delta is a plain
    reduction outside the kernels, as in the JAX package; an lse
    cotangent folds into it: ds = p (dp - delta + dlse), since
    d lse / d s = p."""
    blk_q, blk_k = _blocks(q.shape[1], k.shape[1], blk_q, blk_k)
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    if q.is_cuda:
        return _bwd_cuda(q, k, v, lse, do, delta, causal, sm_scale)
    return _bwd_reference(q, k, v, lse, do, delta, causal, sm_scale,
                          blk_q, blk_k)


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
    def forward(ctx, q, k, v, causal, sm_scale, blk_q, blk_k):
        B, Lq, H, _ = q.shape
        qb, kb, vb = _bhl(q), _bhl(k), _bhl(v)
        o, lse = _fwd_call(qb, kb, vb, causal, sm_scale, blk_q, blk_k)
        ctx.save_for_backward(qb, kb, vb, o, lse)
        ctx.args = (causal, sm_scale, blk_q, blk_k, B, H)
        ctx.set_materialize_grads(False)
        return _blhd(o, B, H), lse.reshape(B, H, Lq)

    @staticmethod
    def backward(ctx, do, dlse):
        qb, kb, vb, o, lse = ctx.saved_tensors
        causal, sm_scale, blk_q, blk_k, B, H = ctx.args
        do = torch.zeros_like(o) if do is None else _bhl(do)
        if dlse is not None:
            dlse = dlse.reshape(lse.shape)
        dq, dk, dv = _bwd_call(qb, kb, vb, o, lse, do, causal, sm_scale,
                               blk_q, blk_k, dlse=dlse)
        return (_blhd(dq, B, H), _blhd(dk, B, H), _blhd(dv, B, H),
                None, None, None, None)


def flash_attention_block(q, k, v, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          blk_q: int = 256, blk_k: int = 256):
    """Fused attention of q [B, Lq, H, D] against ONE KV block: returns
    (o [B, Lq, H, D], lse [B, H, Lq]). lse is differentiable: its
    cotangent (nonzero when block results are merged by log-sum-exp)
    folds into the backward's delta, so the same kernels serve both."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return _FlashBlock.apply(q, k, v, causal, scale, blk_q, blk_k)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, blk_q: int = 256,
                    blk_k: int = 256) -> torch.Tensor:
    """[B, L, H, D] flash attention, forward and backward through the
    kernels on CUDA tensors (the plain versions on CPU tensors). The
    facade over ``flash_attention_block``: the discarded lse has no
    cotangent. ``blk_q``/``blk_k`` block the plain versions; the JAX
    package's autotuned blocks (``blk=None``) have no counterpart."""
    return flash_attention_block(q, k, v, causal, sm_scale, blk_q, blk_k)[0]


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
    return flash_attention(q, k, v, causal)
