"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU and skip
elsewhere. They import neither JAX nor the JAX package, so they also run
on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops.int8 import quantize_kv

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
# Held per (token, head) against that row's own scale, since a token that
# sees many slots has small outputs: |got - want| <= rtol * max|want| + floor.
# fp32 output: summation order only. bf16 output: both sides round fp32
# values that differ by summation order, so they differ by at most one
# bf16 step of the row's largest value (2^-7 of it).
TOL = {F32: (1e-5, 1e-6), BF16: (2.0 ** -7, 1e-5)}
# (q dtype, pool dtype) pairs the engine runs: pools in q's dtype, or int8
PAIRS = [(F32, F32), (BF16, BF16), (F32, I8), (BF16, I8)]


def tolerance_ratio(got, want):
    """Worst |got - want| / (rtol * max|want| + floor) over (token, head);
    at most 1 passes."""
    rtol, floor = TOL[want.dtype]
    err = (got.float() - want.float()).abs().amax(-1)
    return (err / (rtol * want.float().abs().amax(-1) + floor)).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _mixed_batch(device, Hq, Hkv, D, ps, pages=12, seed=0):
    """tests/test_ragged.py's layout: 2 decode rows, an inactive row, a
    page-straddling chunk and a first chunk; tokens 13..15 are padding."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(16, Hq, D, generator=g, device=device)
    kp = torch.randn(pages, Hkv, ps, D, generator=g, device=device)
    vp = torch.randn(pages, Hkv, ps, D, generator=g, device=device)
    desc = [torch.tensor(x, dtype=torch.int32, device=device) for x in (
        [[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0], [9, 10, 11, 1],
         [2, 3, 4, 5]],
        [0, 1, 0, 3, 9], [1, 1, 0, 6, 4], [11, 24, 0, 21, 4])]
    return q, kp, vp, *desc


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,D,ps", [
    (8, 8, 128, 8), (8, 4, 128, 16), (8, 1, 128, 16), (32, 8, 128, 16)])
def test_ragged_kernel_matches_plain_version(cuda, Hq, Hkv, D, ps):
    q, kp, vp, pt, qs, ql, kl = _mixed_batch(cuda, Hq, Hkv, D, ps)
    for qdt, pools in PAIRS:
        if pools == I8:
            k, ksc = quantize_kv(kp)
            v, vsc = quantize_kv(vp)
            sc = dict(k_scale=ksc, v_scale=vsc)
        else:
            k, v, sc = kp.to(pools), vp.to(pools), {}
        qx = q.to(qdt)
        before = tpa.launch_counts["ragged_paged_attention"]
        got = tpa.ragged_paged_attention(qx, k, v, pt, qs, ql, kl, **sc)
        want = tpa.ragged_paged_attention_reference(qx, k, v, pt, qs, ql,
                                                    kl, **sc)
        torch.cuda.synchronize()
        assert tpa.launch_counts["ragged_paged_attention"] == before + 1
        assert got.dtype == qdt and got.shape == q.shape
        ratio = tolerance_ratio(got, want)
        assert ratio <= 1, (qdt, pools, ratio)
        assert bool((got[13:] == 0).all()), "padding tokens not 0"


@pytest.mark.cuda
def test_ragged_kernel_rejects_what_it_does_not_take(cuda):
    q, kp, vp, pt, qs, ql, kl = _mixed_batch(cuda, 8, 4, 128, 16)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.ragged_paged_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), kp, vp, pt, qs, ql, kl)
    with pytest.raises(TypeError, match="int32"):
        tpa.ragged_paged_attention(q, kp, vp, pt.long(), qs, ql, kl)
    with pytest.raises(TypeError):
        tpa.ragged_paged_attention(q.half(), kp, vp, pt, qs, ql, kl)
    with pytest.raises(TypeError, match="pool dtypes"):   # mixed fp pair
        tpa.ragged_paged_attention(q.bfloat16(), kp, vp, pt, qs, ql, kl)
    q64, kp64, vp64, *_ = _mixed_batch(cuda, 8, 4, 64, 16)
    with pytest.raises(ValueError, match="head dim"):
        tpa.ragged_paged_attention(q64, kp64, vp64, pt, qs, ql, kl)
    with pytest.raises(ValueError, match="reference"):
        tpa.ragged_paged_attention(q, kp, vp, pt, qs, ql, kl,
                                   impl="reference")
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(q, kp.cpu(), vp, pt, qs, ql, kl)
