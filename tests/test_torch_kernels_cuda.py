"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU and skip
elsewhere. They import neither JAX nor the JAX package, so they also run
on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import time

import pytest
import torch

from ray_tpu_torch.llm.engine import InferenceEngine
from ray_tpu_torch.llm.serve_llm import LLMServer
from ray_tpu_torch.models.llama import LlamaConfig, head_logits
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops.int8 import int8_matmul, quantize_kv

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
# Held per (token, head) against that row's own scale, since a token that
# sees many slots has small outputs: |got - want| <= rtol * max|want| + floor.
# fp32 output: summation order only. bf16 output: both sides round fp32
# values that differ by summation order, so they differ by at most one
# bf16 step of the row's largest value (2^-7 of it).
TOL = {F32: (1e-5, 1e-6), BF16: (2.0 ** -7, 1e-5)}
# Flash kernels vs their plain versions, bf16: the forward's 128-key tiles
# and the plain version's 256-key blocks rescale p by different running
# maxima before rounding it to bf16, which can move a row's terms by one
# more bf16 step: 2^-6 of the row's largest value (on the CPU the plain
# versions at the kernels' tiles against their 256-row blocks reach 0.495
# of it: tests/test_torch_flash_attention.py).
FLASH_TOL = {F32: (1e-5, 1e-6), BF16: (2.0 ** -6, 1e-5)}
# (q dtype, pool dtype) pairs the engine runs: pools in q's dtype, or int8
PAIRS = [(F32, F32), (BF16, BF16), (F32, I8), (BF16, I8)]


def tolerance_ratio(got, want, tol=TOL):
    """Worst |got - want| / (rtol * max|want| + floor) over the rows of
    the last axis; at most 1 passes."""
    rtol, floor = tol[want.dtype]
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
    (8, 8, 128, 8), (8, 4, 128, 16), (8, 1, 128, 16), (32, 8, 128, 16),
    # bench_llm.py's serving widths (head dim 64, pages of 32, 2 query heads
    # per kv head), and the other head dim 64 and page 32 neighbours
    (16, 8, 64, 32), (8, 1, 64, 8), (8, 4, 64, 16), (32, 8, 128, 32)])
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
    q96, kp96, vp96, *_ = _mixed_batch(cuda, 8, 4, 96, 16)
    with pytest.raises(ValueError, match="head dim"):
        tpa.ragged_paged_attention(q96, kp96, vp96, pt, qs, ql, kl)
    with pytest.raises(ValueError, match="reference"):
        tpa.ragged_paged_attention(q, kp, vp, pt, qs, ql, kl,
                                   impl="reference")
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(q, kp.cpu(), vp, pt, qs, ql, kl)
    # the bf16 kernel: pages of 8, 16 or 32 slots, 1, 2, 4 or 8 query
    # heads per kv head, and hints that make sense
    qb, kb, vb = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    with pytest.raises(ValueError, match="page size"):
        tpa.ragged_paged_attention(qb, kb.reshape(12, 4, 64, 32)
                                   .repeat(1, 1, 1, 4).contiguous(),
                                   vb.reshape(12, 4, 64, 32)
                                   .repeat(1, 1, 1, 4).contiguous(),
                                   pt, qs, ql, kl)
    q6, kp6, vp6, *_ = _mixed_batch(cuda, 6, 2, 128, 16)
    with pytest.raises(ValueError, match="query heads"):
        tpa.ragged_paged_attention(q6.bfloat16(), kp6.bfloat16(),
                                   vp6.bfloat16(), pt, qs, ql, kl)
    with pytest.raises(ValueError, match="decode_rows"):
        tpa.ragged_paged_attention(qb, kb, vb, pt, qs, ql, kl,
                                   decode_rows=-1)


def _ragged_rows(device, rows, T, Hq, Hkv, ps, max_pages, pools, seed,
                 D=128):
    """A ragged batch of rows (q_start, q_len, kv_len) over pages drawn
    without repeats from 1..P-1; bf16 q, pools bf16 or int8 (with
    scales). Returns q, k, v, the scales dict, the table, the descriptors
    and the owned-token mask."""
    g = torch.Generator(device=device).manual_seed(seed)
    P = 1 + sum(-(-L // ps) for _, _, L in rows)
    q = torch.randn(T, Hq, D, generator=g, device=device).bfloat16()
    kp, vp = (torch.randn(P, Hkv, ps, D, generator=g, device=device)
              for _ in range(2))
    perm = torch.randperm(P - 1, generator=g, device=device) + 1
    pt = torch.zeros(len(rows), max_pages, dtype=torch.int32, device=device)
    used = 0
    for r, (_, _, L) in enumerate(rows):
        npg = -(-L // ps)
        pt[r, :npg] = perm[used:used + npg]
        used += npg
    if pools == I8:
        (k, ksc), (v, vsc) = quantize_kv(kp), quantize_kv(vp)
        sc = dict(k_scale=ksc, v_scale=vsc)
    else:
        k, v, sc = kp.bfloat16(), vp.bfloat16(), {}
    qs, ql, kl = (torch.tensor(x, dtype=torch.int32, device=device)
                  for x in zip(*rows))
    owned = torch.zeros(T, dtype=torch.bool, device=device)
    for s, n, _ in rows:
        owned[s:s + n] = True
    return q, k, v, sc, pt, qs, ql, kl, owned


@pytest.mark.cuda
@pytest.mark.parametrize("pools", [BF16, I8])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 8, 128), (8, 1, 128),
                                      (16, 8, 64)])
def test_ragged_decode_rows_at_split_and_page_edges(cuda, pools, ps, Hq,
                                                     Hkv, D):
    # decode rows whose lengths sit at the page and split edges, one
    # inactive slot; T == R as in the decode loop, and 3 tokens more
    split = tpa.RAGGED_PAGES_PER_SPLIT * ps
    lens = (0, 1, ps, ps + 1, split, split + 1, 2048)
    rows = [(i, 1, n) for i, n in enumerate(lens)] + [(len(lens), 0, 0)]
    for T in (len(rows), len(rows) + 3):
        q, k, v, sc, pt, qs, ql, kl, owned = _ragged_rows(
            cuda, rows, T, Hq, Hkv, ps, 2048 // ps, pools, ps + Hq, D)
        got = tpa.ragged_paged_attention(q, k, v, pt, qs, ql, kl, **sc,
                                         max_q_len=1, decode_rows=len(rows))
        want = tpa.ragged_paged_attention_reference(q, k, v, pt, qs, ql, kl,
                                                    **sc)
        torch.cuda.synchronize()
        assert tolerance_ratio(got, want) <= 1, (T, tolerance_ratio(got,
                                                                    want))
        assert bool((got[~owned] == 0).all()), "padding not 0"
        assert bool((got[0] == 0).all()), "length 0 not 0"


@pytest.mark.cuda
@pytest.mark.parametrize("pools", [BF16, I8])
@pytest.mark.parametrize("Hq,Hkv,ps,D", [
    (32, 8, 16, 128), (8, 4, 16, 128), (8, 1, 8, 128), (8, 8, 16, 128),
    (16, 8, 32, 64), (8, 1, 8, 64), (32, 8, 32, 128)])
def test_ragged_prefill_chunks_across_edges(cuda, pools, Hq, Hkv, ps, D):
    # two decode rows, then chunks that cross page, q-block and key-tile
    # edges: 37 tokens after a 27-token prefix, 9 tokens after 64, and 69
    # tokens that end exactly at the token capacity
    rows = [(0, 1, 40), (1, 1, 3), (2, 37, 64), (39, 9, 73), (48, 69, 69)]
    T = 48 + 69
    q, k, v, sc, pt, qs, ql, kl, owned = _ragged_rows(
        cuda, rows, T, Hq, Hkv, ps, 10, pools, Hq * ps, D)
    want = tpa.ragged_paged_attention_reference(q, k, v, pt, qs, ql, kl,
                                                **sc)
    for hints in (dict(), dict(decode_rows=2, max_q_len=69),
                  dict(decode_rows=2, max_q_len=5)):
        got = tpa.ragged_paged_attention(q, k, v, pt, qs, ql, kl, **sc,
                                         **hints)
        torch.cuda.synchronize()
        assert tolerance_ratio(got, want) <= 1, (hints,
                                                 tolerance_ratio(got, want))
        assert bool((got[~owned] == 0).all()), "padding not 0"


@pytest.mark.cuda
@pytest.mark.parametrize("pools", [BF16, I8])
def test_ragged_hints_change_no_result_and_calls_repeat(cuda, pools):
    # the decode rows through the decode splits (decode_rows = R_decode)
    # and through the prefill tiles (decode_rows = 0): both within the
    # limit of the plain version; two calls give the same bits; padding
    # is 0 even where the output's memory held NaN before
    rows = [(0, 1, 700), (1, 0, 0), (2, 1, 129), (3, 1, 1),
            (4, 100, 300), (104, 20, 20)]
    T = 4 + 2 * 100
    q, k, v, sc, pt, qs, ql, kl, owned = _ragged_rows(
        cuda, rows, T, 32, 8, 16, 48, pools, 11)
    want = tpa.ragged_paged_attention_reference(q, k, v, pt, qs, ql, kl,
                                                **sc)
    outs = {}
    for rd in (0, 4):
        for rep in range(2):
            torch.full((64 << 20,), float("nan"), device=cuda)  # then freed
            outs[rd, rep] = tpa.ragged_paged_attention(
                q, k, v, pt, qs, ql, kl, **sc, decode_rows=rd, max_q_len=100)
    torch.cuda.synchronize()
    for (rd, rep), got in outs.items():
        assert tolerance_ratio(got, want) <= 1, (rd, rep)
        assert bool((got[~owned] == 0).all()), (rd, rep, "padding not 0")
    assert torch.equal(outs[0, 0], outs[0, 1])
    assert torch.equal(outs[4, 0], outs[4, 1])


def _decode_batch(device, Hq, Hkv, D, ps, lens, max_pages, tail=0, seed=0):
    """One decode token per sequence; each sequence's pages drawn without
    repeats from 1..P-1, the table's unused tail filled with ``tail``."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, P = len(lens), len(lens) * max_pages + 1
    q = torch.randn(B, Hq, D, generator=g, device=device)
    kp = torch.randn(P, Hkv, ps, D, generator=g, device=device)
    vp = torch.randn(P, Hkv, ps, D, generator=g, device=device)
    perm = torch.randperm(P - 1, generator=g, device=device) + 1
    pt = torch.full((B, max_pages), tail, dtype=torch.int32, device=device)
    used = 0
    for b, n in enumerate(lens):
        npg = min(-(-n // ps), max_pages)
        pt[b, :npg] = perm[used:used + npg]
        used += npg
    return q, kp, vp, pt, torch.tensor(lens, dtype=torch.int32,
                                       device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("Hq,Hkv", [(8, 4), (8, 2), (32, 8)])
@pytest.mark.parametrize("D", [128, 64])
def test_decode_kernel_matches_plain_version(cuda, dtype, ps, Hq, Hkv, D):
    # lengths: 0, 1, a page, one past, mid-page, the table, past the
    # table; the unused tail holds -1, which the kernel must never read
    max_pages = 6
    lens = [0, 1, ps, ps + 1, 3 * ps + 5, max_pages * ps,
            max_pages * ps + 9]
    q, kp, vp, pt, sl = _decode_batch(cuda, Hq, Hkv, D, ps, lens,
                                      max_pages, tail=-1, seed=Hq + ps)
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    scale = D ** -0.5
    plan = tpa.decode_plan(len(lens), Hq, Hkv, max_pages, ps)
    for pps in (1, 2, 4, plan.pages_per_split):
        before = tpa.launch_counts["paged_attention"]
        got = tpa._paged_attention_cuda(q, kp, vp, pt, sl, scale, pps)
        want = tpa._paged_decode_reference(q, kp, vp, pt, sl, scale, pps)
        torch.cuda.synchronize()
        assert tpa.launch_counts["paged_attention"] == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        assert bool((got[0] == 0).all()), "length 0 not 0"
        ratio = tolerance_ratio(got, want)
        assert ratio <= 1, (pps, ratio)
    # the dispatcher launches the kernel with its own split
    got = tpa.paged_attention(q, kp, vp, pt, sl)
    assert tolerance_ratio(got, tpa.paged_attention_reference(
        q, kp, vp, pt, sl)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (16, 8), (32, 8), (8, 1)])
@pytest.mark.parametrize("D", [128, 64])
def test_decode_ring_walk_at_stage_and_split_edges(cuda, ps, Hq, Hkv, D):
    # the bf16 ring walk (paged_ring.cuh) at every instantiation: 1, 2, 4
    # and 8 query heads per kv head, pages of 8, 16 and 32, head dim 64 and
    # 128; lengths at the page, stage (32 slots) and split edges; the
    # split plain version at the same split and the gather version hold
    # it; the pool's slots past each length hold NaN, which must not reach
    # the output; two calls give the same bits
    max_pages = 4096 // ps
    plan = tpa.decode_plan(9, Hq, Hkv, max_pages, ps)
    split = plan.pages_per_split * ps
    lens = [0, 1, 31, 32, 33, split - 1, split, split + 1, 4096]
    q, kp, vp, pt, sl = _decode_batch(cuda, Hq, Hkv, D, ps, lens, max_pages,
                                      seed=Hq + ps + D)
    q, kp, vp = (t.bfloat16() for t in (q, kp, vp))
    dirty_k, dirty_v = kp.clone(), vp.clone()
    for b, n in enumerate(lens):
        if n % ps:
            last = pt[b, n // ps].long()
            dirty_k[last, :, n % ps:] = float("nan")
            dirty_v[last, :, n % ps:] = float("nan")
    scale = D ** -0.5
    for pps in (1, 3, plan.pages_per_split, max_pages):
        runs = [tpa._paged_attention_cuda(q, dirty_k, dirty_v, pt, sl, scale,
                                          pps) for _ in range(2)]
        want = tpa._paged_decode_reference(q, kp, vp, pt, sl, scale, pps)
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]), pps
        assert torch.isfinite(runs[0]).all(), pps
        assert bool((runs[0][0] == 0).all()), "length 0 not 0"
        assert tolerance_ratio(runs[0], want) <= 1, (
            pps, tolerance_ratio(runs[0], want))
    got = tpa.paged_attention(q, dirty_k, dirty_v, pt, sl)
    assert tolerance_ratio(got, tpa.paged_attention_reference(
        q, kp, vp, pt, sl)) <= 1


@pytest.mark.cuda
def test_decode_plan_stage_is_the_kernels(cuda):
    # decode_plan builds its split sizes from the ring's stage; the kernel
    # library reports the stage it was built with
    from ray_tpu_torch.ops import _kernels
    lib = _kernels.load("paged_attention")
    assert lib.paged_decode_stage_slots() == tpa.DECODE_STAGE_SLOTS


@pytest.mark.cuda
def test_decode_kernel_rejects_what_it_does_not_take(cuda):
    q, kp, vp, pt, sl = _decode_batch(cuda, 8, 2, 128, 16, [5, 20], 2)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_attention(q, kp, vp, pt.long(), sl)
    with pytest.raises(TypeError):
        tpa.paged_attention(q.half(), kp.half(), vp.half(), pt, sl)
    k8, _ = quantize_kv(kp)
    v8, _ = quantize_kv(vp)
    with pytest.raises(TypeError, match="pool dtypes"):
        tpa.paged_attention(q, k8, v8, pt, sl)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                            kp, vp, pt, sl)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, kp.cpu(), vp.cpu(), pt, sl)
    q96, kp96, vp96, *_ = _decode_batch(cuda, 8, 2, 96, 16, [5, 20], 2)
    with pytest.raises(ValueError, match="head dim"):
        tpa.paged_attention(q96, kp96, vp96, pt, sl)
    q24, kp24, vp24, *_ = _decode_batch(cuda, 8, 2, 128, 24, [5, 20], 2)
    with pytest.raises(ValueError, match="page size"):
        tpa.paged_attention(q24, kp24, vp24, pt, sl)
    with pytest.raises(ValueError, match="reference"):
        tpa.paged_attention(q, kp, vp, pt, sl, impl="reference")


def _flash_inputs(device, dtype, BH, Lq, Lk, seed, D=128):
    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn(BH, Lq, D, generator=g, device=device).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(BH, Lk, D, generator=g, device=device).to(dtype)
            for _ in range(2))
    dlse = torch.randn(BH, Lq, generator=g, device=device)
    return q, k, v, do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,Lq,Lk", [(2, 128, 128), (8, 256, 256),
                                      (4, 512, 512), (4, 128, 256),
                                      (3, 256, 128),
                                      # multiples of 64, not of 128: the
                                      # bf16 kernels' 128-row tiles run
                                      # half past the end of a sequence
                                      (3, 192, 192), (5, 320, 192),
                                      (2, 192, 320), (2, 64, 64),
                                      # 9 bh: the block order's last group
                                      # of 8 bh holds one
                                      (9, 256, 128)])
@pytest.mark.parametrize("D", [128, 64])
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, BH, Lq,
                                            Lk, D):
    # bf16 at D 128: the Hopper designs (dq among them, with the lse
    # cotangent folded into delta); D 64 and fp32: the first designs
    q, k, v, do, dlse = _flash_inputs(cuda, dtype, BH, Lq, Lk,
                                      BH * Lq + Lk, D)
    scale = D ** -0.5
    # the plain versions' blocks must divide L (64 for 192 and 320)
    blocks = (tfa.pick_block(Lq), tfa.pick_block(Lk))
    before = dict(tfa.launch_counts)
    o, lse = tfa._fwd_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = tfa._fwd_reference(q, k, v, causal, scale, *blocks)
    delta = (do.float() * o_ref.float()).sum(-1) - dlse
    grads = tfa._bwd_cuda(q, k, v, lse_ref, do, delta, causal, scale)
    grads_ref = tfa._bwd_reference(q, k, v, lse_ref, do, delta, causal,
                                   scale, *blocks)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert tfa.launch_counts[name] == before[name] + 1, name
    assert o.dtype == dtype and lse.dtype == F32
    assert tolerance_ratio(o, o_ref, FLASH_TOL) <= 1
    # fp32 sums of up to L terms in another order
    assert (lse - lse_ref).abs().max().item() <= 2.0 ** -12
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        assert tolerance_ratio(got, want, FLASH_TOL) <= 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_are_repeatable(cuda, causal):
    # no atomics and a fixed order of sums: two calls on the same inputs
    # give the same bits (the bf16 path's Hopper forward, dq and dk/dv)
    q, k, v, do, dlse = _flash_inputs(cuda, BF16, 3, 320, 192, 7)
    scale = 128 ** -0.5
    runs = []
    for _ in range(2):
        o, lse = tfa._fwd_cuda(q, k, v, causal, scale)
        delta = (do.float() * o.float()).sum(-1) - dlse
        runs.append((o, lse, *tfa._bwd_cuda(q, k, v, lse, do, delta, causal,
                                             scale)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(72, 72), (200, 200), (1000, 1000),
                                   (72, 200), (200, 72), (1, 1), (65, 130)])
@pytest.mark.parametrize("D", [128, 64])
def test_flash_kernels_at_lengths_no_tile_divides(cuda, dtype, causal, Lq,
                                                  Lk, D):
    # lengths the Pallas kernels take (L <= 256 at their default blocks, L
    # 1000 at blocks of 8) that no kernel tile divides: the last q tile
    # and key tile run past the end of each sequence and are masked. The
    # plain versions at their default 256-row blocks (a shorter last
    # block) hold the kernels; the lse and delta padding never shows, and
    # two calls repeat bit for bit. dk/dv masks no query row past Lq: the
    # boxes fill q and do with zeros there and lse and delta are padded
    # with zeros, so those rows add exactly 0 (the CPU test
    # test_query_rows_past_lq_add_nothing_to_dk_dv checks the arithmetic)
    q, k, v, do, dlse = _flash_inputs(cuda, dtype, 3, Lq, Lk, Lq + 7 * Lk,
                                      D)
    scale = D ** -0.5
    runs = []
    for _ in range(2):
        o, lse = tfa._fwd_cuda(q, k, v, causal, scale)
        delta = (do.float() * o.float()).sum(-1) - dlse
        runs.append((o, lse, *tfa._bwd_cuda(q, k, v, lse, do, delta, causal,
                                             scale)))
    o_ref, lse_ref = tfa._fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o_ref.float()).sum(-1) - dlse
    grads = tfa._bwd_cuda(q, k, v, lse_ref, do, delta, causal, scale)
    grads_ref = tfa._bwd_reference(q, k, v, lse_ref, do, delta, causal,
                                   scale)
    torch.cuda.synchronize()
    assert tolerance_ratio(runs[0][0], o_ref, FLASH_TOL) <= 1
    assert (runs[0][1] - lse_ref).abs().max().item() <= 2.0 ** -12
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        assert tolerance_ratio(got, want, FLASH_TOL) <= 1, name
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_attention_autograd_runs_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, go = (torch.randn(2, 128, 4, 128, generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    before = dict(tfa.launch_counts)
    out = tfa.flash_attention(q, k, v)
    (out.float() * go.float()).sum().backward()
    torch.cuda.synchronize()
    after = tfa.launch_counts
    assert [after[n] - before[n] for n in after] == [1, 1, 1, 0, 0]
    # against the plain versions on the CPU through the same autograd
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    ref = tfa.flash_attention(qc, kc, vc)
    (ref.float() * go.float().cpu()).sum().backward()
    assert tolerance_ratio(out.cpu(), ref, FLASH_TOL) <= 1
    for got, want in ((q.grad, qc.grad), (k.grad, kc.grad),
                      (v.grad, vc.grad)):
        assert tolerance_ratio(got.cpu(), want, FLASH_TOL) <= 1


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q = torch.randn(2, 128, 128, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        tfa._fwd_cuda(q.transpose(0, 1).contiguous().transpose(0, 1), q, q,
                      True, 0.1)
    with pytest.raises(TypeError):
        tfa._fwd_cuda(q.half(), q.half(), q.half(), True, 0.1)
    with pytest.raises(TypeError, match="one dtype"):
        tfa._fwd_cuda(q, q.float(), q, True, 0.1)
    q32 = torch.randn(2, 128, 32, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        tfa._fwd_cuda(q32, q32, q32, True, 0.1)
    # a length no kernel tile divides is taken (the last tiles are masked)
    q96 = torch.randn(2, 96, 128, device=cuda).bfloat16()
    o96, _ = tfa._fwd_cuda(q96, q96, q96, True, 0.1)
    torch.cuda.synchronize()
    assert tolerance_ratio(o96, tfa._fwd_reference(q96, q96, q96, True,
                                                   0.1)[0], FLASH_TOL) <= 1
    q0 = torch.randn(2, 0, 128, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="at least 1"):
        tfa._fwd_cuda(q0, q96, q96, True, 0.1)
    with pytest.raises(ValueError):
        tfa._fwd_cuda(q, q.cpu(), q, True, 0.1)
    lse = torch.zeros(2, 128, device=cuda)
    with pytest.raises(ValueError, match="lse"):
        tfa._bwd_cuda(q, q, q, lse.bfloat16(), q, lse, True, 0.1)


@pytest.mark.cuda
def test_tied_head_gradient_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, 64, 256, generator=g, device=cuda).bfloat16()
    w = torch.randn(1000, 256, generator=g, device=cuda).bfloat16() * 0.1
    go = torch.randn(3, 64, 1000, generator=g, device=cuda)
    x.requires_grad_(), w.requires_grad_()
    logits = head_logits(x, w)
    assert logits.dtype == F32
    (logits * go).sum().backward()
    xf, wf = (t.detach().float().requires_grad_() for t in (x, w))
    (head_logits(xf, wf) * go.bfloat16().float()).sum().backward()
    assert tolerance_ratio(logits, head_logits(xf, wf).detach(),
                           FLASH_TOL) <= 1
    # the same operands (the logits' gradient rounded to bf16 on both
    # sides), fp32 sums in another order, each rounded to bf16
    assert tolerance_ratio(x.grad, xf.grad.to(BF16), FLASH_TOL) <= 1
    assert tolerance_ratio(w.grad, wf.grad.to(BF16), FLASH_TOL) <= 1


@pytest.mark.cuda
def test_int8_matmul_on_card_matches_cpu(cuda):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(64, 128, generator=g)
    w = torch.randn(128, 96, generator=g)
    gout = torch.randn(64, 96, generator=g)
    outs = []
    for dev in ("cpu", cuda):
        xd, wd = (t.detach().to(dev).requires_grad_() for t in (x, w))
        out = int8_matmul(xd, wd)
        (out * gout.to(dev)).sum().backward()
        outs.append((out.detach().cpu(), xd.grad.cpu(), wd.grad.cpu()))
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_dq_at_a_training_shape(cuda, causal, D):
    # dq alone at a cut of the training path's shape (L 1024, BH 9: the
    # block order's last group of 8 bh holds one), with an lse cotangent;
    # one launch per call, and the result repeats bit for bit
    q, k, v, do, dlse = _flash_inputs(cuda, BF16, 9, 1024, 1024, 5 + D, D)
    scale = D ** -0.5
    o, lse = tfa._fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1) - dlse
    before = tfa.launch_counts["flash_attention_dq"]
    runs = []
    for _ in range(2):
        dq = torch.empty_like(q)
        tfa._launch("flash_attention_bwd", "flash_attention_dq", cuda, 1, q,
                    k, v, do, lse, delta, dq, 9, 1024, 1024, D, int(causal),
                    scale)
        runs.append(dq)
    want = tfa._bwd_reference(q, k, v, lse, do, delta, causal, scale)[0]
    torch.cuda.synchronize()
    assert tfa.launch_counts["flash_attention_dq"] == before + 2
    assert torch.equal(runs[0], runs[1])
    assert tolerance_ratio(runs[0], want, FLASH_TOL) <= 1


@pytest.mark.cuda
def test_server_on_a_geometry_the_kernels_refuse_raises_at_construction(
        cuda):
    # the default server (preset "tiny": head dim 8) on the card: the
    # constructor names the geometry within seconds, instead of the
    # engine thread dying in its first step and callers waiting 300 s
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="head dim 8"):
        LLMServer()
    with pytest.raises(ValueError, match="head dim 8"):
        InferenceEngine(LlamaConfig.tiny(), device=cuda)
    with pytest.raises(ValueError, match="page size 24"):
        InferenceEngine(LlamaConfig.tiny(dim=1024, n_heads=16,
                                         n_kv_heads=8, n_layers=1),
                        page_size=24, device=cuda)
    assert time.monotonic() - t0 < 30


@pytest.mark.cuda
def test_batch_predictor_default_raises_at_construction(cuda):
    # LLMBatchPredictor's default (preset "tiny": head dim 8) on the card
    # raises in its constructor, as the server's does
    from ray_tpu_torch.llm.batch import LLMBatchPredictor
    with pytest.raises(ValueError, match="head dim 8"):
        LLMBatchPredictor()


@pytest.mark.cuda
def test_adafactor_on_the_card_matches_the_cpu(cuda):
    # three Adafactor steps on a factored and a full second moment, fp32
    # on both devices: summation order only (tests/test_torch_adafactor.py
    # holds the CPU against optax to the same limits)
    from ray_tpu_torch.train import Adafactor
    g = torch.Generator().manual_seed(0)
    shapes = [(3, 128, 256), (300, 128), (127, 64), (64,)]
    init = [0.05 * torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) for s in shapes]
             for _ in range(3)]
    runs = []
    for dev in ("cpu", cuda):
        ps = [p.to(dev, copy=True) for p in init]
        opt = Adafactor(ps, lr=1e-3)
        for step in grads:
            for p, gr in zip(ps, step):
                p.grad = gr.to(dev)
            opt.step()
        runs.append((ps, opt))
    (cpu_ps, cpu_opt), (dev_ps, dev_opt) = runs
    for a, b in zip(dev_ps, cpu_ps):
        assert (a.cpu() - b).abs().max() <= 1e-6 * b.abs().max()
        for key, sb in cpu_opt.state[b].items():
            sa = dev_opt.state[a][key].cpu()
            assert (sa - sb).abs().max() <= 1e-5 * sb.abs().max(), key
    assert set(dev_opt.state[dev_ps[0]]) == {"step", "v_row", "v_col"}
    assert set(dev_opt.state[dev_ps[2]]) == {"step", "v"}


@pytest.mark.cuda
def test_moe_ffn_on_card_matches_cpu_and_repeats(cuda):
    # the routed MoE FFN (no kernel of its own: cuBLAS products, sort,
    # gathers and scatter-adds): fp32 on the card against the CPU, the
    # same routing, and in bf16 two calls equal bit for bit, backward
    # included (each index_add_ writes distinct rows)
    from ray_tpu_torch.parallel import moe
    g = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(256, 512, 8, seed=0, device="cpu")
    params["w_gate"] = 256 ** -0.5 * torch.randn(8, 256, 512, generator=g)
    x = torch.randn(1024, 256, generator=g)
    want = moe.moe_ffn(params, x)
    dev = {k: v.to(cuda) for k, v in params.items()}
    got = moe.moe_ffn(dev, x.to(cuda))
    assert torch.equal(moe._routing(dev, x.to(cuda), 2)[0].cpu(),
                       moe._routing(params, x, 2)[0])
    assert tolerance_ratio(got.cpu(), want) <= 1
    half = {k: v.to(BF16).requires_grad_() for k, v in dev.items()}
    runs = []
    for _ in range(2):
        xb = x.to(cuda, BF16).requires_grad_()
        out = moe.moe_ffn(half, xb)
        out.float().square().sum().backward()
        runs.append([out.detach(), xb.grad] + [half[k].grad for k in half])
        for v in half.values():
            v.grad = None
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ppo_update_on_card_matches_cpu(cuda):
    # one PPOLearner update (no kernel of its own: GAE, 16 minibatch
    # steps of the MLP's forward and backward, optax's clipped Adam) from
    # the same parameters, batch and permutations, fp32 with TF32 off
    import numpy as np

    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.learner import PPOLearner
    from ray_tpu_torch.rllib.module import init_module
    from ray_tpu_torch.train import param_leaves
    params = init_module(torch.Generator().manual_seed(0), 4, 2)
    runner = EnvRunner("CartPole-v1", 16, 64, seed=0, device="cpu")
    runner.set_weights(params)
    batch = runner.sample()
    g = torch.Generator().manual_seed(1)
    perms = torch.stack([torch.randperm(1024, generator=g)
                         for _ in range(4)]).numpy()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, mw = PPOLearner(lr=1e-3).update(params, batch, perms=perms)
        got, mg = PPOLearner(lr=1e-3).update(
            {k: v.to(cuda) for k, v in params.items()}, batch, perms=perms)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(param_leaves(got), param_leaves(want)):
        assert a.device.type == "cuda"
        assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()
    assert abs(mg["loss"] - mw["loss"]) <= 1e-5 * abs(mw["loss"])
    assert np.isfinite(mg["loss"])


@pytest.mark.cuda
def test_iter_torch_batches_puts_numeric_columns_on_the_card(cuda):
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        ds = rd.from_numpy({"x": np.arange(10, dtype=np.float32),
                            "i": np.arange(10)}, num_blocks=3)
        batches = list(ds.iterator().iter_torch_batches(batch_size=4))
    finally:
        ray_tpu_torch.shutdown()
    assert [len(b["x"]) for b in batches] == [4, 4, 2]
    for b in batches:
        assert b["x"].device.type == "cuda" and b["x"].dtype == F32
        assert b["i"].device.type == "cuda" and b["i"].dtype == torch.int64
    assert torch.cat([b["x"] for b in batches]).sum().item() == 45.0


@pytest.mark.cuda
def test_batch_inference_launches_the_ragged_kernel(cuda):
    # a dataset through a pool of two predictor actors, at a head dim the
    # kernels take (64, pages of 32): the kernel runs, its plain version
    # never does, and rows come back whole and in order
    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.llm.batch import batch_inference
    rows = [{"prompt": list(range(1, 5 + 7 * j)), "id": j} for j in range(6)]
    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        out = batch_inference(
            rd.from_items(rows, num_blocks=3),
            model_config={"n_layers": 2, "dim": 256, "n_heads": 4,
                          "n_kv_heads": 2, "dtype": "bfloat16"},
            engine_config={"page_size": 32, "total_pages": 64,
                           "max_seq_len": 256}, max_new_tokens=6,
            concurrency=2).take_all()
    finally:
        ray_tpu_torch.shutdown()
    assert [r["id"] for r in out] == list(range(6))
    assert all(len(r["generated"]) == 6 for r in out)
    assert tpa.launch_counts["ragged_paged_attention"] > 0
    assert tpa.launch_counts["ragged_paged_attention_reference_cuda"] == 0
