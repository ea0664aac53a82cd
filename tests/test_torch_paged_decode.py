"""The port's decode paged attention against the JAX package's, on the CPU.

Inputs come from a numpy seed and go to both packages as numpy arrays. The
JAX side runs as its own tests run it on the CPU: the gather reference,
and the Pallas ``_decode_kernel`` in interpret mode. The port's side is its
two plain versions: ``paged_attention_reference`` (the gather) and
``_paged_decode_reference`` (the TPU kernel's page walk, split into
``pages_per_split`` pieces as the CUDA kernel splits it); the CUDA kernel
itself is held against the second on the card.

Tolerances, per row (the head dim) against the row's own scale. fp32: the
two sides differ in the order of fp32 sums only, 1e-5 of the row's largest
value. bf16 (q and pools): both sides round fp32 values that differ by
summation order, one bf16 step of the row's largest value (2^-7 of it);
a split rounds p to bf16 against its own running maximum, not the single
walk's, which moves terms by far less than that step.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.ops import paged_attention as tpa

# tiny shapes: one intra-op thread, leaving the cores to the tests
# that run beside these ones
torch.set_num_threads(1)

# fp32 gathers on both sides: only summation order differs
REF_ATOL = 1e-5
ROW_TOL = {"float32": (1e-5, 1e-7), "bfloat16": (2.0 ** -7, 1e-5)}
LAYOUTS = [(8, 4, 64, 8), (8, 2, 128, 16), (32, 8, 128, 16),
           # bench_llm.py's serving widths: head dim 64, pages of 32
           (16, 8, 64, 32)]


def _batch(seed, Hq, Hkv, D, ps, lens, max_pages, tail=0):
    """q, pools and a page table for sequences of ``lens`` slots: each
    sequence's pages drawn without repeats from 1..P-1 (page 0 is the
    scratch page), the table's unused tail filled with ``tail``."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    P = B * max_pages + 1
    q = rng.standard_normal((B, Hq, D), np.float32)
    kp = rng.standard_normal((P, Hkv, ps, D), np.float32)
    vp = rng.standard_normal((P, Hkv, ps, D), np.float32)
    pt = np.full((B, max_pages), tail, np.int32)
    perm = rng.permutation(np.arange(1, P, dtype=np.int32))
    used = 0
    for b, n in enumerate(lens):
        npg = min(-(-n // ps), max_pages)
        pt[b, :npg] = perm[used:used + npg]
        used += npg
    return q, kp, vp, pt, np.asarray(lens, np.int32)


def _t(args, dtype="float32"):
    """numpy -> torch; the float arrays in ``dtype``."""
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return [t.to(getattr(torch, dtype)) if t.is_floating_point() else t
            for t in out]


def _j(args, dtype="float32"):
    return [jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)
            if a.dtype == np.float32 else jnp.asarray(a) for a in args]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_rows_close(got, want, dtype):
    """|got - want| <= rtol * max|want| + floor on every row."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    rtol, floor = ROW_TOL[dtype]
    err = np.abs(got - want).max(-1)
    limit = rtol * np.abs(want).max(-1) + floor
    assert (err <= limit).all(), float((err / limit).max())


@pytest.mark.parametrize("Hq,Hkv,D,ps", LAYOUTS)
def test_reference_matches_jax_reference(Hq, Hkv, D, ps):
    # lengths: 1, a page multiple, one past a multiple, the whole table
    max_pages = 4
    args = _batch(Hq + Hkv + D, Hq, Hkv, D, ps,
                  [1, 2 * ps, 2 * ps + 1, max_pages * ps], max_pages)
    want = np.asarray(jpa.paged_attention_reference(*_j(args)))
    got = tpa.paged_attention_reference(*_t(args)).numpy()
    np.testing.assert_allclose(got, want, atol=REF_ATOL)
    # the dispatcher runs the same plain version on CPU tensors
    np.testing.assert_array_equal(tpa.paged_attention(*_t(args)).numpy(),
                                  got)


# the interpret-mode kernel's batch: Hq 8, Hkv 2, D 128, page 16, 4 pages
# a row; lengths 1, a page multiple, one past a multiple, the whole table
INTERPRET_ARGS = (5, 8, 2, 128, 16, [1, 32, 17, 64], 4)


@functools.lru_cache(maxsize=None)
def _interpret(dtype):
    args = _batch(*INTERPRET_ARGS)
    D = args[0].shape[-1]
    return np.asarray(jnp.asarray(jpa._paged_attention_pallas(
        *_j(args, dtype), D ** -0.5, interpret=True), jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages_per_split", [1, 2, None])
def test_decode_reference_matches_interpret_kernel(dtype, pages_per_split):
    args = _batch(*INTERPRET_ARGS)
    D = args[0].shape[-1]
    got = tpa._paged_decode_reference(*_t(args, dtype), D ** -0.5,
                                      pages_per_split)
    assert got.dtype == getattr(torch, dtype)
    assert_rows_close(got, _interpret(dtype), dtype)


# bench_llm.py's attention widths: Hq 16, Hkv 8, head dim 64, pages of
# 32, 4 pages a row; lengths 1, a page multiple, one past a multiple, the
# whole table
SERVING_ARGS = (6, 16, 8, 64, 32, [1, 64, 33, 128], 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages_per_split", [1, 3, None])
def test_serving_geometry_matches_interpret_kernel(dtype, pages_per_split):
    args = _batch(*SERVING_ARGS)
    D = args[0].shape[-1]
    want = np.asarray(jnp.asarray(jpa._paged_attention_pallas(
        *_j(args, dtype), D ** -0.5, interpret=True), jnp.float32))
    got = tpa._paged_decode_reference(*_t(args, dtype), D ** -0.5,
                                      pages_per_split)
    assert_rows_close(got, want, dtype)
    assert_rows_close(tpa.paged_attention(*_t(args, dtype)), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_length_zero_row_is_zero_as_in_the_kernel(dtype):
    args = _batch(3, 8, 2, 128, 16, [0, 16, 47], 3)
    D = args[0].shape[-1]
    kern = _np(jpa._paged_attention_pallas(*_j(args, dtype), D ** -0.5,
                                           interpret=True))
    assert np.all(kern[0] == 0.0)
    # the JAX reference takes a softmax over no slot there: NaN
    ref = _np(jpa.paged_attention_reference(*_j(args)))
    assert np.isnan(ref[0]).all()
    outs = [tpa.paged_attention_reference(*_t(args, dtype)),
            tpa.paged_attention(*_t(args, dtype))] + [
        tpa._paged_decode_reference(*_t(args, dtype), D ** -0.5, pps)
        for pps in (1, 2, None)]
    for got in outs:
        assert np.all(_np(got)[0] == 0.0)
        assert_rows_close(_np(got)[1:], kern[1:], dtype)
        if dtype == "float32":
            np.testing.assert_allclose(_np(got)[1:], ref[1:], atol=REF_ATOL)


@pytest.mark.parametrize("garbage", ["minus_one", "past_the_pool"])
def test_unused_table_tail_is_never_read(garbage):
    Hq, Hkv, D, ps, max_pages = 8, 2, 128, 16, 6
    lens = [1, 17, 40, 96]
    clean = _t(_batch(7, Hq, Hkv, D, ps, lens, max_pages))
    P = clean[1].shape[0]
    tail = -1 if garbage == "minus_one" else P + 7
    dirty = _t(_batch(7, Hq, Hkv, D, ps, lens, max_pages, tail=tail))
    assert (dirty[3] == tail).any()
    scale = D ** -0.5
    for fn in [tpa.paged_attention_reference, tpa.paged_attention] + [
            functools.partial(tpa._paged_decode_reference, sm_scale=scale,
                              pages_per_split=pps) for pps in (1, 2, None)]:
        assert torch.equal(fn(*dirty), fn(*clean))


def test_lengths_past_the_table_count_only_its_slots():
    Hq, Hkv, D, ps, max_pages = 8, 4, 64, 8, 3
    args = _batch(9, Hq, Hkv, D, ps, [max_pages * ps, 2 * ps, 5],
                  max_pages)
    want = np.asarray(jpa.paged_attention_reference(*_j(args)))
    over = list(args)
    over[4] = args[4] + np.array([7, 0, 0], np.int32)   # 31 > 24 slots
    assert np.array_equal(
        np.asarray(jpa.paged_attention_reference(*_j(over))), want)
    for got in [tpa.paged_attention_reference(*_t(over))] + [
            tpa._paged_decode_reference(*_t(over), D ** -0.5, pps)
            for pps in (1, 2, None)]:
        np.testing.assert_allclose(got.numpy(), want, atol=REF_ATOL)


@pytest.mark.parametrize("Hq,Hkv,D,ps", LAYOUTS)
def test_decode_equals_ragged_reference_with_one_query_per_row(Hq, Hkv, D,
                                                               ps):
    """tests/test_ragged.py's all-decode case: a ragged batch of one token
    per row is the decode op."""
    B = 4
    args = _batch(B + Hq + D, Hq, Hkv, D, ps, [11, 3 * ps, 5, 17], 3)
    q, kp, vp, pt, sl = _t(args)
    dec = tpa.paged_attention(q, kp, vp, pt, sl).numpy()
    rag = tpa.ragged_paged_attention_reference(
        q, kp, vp, pt, torch.arange(B, dtype=torch.int32),
        torch.ones(B, dtype=torch.int32), sl, decode_rows=B,
        max_q_len=1).numpy()
    np.testing.assert_allclose(dec, rag, atol=REF_ATOL)
    want = np.asarray(jpa.paged_attention_reference(*_j(args)))
    np.testing.assert_allclose(dec, want, atol=REF_ATOL)


@pytest.mark.parametrize("bad", ["kernel_on_cpu", "unknown_impl",
                                 "heads_not_grouped"])
def test_dispatcher_rejects(bad):
    q, kp, vp, pt, sl = _t(_batch(2, 8, 4, 64, 8, [3, 9], 2))
    if bad == "kernel_on_cpu":
        with pytest.raises(ValueError, match="CUDA"):
            tpa.paged_attention(q, kp, vp, pt, sl, impl="kernel")
    elif bad == "unknown_impl":
        with pytest.raises(ValueError, match="impl"):
            tpa.paged_attention(q, kp, vp, pt, sl, impl="pallas")
    else:
        with pytest.raises(ValueError, match="multiple"):
            tpa.paged_attention(q[:, :6], kp[:, :4], vp[:, :4], pt, sl)


def test_dispatcher_on_cpu_runs_the_plain_version_and_launches_nothing():
    args = _t(_batch(4, 8, 4, 64, 8, [3, 9], 2))
    before = dict(tpa.launch_counts)
    got = tpa.paged_attention(*args, impl="reference")
    assert torch.equal(got, tpa.paged_attention_reference(*args))
    # sm_scale defaults to D ** -0.5 in both
    assert torch.equal(tpa.paged_attention(*args, sm_scale=64 ** -0.5), got)
    assert tpa.launch_counts == before


# ----------------------------------------- the decode plan and the ring walk

# the chip's decode batches (chip_smoke.py phase 3b): (B, Hq, Hkv,
# max_pages, page size) -> the plan's pages per split
PLAN_CASES = [((8, 32, 8, 128, 16), 8), ((8, 32, 8, 512, 16), 32),
              ((8, 16, 8, 16, 32), 2)]


@pytest.mark.parametrize("shape,pps", PLAN_CASES)
def test_decode_plan_at_the_chip_batches(shape, pps):
    plan = tpa.decode_plan(*shape)
    B, _, Hkv, max_pages, _ = shape
    assert plan.pages_per_split == pps
    assert plan.splits == -(-max_pages // pps)
    assert plan.blocks == B * Hkv * plan.splits <= tpa.DECODE_TARGET_BLOCKS


@pytest.mark.parametrize("B,Hkv,max_pages,ps", [
    (1, 1, 1, 16), (8, 8, 128, 16), (8, 8, 512, 16), (8, 8, 16, 32),
    (3, 2, 37, 8), (64, 8, 2048, 8), (2, 4, 5, 32), (0, 8, 128, 16)])
def test_decode_plan_covers_every_page_once_from_shapes_alone(B, Hkv,
                                                              max_pages, ps):
    """Every page of every sequence falls in exactly one split, splits
    past a sequence's end are empty, and the plan takes no lengths: the
    same plan serves every length up to the table."""
    plan = tpa.decode_plan(B, 4 * Hkv, Hkv, max_pages, ps)
    pps, S = plan.pages_per_split, plan.splits
    assert 1 <= pps <= max(max_pages, 1) and S == tpa._n_splits(max_pages,
                                                                pps)
    floor = tpa.DECODE_MIN_SPLIT_SLOTS // ps
    # at the floor, or doubled only while the grid overflows the target
    assert pps >= min(floor, max_pages)
    if pps > floor and pps < max_pages:
        assert B * Hkv * tpa._n_splits(max_pages, pps // 2) > \
            tpa.DECODE_TARGET_BLOCKS
    for n in {0, 1, ps - 1, ps, ps + 1, pps * ps, pps * ps + 1,
              max_pages * ps}:
        n_pages = -(-min(n, max_pages * ps) // ps)
        seen = []
        for s in range(S):   # as the kernel's split_walk cuts them
            p_begin, p_end = s * pps, min(s * pps + pps, n_pages)
            if p_begin >= p_end:
                assert p_begin >= n_pages    # empty only past the end
                continue
            seen += range(p_begin, p_end)
        assert seen == list(range(n_pages)), (n, seen)
    assert tpa.decode_plan(B, 4 * Hkv, Hkv, max_pages, ps) == plan
    with pytest.raises(ValueError):
        tpa.decode_plan(B, 4 * Hkv, 0, max_pages, ps)
    with pytest.raises(ValueError):
        tpa.decode_plan(B, 4 * Hkv, Hkv, max_pages, 0)


def _ring_emulation(q, kp, vp, pt, lens, sm_scale, pages_per_split):
    """The bf16 ring walk's order of arithmetic (paged_ring.cuh), on the
    CPU: per split, stages of DECODE_STAGE_SLOTS slots (whole pages), taken
    in turn by two consumers with a state each; per stage s = (q . k: bf16
    products, fp32 sums) * sm_scale, slots past the split's last visible
    one -inf, one online-softmax update, p rounded to bf16 before an fp32
    p . v; the two states combined in order; then the parallel merge: the
    splits in four slices, each merged against its own maximum, the slices
    combined in order."""
    B, Hq, D = q.shape
    _, Hkv, ps, _ = kp.shape
    max_pages = pt.shape[1]
    qpk = Hq // Hkv
    spp = max(1, tpa.DECODE_STAGE_SLOTS // ps)     # pages per stage
    S = tpa._n_splits(max_pages, pages_per_split)
    lens = lens.long().clamp(0, max_pages * ps)
    n_pages = (lens + ps - 1) // ps
    qg = q.float().reshape(B, Hkv, qpk, D)
    m = torch.full((S, 2, B, Hkv, qpk), float("-inf"))   # two consumers
    l = torch.zeros_like(m)
    acc = torch.zeros(*m.shape, D)
    for s in range(S):
        p_begin = s * pages_per_split
        p_end = (n_pages.clamp(max=p_begin + pages_per_split))   # [B]
        end = torch.minimum(lens, p_end * ps)
        for st, p0 in enumerate(range(p_begin, p_begin + pages_per_split,
                                      spp)):
            c = (s, st % 2)
            pages = torch.arange(p0, p0 + spp)
            loaded = pages[None, :] < p_end[:, None]               # [B, spp]
            ids = torch.where(loaded, pt.long()[:, pages.clamp(
                max=max_pages - 1)], 0)
            k = kp[ids].float().permute(0, 2, 1, 3, 4).reshape(
                B, Hkv, spp * ps, D)
            v = vp[ids].float().permute(0, 2, 1, 3, 4).reshape(
                B, Hkv, spp * ps, D)
            slot = p0 * ps + torch.arange(spp * ps)
            valid = slot[None, :] < end[:, None]                   # [B, n]
            live = valid.any(-1)[:, None, None]                    # [B,1,1]
            sc = torch.einsum("bgqd,bgtd->bgqt", qg, k) * sm_scale
            sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
            m_new = torch.maximum(m[c], sc.amax(-1))
            p = torch.where(torch.isneginf(sc), 0.0,
                            torch.exp(sc - m_new[..., None]))
            corr = torch.where(torch.isneginf(m[c]), 0.0,
                               torch.exp(m[c] - m_new))
            v = torch.where(valid[:, None, :, None], v, 0.0)
            pv = torch.einsum("bgqt,bgtd->bgqd",
                              p.to(torch.bfloat16).float(), v)
            l[c] = torch.where(live, l[c] * corr + p.sum(-1), l[c])
            acc[c] = torch.where(live[..., None],
                                 acc[c] * corr[..., None] + pv, acc[c])
            m[c] = torch.where(live, m_new, m[c])
    # consumer 1's state into consumer 0's, per split
    M2 = m.amax(1)
    w2 = torch.where(torch.isneginf(m), 0.0, torch.exp(
        m - torch.where(torch.isneginf(M2), 0.0, M2)[:, None]))
    m, l = M2, (w2 * l).sum(1)
    acc = (w2[..., None] * acc).sum(1)
    chunk = -(-S // 4)
    parts = []
    for w in range(4):
        sl = slice(min(w * chunk, S), min(w * chunk + chunk, S))
        mw, lw, aw = m[sl], l[sl], acc[sl]
        Mw = mw.amax(0) if mw.shape[0] else torch.full(m.shape[1:],
                                                       float("-inf"))
        wt = torch.where(torch.isneginf(mw), 0.0, torch.exp(
            mw - torch.where(torch.isneginf(Mw), 0.0, Mw)))
        parts.append((Mw, (wt * lw).sum(0), (wt[..., None] * aw).sum(0)))
    M = torch.stack([p[0] for p in parts]).amax(0)
    num = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for Mw, dw, nw in parts:
        x = torch.where(torch.isneginf(Mw), 0.0, torch.exp(
            Mw - torch.where(torch.isneginf(M), 0.0, M)))
        num = num + x[..., None] * nw
        den = den + x * dw
    o = num / den.clamp_min(1e-30)[..., None]
    return o.reshape(B, Hq, D).to(q.dtype)


# geometries like the chip's batches A (Hq 32, Hkv 8, D 128, pages of 16)
# and C (bench_llm.py's widths: Hq 16, Hkv 8, D 64, pages of 32), cut to a
# table the interpret-mode kernel walks in seconds; lengths 0, 1 and at
# the page, stage and split edges
PLAN_GEOMETRIES = {
    "A": (11, 32, 8, 128, 16, [1, 15, 16, 17, 127, 128, 129, 300, 512], 32),
    "C": (12, 16, 8, 64, 32, [1, 31, 32, 33, 128, 129, 300, 500, 512], 16),
}


@functools.lru_cache(maxsize=None)
def _plan_interpret(name):
    args = _batch(*PLAN_GEOMETRIES[name])
    D = args[0].shape[-1]
    return np.asarray(jnp.asarray(jpa._paged_attention_pallas(
        *_j(args, "bfloat16"), D ** -0.5, interpret=True), jnp.float32))


@pytest.mark.parametrize("name", sorted(PLAN_GEOMETRIES))
def test_split_reference_at_the_plans_split_matches_interpret_kernel(name):
    args = _batch(*PLAN_GEOMETRIES[name])
    q, kp, vp, pt, sl = _t(args, "bfloat16")
    B, Hq, D = q.shape
    _, Hkv, ps, _ = kp.shape
    plan = tpa.decode_plan(B, Hq, Hkv, pt.shape[1], ps)
    assert plan.splits > 1, plan      # the merge runs
    got = tpa._paged_decode_reference(q, kp, vp, pt, sl, D ** -0.5,
                                      plan.pages_per_split)
    assert_rows_close(got, _plan_interpret(name), "bfloat16")


@pytest.mark.parametrize("name", sorted(PLAN_GEOMETRIES))
@pytest.mark.parametrize("pps", ["plan", 1, 3])
def test_ring_walk_emulation_matches_split_reference_and_interpret(name,
                                                                   pps):
    args = _batch(*PLAN_GEOMETRIES[name])
    q, kp, vp, pt, sl = _t(args, "bfloat16")
    B, Hq, D = q.shape
    _, Hkv, ps, _ = kp.shape
    if pps == "plan":
        pps = tpa.decode_plan(B, Hq, Hkv, pt.shape[1], ps).pages_per_split
    scale = D ** -0.5
    got = _ring_emulation(q, kp, vp, pt, sl, scale, pps)
    assert got.dtype == torch.bfloat16
    assert_rows_close(got, tpa._paged_decode_reference(
        q, kp, vp, pt, sl, scale, pps), "bfloat16")
    assert_rows_close(got, _plan_interpret(name), "bfloat16")
    assert_rows_close(got, tpa.paged_attention_reference(q, kp, vp, pt, sl),
                      "bfloat16")
    # a length-0 row gives exactly 0, the others as before
    sl0 = sl.clone()
    sl0[0] = 0
    got0 = _ring_emulation(q, kp, vp, pt, sl0, scale, pps)
    assert bool((got0[0] == 0).all()) and torch.equal(got0[1:], got[1:])
