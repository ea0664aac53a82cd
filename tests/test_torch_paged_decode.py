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
