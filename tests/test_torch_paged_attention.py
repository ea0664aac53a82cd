"""PyTorch port of the ragged paged attention against the JAX package.

Inputs come from a numpy seed and go to both packages as numpy arrays.
The JAX side runs as its own tests run it on the CPU: the gather
reference, and the Pallas ``_ragged_kernel`` in interpret mode. The port's
side on the CPU is its plain version; the CUDA kernel itself is checked
against that plain version by ``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import int8 as jint8
from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.ops import int8 as tint8
from ray_tpu_torch.ops import paged_attention as tpa

# tiny shapes: one intra-op thread, leaving the cores to the tests
# that run beside these ones
torch.set_num_threads(1)


def _mixed_batch(seed, Hq, Hkv, D, ps=8, pages=12):
    """tests/test_ragged.py's case: 2 decode rows + 1 inactive row + 2
    prefill chunks, one straddling a page boundary; T=16 leaves tokens
    13..15 to no row (padding)."""
    rng = np.random.default_rng(seed)
    T = 16
    q = rng.standard_normal((T, Hq, D), np.float32)
    kp = rng.standard_normal((pages, Hkv, ps, D), np.float32)
    vp = rng.standard_normal((pages, Hkv, ps, D), np.float32)
    pt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0],
                   [9, 10, 11, 1], [2, 3, 4, 5]], np.int32)
    q_start = np.array([0, 1, 0, 3, 9], np.int32)
    q_len = np.array([1, 1, 0, 6, 4], np.int32)
    kv_len = np.array([11, 24, 0, 21, 4], np.int32)
    return q, kp, vp, pt, q_start, q_len, kv_len


def _owned(q_start, q_len, T):
    owned = np.zeros(T, bool)
    for s, n in zip(q_start, q_len):
        owned[int(s):int(s) + int(n)] = True
    return owned


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


# fp32 on both sides, same gather algorithm: only summation order differs
REF_ATOL = 1e-5
# the interpret-mode Pallas kernel emulates the TPU's matmul precision
# (tests/test_ragged.py uses the same bound against the JAX reference)
PALLAS_ATOL = 2e-2


@pytest.mark.parametrize("Hq,Hkv,D,ps", [
    (8, 8, 32, 8), (8, 4, 32, 8), (8, 1, 32, 8),
    (8, 8, 128, 16), (8, 4, 128, 16), (8, 1, 128, 16)])
def test_reference_matches_jax_reference(Hq, Hkv, D, ps):
    args = _mixed_batch(Hq * 10 + Hkv + D, Hq, Hkv, D, ps=ps)
    want = np.asarray(jpa.ragged_paged_attention_reference(*_j(args)))
    got = tpa.ragged_paged_attention_reference(*_t(args)).numpy()
    np.testing.assert_allclose(got, want, atol=REF_ATOL)
    # cost hints stay cost-only, as in JAX
    hinted = tpa.ragged_paged_attention_reference(
        *_t(args), max_q_len=6, decode_rows=2).numpy()
    np.testing.assert_allclose(hinted, want, atol=REF_ATOL)
    # padding tokens and the inactive row's tokens come back exactly 0
    owned = _owned(args[4], args[5], args[0].shape[0])
    assert np.all(got[~owned] == 0.0) and np.all(hinted[~owned] == 0.0)


@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 4), (8, 1)])
def test_reference_matches_interpret_pallas_kernel(Hq, Hkv):
    D = 128
    args = _mixed_batch(Hq + Hkv, Hq, Hkv, D, ps=16)
    want = np.asarray(jpa._ragged_attention_pallas(
        *_j(args), None, None, D ** -0.5, interpret=True))
    got = tpa.ragged_paged_attention(*_t(args)).numpy()
    np.testing.assert_allclose(got, want, atol=PALLAS_ATOL)


def test_int8_pages_match_jax_reference_and_kernel():
    Hq, Hkv, D = 8, 4, 128
    q, kp, vp, pt, qs, ql, kl = _mixed_batch(11, Hq, Hkv, D, ps=16)
    kq, ksc = jint8.quantize_kv(jnp.asarray(kp))
    vq, vsc = jint8.quantize_kv(jnp.asarray(vp))
    jargs = _j((q,)) + [kq, vq] + _j((pt, qs, ql, kl))
    want = np.asarray(jpa.ragged_paged_attention_reference(
        *jargs, k_scale=ksc, v_scale=vsc))
    kern = np.asarray(jpa._ragged_attention_pallas(
        *jargs, ksc, vsc, D ** -0.5, interpret=True))
    tk, tks = tint8.quantize_kv(torch.from_numpy(kp))
    tv, tvs = tint8.quantize_kv(torch.from_numpy(vp))
    got = tpa.ragged_paged_attention(
        torch.from_numpy(q), tk, tv, *_t((pt, qs, ql, kl)),
        k_scale=tks, v_scale=tvs).numpy()
    np.testing.assert_allclose(got, want, atol=REF_ATOL)
    np.testing.assert_allclose(got, kern, atol=PALLAS_ATOL)
    assert np.all(got[~_owned(qs, ql, q.shape[0])] == 0.0)


def test_token_descriptors_match_jax():
    _, _, _, _, qs, ql, kl = _mixed_batch(0, 8, 4, 32)
    jr, jv = jpa._token_descriptors(*_j((qs, ql, kl)), 16)
    tr, tv = tpa._token_descriptors(*_t((qs, ql, kl)), 16)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    owned = np.asarray(jv) > 0
    np.testing.assert_array_equal(tr.numpy()[owned], np.asarray(jr)[owned])
    assert tv.dtype == torch.int32 and tr.dtype == torch.int32


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(3).standard_normal((64, 4, 64), np.float32)
    x[5, 2] = 0.0                       # all-zero row: the 1e-8 floor
    jq, js = jint8.quantize_kv(jnp.asarray(x))
    tq, ts = tint8.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    back = tint8.dequantize_kv(tq, ts).numpy()
    np.testing.assert_allclose(back, np.asarray(jint8.dequantize_kv(jq, js)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_write_ragged_kv_matches_jax(int8):
    rng = np.random.default_rng(4)
    Hkv, ps, D, P, T = 2, 8, 16, 5, 10
    k_t = rng.standard_normal((T, Hkv, D), np.float32)
    v_t = rng.standard_normal((T, Hkv, D), np.float32)
    page = np.array([1, 1, 1, 2, 2, 3, 3, 3, 4, 0], np.int32)
    slot = np.array([0, 1, 2, 5, 6, 0, 1, 7, 3, 0], np.int32)
    pool_dtype = np.int8 if int8 else np.float32
    kp = np.zeros((P, Hkv, ps, D), pool_dtype)
    vp = np.zeros_like(kp)
    jsc = [jnp.zeros((P, Hkv, ps), jint8.KV_SCALE_DTYPE)] * 2 if int8 \
        else [None, None]
    tsc = [torch.zeros(P, Hkv, ps, dtype=tint8.KV_SCALE_DTYPE)
           for _ in range(2)] if int8 else [None, None]
    want = jpa.write_ragged_kv(*_j((kp, vp, k_t, v_t, page, slot)), *jsc)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = tpa.write_ragged_kv(tk, tv, *_t((k_t, v_t, page, slot)), *tsc)
    assert got[0] is tk and got[1] is tv        # written in place
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        # page 0 is the scratch page: only token 9 writes it, once
        np.testing.assert_array_equal(g, w)


def test_dispatcher_rejects_kernel_on_cpu_and_bad_impl():
    args = _t(_mixed_batch(2, 8, 4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.ragged_paged_attention(*args, impl="kernel")
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(*args, impl="pallas")
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(*args, k_scale=torch.zeros(12, 4, 8))
    before = dict(tpa.launch_counts)
    tpa.ragged_paged_attention(*args, impl="reference")
    assert tpa.launch_counts == before   # CPU work launches nothing
