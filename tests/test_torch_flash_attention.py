"""The port's flash attention against the JAX package's, on the CPU.

The JAX kernels run in Pallas interpret mode (as ``tests/test_ops.py`` runs
them); the port's CPU tensors run its plain versions, which compute what
the kernels' bodies compute. Inputs come from a numpy seed.

Tolerances. fp32: the two sides differ only in the order of fp32 sums,
so they agree to 2e-5 (values and gradients of order 1). bf16: both sides
round fp32 values that differ by summation order, so an output differs by
at most one bf16 step of its row's largest value (2^-7 of it); rounding p
and ds to bf16 before the products can flip one more step in a row's
terms, so the gradients are held to 2^-6 of their row's largest value.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa

# the module (ray_tpu.ops re-exports a function of the same name)
jfa = importlib.import_module("ray_tpu.ops.flash_attention")

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_RTOL = {"out": 2.0 ** -7, "grad": 2.0 ** -6}


def _arrays(shape, seed, n=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, dtype, kind="out"):
    """fp32: within F32_TOL. bf16: per row (last axis) within
    BF16_RTOL[kind] of that row's largest |want|, plus 1e-5."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    err = np.abs(got - want).max(-1)
    limit = BF16_RTOL[kind] * np.abs(want).max(-1) + 1e-5
    assert (err <= limit).all(), float((err / limit).max())


CASES = [  # (causal, Lq, Lk)
    (True, 128, 128), (False, 128, 128), (True, 64, 128), (True, 128, 64),
    (False, 64, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Lq,Lk", CASES)
def test_plain_fwd_and_bwd_match_pallas_interpret(dtype, causal, Lq, Lk):
    BH, D, blk = 3, 32, 32
    q, do = _arrays((BH, Lq, D), 1, 2)
    k, v = _arrays((BH, Lk, D), 2, 2)
    dlse = _arrays((BH, Lq), 3)[0]
    scale = D ** -0.5
    jo, jlse = jfa._fwd_call(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                             causal, scale, blk, blk, True)
    to, tlse = tfa._fwd_call(_torch(q, dtype), _torch(k, dtype),
                             _torch(v, dtype), causal, scale, blk, blk)
    assert to.dtype == getattr(torch, dtype) and tlse.dtype == torch.float32
    assert_close(to, jo, dtype)
    np.testing.assert_allclose(_np(tlse), _np(jlse)[:, 0], rtol=1e-5,
                               atol=1e-5)
    # the backward from the same forward results, with an lse cotangent
    jgrads = jfa._bwd_call(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                           jo, jlse, _jax(do, dtype), causal, scale, blk,
                           blk, True, dlse=jnp.asarray(dlse))
    o_t = torch.from_numpy(_np(jo).copy()).to(getattr(torch, dtype))
    lse_t = torch.from_numpy(_np(jlse)[:, 0].copy())
    tgrads = tfa._bwd_call(_torch(q, dtype), _torch(k, dtype),
                           _torch(v, dtype), o_t, lse_t, _torch(do, dtype),
                           causal, scale, blk, blk,
                           dlse=torch.from_numpy(dlse))
    for name, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert got.dtype == getattr(torch, dtype), name
        assert_close(got, want, dtype, "grad")


def _worst_ratio(got, want, rtol):
    """Worst per-row |got - want| / (rtol * max|want| + 1e-5)."""
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max(-1)
    return float((err / (rtol * np.abs(want).max(-1) + 1e-5)).max())


# the bf16 CUDA kernels' tiles: the forward's 128 q rows x 128 keys, the
# dk/dv kernel's 64 q rows x 128 keys, the dq kernel's 128 q rows x 64 keys
FWD_TILES, BWD_TILES, DQ_TILES = (128, 128), (64, 128), (128, 64)
CARD_RTOL = 2.0 ** -6   # chip_smoke.py's and the card tests' per-row limit


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_at_the_kernel_tiles_hold_the_card_limit(causal):
    """The card holds the kernels against the plain versions at their
    default 256-row blocks within CARD_RTOL; that limit rests on how far
    the tiling alone moves a bf16 result. Here the plain versions at the
    kernels' tiles stand in for the kernels: against the default blocks
    within CARD_RTOL, and against the Pallas kernels in interpret mode at
    the same tiles within this module's own limits."""
    BH, L, D = 2, 512, 128
    q, k, v, do = _arrays((BH, L, D), 10, 4)
    dlse = _arrays((BH, L), 11)[0]
    scale = D ** -0.5
    tq, tk, tv, tdo = (_torch(a, "bfloat16") for a in (q, k, v, do))
    o_t, lse_t = tfa._fwd_reference(tq, tk, tv, causal, scale, *FWD_TILES)
    o_d, lse_d = tfa._fwd_reference(tq, tk, tv, causal, scale)
    delta = (tdo.float() * o_d.float()).sum(-1) - torch.from_numpy(dlse)
    g_t = tfa._bwd_reference(tq, tk, tv, lse_d, tdo, delta, causal, scale,
                             *BWD_TILES)
    g_d = tfa._bwd_reference(tq, tk, tv, lse_d, tdo, delta, causal, scale)
    ratios = {name: _worst_ratio(got, want, CARD_RTOL) for name, got, want
              in zip(("o", "dq", "dk", "dv"), (o_t, *g_t), (o_d, *g_d))}
    assert max(ratios.values()) <= 1, f"tiles vs 256-row blocks: {ratios}"
    np.testing.assert_allclose(_np(lse_t), _np(lse_d), rtol=1e-5, atol=1e-5)

    # the Pallas kernels in interpret mode at the same tiles
    jq, jk, jv, jdo = (_jax(a, "bfloat16") for a in (q, k, v, do))
    jo, jlse = jfa._fwd_call(jq, jk, jv, causal, scale, *FWD_TILES, True)
    jgrads = jfa._bwd_call(jq, jk, jv, jo, jlse, jdo, causal, scale,
                           *BWD_TILES, True, dlse=jnp.asarray(dlse))
    o_j = torch.from_numpy(_np(jo).copy()).to(torch.bfloat16)
    lse_j = torch.from_numpy(_np(jlse)[:, 0].copy())
    tgrads = tfa._bwd_call(tq, tk, tv, o_j, lse_j, tdo, causal, scale,
                           *BWD_TILES, dlse=torch.from_numpy(dlse))
    vs_pallas = {"o": _worst_ratio(o_t, jo, BF16_RTOL["out"])}
    vs_pallas.update({name: _worst_ratio(got, want, BF16_RTOL["grad"])
                      for name, got, want in zip(("dq", "dk", "dv"), tgrads,
                                                 jgrads)})
    assert max(vs_pallas.values()) <= 1, f"vs Pallas: {vs_pallas}"
    np.testing.assert_allclose(_np(lse_t), _np(jlse)[:, 0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_dq_at_the_dq_kernel_tiles_holds_the_card_limit(causal):
    """The same for dq at the sm90 dq kernel's tiles (128 q rows x 64 keys,
    ds rounded to bf16 per tile): against the default 256-row blocks within
    CARD_RTOL, and against the Pallas kernels in interpret mode at the same
    tiles within this module's own limit."""
    BH, L, D = 2, 512, 128
    q, k, v, do = _arrays((BH, L, D), 12, 4)
    dlse = _arrays((BH, L), 13)[0]
    scale = D ** -0.5
    tq, tk, tv, tdo = (_torch(a, "bfloat16") for a in (q, k, v, do))
    o_d, lse_d = tfa._fwd_reference(tq, tk, tv, causal, scale)
    delta = (tdo.float() * o_d.float()).sum(-1) - torch.from_numpy(dlse)
    dq_t = tfa._bwd_reference(tq, tk, tv, lse_d, tdo, delta, causal, scale,
                              *DQ_TILES)[0]
    dq_d = tfa._bwd_reference(tq, tk, tv, lse_d, tdo, delta, causal,
                              scale)[0]
    ratio = _worst_ratio(dq_t, dq_d, CARD_RTOL)
    assert ratio <= 1, f"dq tiles vs 256-row blocks: {ratio}"

    jq, jk, jv, jdo = (_jax(a, "bfloat16") for a in (q, k, v, do))
    jo, jlse = jfa._fwd_call(jq, jk, jv, causal, scale, 256, 256, True)
    jdq = jfa._bwd_call(jq, jk, jv, jo, jlse, jdo, causal, scale,
                        *DQ_TILES, True, dlse=jnp.asarray(dlse))[0]
    o_j = torch.from_numpy(_np(jo).copy()).to(torch.bfloat16)
    lse_j = torch.from_numpy(_np(jlse)[:, 0].copy())
    tdq = tfa._bwd_call(tq, tk, tv, o_j, lse_j, tdo, causal, scale,
                        *DQ_TILES, dlse=torch.from_numpy(dlse))[0]
    ratio = _worst_ratio(tdq, jdq, BF16_RTOL["grad"])
    assert ratio <= 1, f"dq vs Pallas at the dq tiles: {ratio}"


# sequences the kernels' 128-row tiles do not divide: the last q tile and
# the last key tile of the sm90 designs are partial (masked on the card)
PARTIAL_CASES = [(200, 200), (72, 200), (200, 72)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Lq,Lk", PARTIAL_CASES)
def test_plain_versions_at_partial_kernel_tiles_hold_the_card_limit(
        causal, Lq, Lk):
    """The emulations above at lengths no kernel tile divides: the plain
    versions at the forward's, dk/dv's and dq's tiles, each with a shorter
    last tile as the kernels mask theirs, against the default blocks (one
    block here) within CARD_RTOL, and against the Pallas kernels in
    interpret mode at their default blocks within this module's limits."""
    BH, D = 2, 128
    q, do = _arrays((BH, Lq, D), 14, 2)
    k, v = _arrays((BH, Lk, D), 15, 2)
    dlse = _arrays((BH, Lq), 16)[0]
    scale = D ** -0.5
    tq, tk, tv, tdo = (_torch(a, "bfloat16") for a in (q, k, v, do))
    o_t, lse_t = tfa._fwd_reference(tq, tk, tv, causal, scale, *FWD_TILES)
    o_d, lse_d = tfa._fwd_reference(tq, tk, tv, causal, scale)
    delta = (tdo.float() * o_d.float()).sum(-1) - torch.from_numpy(dlse)
    _, dk_t, dv_t = tfa._bwd_reference(tq, tk, tv, lse_d, tdo, delta, causal,
                                       scale, *BWD_TILES)
    dq_t = tfa._bwd_reference(tq, tk, tv, lse_d, tdo, delta, causal, scale,
                              *DQ_TILES)[0]
    g_d = tfa._bwd_reference(tq, tk, tv, lse_d, tdo, delta, causal, scale)
    ratios = {name: _worst_ratio(got, want, CARD_RTOL) for name, got, want
              in zip(("o", "dq", "dk", "dv"), (o_t, dq_t, dk_t, dv_t),
                     (o_d, *g_d))}
    assert max(ratios.values()) <= 1, f"partial tiles vs blocks: {ratios}"
    np.testing.assert_allclose(_np(lse_t), _np(lse_d), rtol=1e-5, atol=1e-5)

    jq, jk, jv, jdo = (_jax(a, "bfloat16") for a in (q, k, v, do))
    jo, jlse = jfa._fwd_call(jq, jk, jv, causal, scale, 256, 256, True)
    jgrads = jfa._bwd_call(jq, jk, jv, jo, jlse, jdo, causal, scale, 256,
                           256, True, dlse=jnp.asarray(dlse))
    vs_pallas = {"o": _worst_ratio(o_t, jo, BF16_RTOL["out"])}
    vs_pallas.update({name: _worst_ratio(got, want, BF16_RTOL["grad"])
                      for name, got, want in zip(
                          ("dq", "dk", "dv"), (dq_t, dk_t, dv_t), jgrads)})
    assert max(vs_pallas.values()) <= 1, f"vs Pallas: {vs_pallas}"
    np.testing.assert_allclose(_np(lse_t), _np(jlse)[:, 0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(72, 72), (200, 72), (1, 130)])
def test_query_rows_past_lq_add_nothing_to_dk_dv(causal, Lq, Lk):
    """The dk/dv kernels mask no query row past Lq in a partial last tile:
    there q and do are zeros (the tensor maps' fill, or the first designs'
    tile loads) and lse and delta are padded with zeros, so s = 0, p = 1,
    p^T . do = 0 and ds = 1 (0 - 0) = 0. Rows padded so to a multiple of
    64 give the same dk and dv in fp32, and dq's rows up to Lq."""
    BH, D = 2, 32
    q, do = _arrays((BH, Lq, D), 21, 2)
    k, v = _arrays((BH, Lk, D), 22, 2)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    scale = D ** -0.5
    o, lse = tfa._fwd_reference(tq, tk, tv, causal, scale)
    delta = (tdo * o).sum(-1)
    want = tfa._bwd_reference(tq, tk, tv, lse, tdo, delta, causal, scale)
    pad = -Lq % tfa.LSE_PAD
    rows = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))  # noqa: E731
    cols = lambda t: torch.nn.functional.pad(t, (0, pad))  # noqa: E731
    got = tfa._bwd_reference(rows(tq), tk, tv, cols(lse), rows(tdo),
                             cols(delta), causal, scale)
    np.testing.assert_allclose(_np(got[0][:, :Lq]), _np(want[0]), rtol=1e-6,
                               atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)


# lengths the Pallas kernels take that no 64-row kernel tile divides: any
# L up to the default 256-row blocks (72, 200), L 1000 at pick_block's
# block (8), and Lq 72 against Lk 200; (Lq, Lk, block or None for
# pick_block's)
LENGTH_CASES = [(72, 72, 256), (200, 200, 256), (1000, 1000, None),
                (72, 200, 256)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Lq,Lk,blk", LENGTH_CASES)
def test_flash_at_lengths_no_kernel_tile_divides_matches_jax(causal, Lq, Lk,
                                                             blk):
    """The forward, lse and every gradient (an lse cotangent included)
    through ``flash_attention_block`` against the JAX package's, the Pallas
    kernels in interpret mode, in fp32 (F32_TOL). Causal with Lq != Lk
    counts positions from 0 in both, as the JAX package does. L 1000
    (blocks of 8: 125 x 125 interpreted steps a head) takes one head."""
    B, H, D = 1, 1 if Lq >= 1000 else 2, 16
    blk_q, blk_k = (blk, blk) if blk else (tfa.pick_block(Lq),
                                           tfa.pick_block(Lk))
    q, go = _arrays((B, Lq, H, D), 17, 2)
    k, v = _arrays((B, Lk, H, D), 18, 2)
    glse = _arrays((B, H, Lq), 19)[0]

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_block(q, k, v, causal, None, blk_q,
                                           blk_k, True)
        return jnp.sum(o * go) + jnp.sum(lse * glse), (o, lse)

    (_, (jo, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to, tlse = tfa.flash_attention_block(tq, tk, tv, causal, None, blk_q,
                                         blk_k)
    (to * torch.from_numpy(go)).sum().add(
        (tlse * torch.from_numpy(glse)).sum()).backward()
    assert to.shape == (B, Lq, H, D) and tlse.shape == (B, H, Lq)
    assert_close(to, jo, "float32")
    np.testing.assert_allclose(_np(tlse), _np(jlse), rtol=1e-5, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert_close(got, want, "float32", "grad")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Lq,Lk", [(True, 64, 64), (False, 64, 32),
                                          (True, 32, 64)])
def test_flash_attention_block_and_grads_match_jax(dtype, causal, Lq, Lk):
    B, H, D, blk = 2, 2, 32, 16
    q, go = _arrays((B, Lq, H, D), 4, 2)
    k, v = _arrays((B, Lk, H, D), 5, 2)
    glse = _arrays((B, H, Lq), 6)[0]

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_block(q, k, v, causal, None, blk, blk,
                                           True)
        return (jnp.sum(o.astype(jnp.float32) * go)
                + jnp.sum(lse * glse)), (o, lse)

    (_, (jo, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    to, tlse = tfa.flash_attention_block(tq, tk, tv, causal, None, blk, blk)
    (to.float() * torch.from_numpy(go)).sum().add(
        (tlse * torch.from_numpy(glse)).sum()).backward()
    assert to.shape == (B, Lq, H, D) and tlse.shape == (B, H, Lq)
    assert_close(to, jo, dtype)
    np.testing.assert_allclose(_np(tlse), _np(jlse), rtol=1e-5, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert_close(got, want, dtype, "grad")


def test_flash_attention_facade_has_no_lse_cotangent():
    q, k, v, go = _arrays((1, 64, 2, 32), 7, 4)
    jg = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, True, None, 32, 32, True) * go), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, True, None, 32, 32)
    (out * torch.from_numpy(go)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax(dtype, causal):
    q, k, v = _arrays((2, 64, 3, 16), 8, 3)
    want = jfa.blockwise_attention(_jax(q, dtype), _jax(k, dtype),
                                   _jax(v, dtype), causal=causal, block_k=16)
    got = tfa.blockwise_attention(_torch(q, dtype), _torch(k, dtype),
                                  _torch(v, dtype), causal=causal,
                                  block_k=16)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)
    with pytest.raises(ValueError, match="block_k"):
        tfa.blockwise_attention(_torch(q, dtype), _torch(k, dtype)[:, :48],
                                _torch(v, dtype)[:, :48], block_k=32)


def test_pick_block_matches_jax():
    for L in (1, 6, 8, 20, 24, 96, 100, 128, 256, 384, 1000, 2048):
        for preferred in (256, 128, 64, 16):
            for min_block in (8, 1):
                assert tfa.pick_block(L, preferred, min_block) == \
                    jfa.pick_block(L, preferred, min_block), \
                    (L, preferred, min_block)


def test_cpu_tensors_launch_nothing_and_blocks_must_divide():
    before = dict(tfa.launch_counts)
    q, k, v = (torch.from_numpy(a) for a in _arrays((2, 64, 32), 9, 3))
    o, lse = tfa._fwd_call(q, k, v, True, 0.2, 32, 32)
    tfa._bwd_call(q, k, v, o, lse, o, True, 0.2, 32, 32)
    assert tfa.launch_counts == before     # CPU work launches nothing
    with pytest.raises(ValueError, match="must divide"):
        tfa._fwd_call(q, k, v, True, 0.2, 48, 32)
