"""The port's routed MoE FFN (``ray_tpu_torch.parallel.moe``) against the
JAX package's dense reference (``ray_tpu.parallel.moe``), on the CPU.

The same parameters (drawn with numpy, or by the JAX package's
``init_moe_params`` and carried over with ``ray_tpu_torch.convert``) and
the same inputs go through both. In fp32 the routing indices are equal
and outputs and gradients differ only by the order of fp32 sums: within
1e-5 of each tensor's largest value. In bf16 only the tokens whose top-k
choice is clear of rounding noise are compared (``BF16_MARGIN``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import moe as jmoe
from ray_tpu_torch import convert
from ray_tpu_torch.parallel import moe as tmoe

torch.set_num_threads(1)

RTOL = 1e-5
# bf16: JAX and the port round fp32 router logits that differ in their
# last bits to bf16, so a logit may differ by one bf16 step: at most 2^-6
# for |logit| < 4. A logit change of at most δ moves probability p_i by
# at most 2·δ·p_i, so the gap between the 2nd and 3rd probability by at
# most 2·δ·(p2 + p3) < 2^-5 (p2 + p3 < 5/6). Tokens whose fp32 gap
# exceeds that keep their experts on both sides.
BF16_MARGIN = 2.0 ** -5
# bf16 outputs of those tokens, per row against its largest value: four
# bf16 roundings on each side (the two input products, silu x up, the
# output product: 2^-8 each) and the combine weights moved by the logits'
# one-step differences (2^-6 at most): 2^-5 in all (measured 0.013)
BF16_ROW_RTOL = 2.0 ** -5


def _params(rng, d, f, E, gated):
    p = {"router": rng.standard_normal((d, E)) * d ** -0.5,
         "w_in": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w_out": rng.standard_normal((E, f, d)) * f ** -0.5}
    if gated:
        p["w_gate"] = rng.standard_normal((E, d, f)) * d ** -0.5
    return {k: v.astype(np.float32) for k, v in p.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max() + 1e-7)


@pytest.mark.parametrize("T", [3, 64])
def test_routing_matches_jax(T):
    rng = np.random.default_rng(1)
    p = _params(rng, 16, 32, 8, gated=False)
    x = rng.standard_normal((T, 16)).astype(np.float32)
    jidx, jw = jmoe._routing({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), 2)
    tidx, tw = tmoe._routing(convert.from_jax(p, device="cpu"),
                             torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)


def test_combine_weights_sum_to_one():
    """As tests/test_moe.py: the renormalized top-k weights of each token
    sum to 1, and the output has x's shape, dtype and finite values."""
    params = tmoe.init_moe_params(16, 32, 8, seed=0, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((12, 16)).astype(np.float32))
    _, w = tmoe._routing(params, x, 2)
    torch.testing.assert_close(w.sum(-1), torch.ones(12), rtol=0,
                               atol=1e-6)
    out = tmoe.moe_ffn(params, x, top_k=2)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.isfinite(out).all()


def test_init_moe_params_matches_jax_tree_and_seed():
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), dim=16, ffn_dim=32,
                              num_experts=8)
    tp = tmoe.init_moe_params(16, 32, 8, seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    again = tmoe.init_moe_params(16, 32, 8, seed=3, device="cpu")
    for k in tp:
        assert tp[k].dtype == torch.float32
        assert torch.equal(tp[k], again[k])
    half = tmoe.init_moe_params(16, 32, 8, seed=3, device="cpu",
                                dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half.values())


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("T", [3, 64])
def test_moe_ffn_and_grads_match_jax(gated, T):
    """fp32 output and the gradients of <out, g> with respect to x and
    every leaf. T 3 with 8 experts leaves experts without tokens, which
    the port skips and JAX multiplies by 0."""
    rng = np.random.default_rng(3)
    p = _params(rng, 16, 32, 8, gated)
    x = rng.standard_normal((T, 16)).astype(np.float32)
    g = rng.standard_normal((T, 16)).astype(np.float32)

    def jloss(params, x):
        return jnp.sum(jmoe.moe_ffn(params, x, top_k=2) * g)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jout = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=2)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    tp = convert.from_jax(p, device="cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    before = tmoe.sync_counts["segment_sizes"]
    out = tmoe.moe_ffn(tp, tx, top_k=2)
    assert tmoe.sync_counts["segment_sizes"] == before + 1
    (out * torch.from_numpy(g)).sum().backward()
    _close(out, jout)
    _close(tx.grad, jgx)
    assert set(tp) == set(jgp)
    for k in tp:
        _close(tp[k].grad, jgp[k])


def test_bf16_moe_ffn_matches_jax_where_routing_is_clear():
    """bf16 parameters and x: rows whose fp32 gap between the 2nd and 3rd
    router probability exceeds BF16_MARGIN route to the same experts on
    both sides and agree within BF16_ROW_RTOL of their largest value."""
    rng = np.random.default_rng(4)
    p = _params(rng, 64, 128, 8, gated=True)
    x = rng.standard_normal((512, 64)).astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    jout = np.asarray(jmoe.moe_ffn(jp, jx).astype(jnp.float32))
    jidx, _ = jmoe._routing(jp, jx, 2)
    tp = convert.from_jax(jp, device="cpu")
    tx = convert.from_jax(jx, device="cpu")
    out = tmoe.moe_ffn(tp, tx)
    assert out.dtype == torch.bfloat16
    tidx, _ = tmoe._routing(tp, tx, 2)
    # the gap on the bf16 values, computed in fp32
    probs = torch.softmax(tx.float() @ tp["router"].float(), dim=-1)
    top3 = probs.topk(3, dim=-1).values
    clear = ((top3[:, 1] - top3[:, 2]) > BF16_MARGIN).numpy()
    assert clear.sum() >= 256, clear.sum()
    np.testing.assert_array_equal(np.sort(tidx.numpy(), -1)[clear],
                                  np.sort(np.asarray(jidx), -1)[clear])
    err = np.abs(out.float().numpy() - jout).max(-1)
    ratio = err / (BF16_ROW_RTOL * np.abs(jout).max(-1))
    assert ratio[clear].max() <= 1, ratio[clear].max()


def test_expert_segments_follow_the_stable_sort():
    """Each expert's rows are its tokens in token order; an expert with no
    tokens is skipped and its weights get a zero gradient."""
    params = tmoe.init_moe_params(8, 16, 4, seed=5, device="cpu")
    for v in params.values():
        v.requires_grad_(True)
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(6))
    idx = torch.tensor([[3, 1], [1, 3]])
    w = torch.tensor([[0.75, 0.25], [0.5, 0.5]])
    out = tmoe._routed_sum(params, x, idx, w)
    want = torch.zeros(2, 8)
    for e in (1, 3):        # index order, as the JAX sum
        y = tmoe._expert_ffn(params["w_in"][e], params["w_out"][e], x)
        want = want + (w * (idx == e)).sum(-1, keepdim=True) * y
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    out.sum().backward()
    for e in (0, 2):
        assert not params["w_in"].grad[e].any()
        assert not params["w_out"].grad[e].any()
    assert params["w_in"].grad[1].any() and params["w_in"].grad[3].any()


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tmoe.init_moe_params(8, 16, 4)
