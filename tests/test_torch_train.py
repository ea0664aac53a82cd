"""The port's training path against the JAX package's, on the CPU: loss and
gradients of ``loss_fn`` under every attention and remat policy, the int8
MLP product, the train step with SGD and AdamW against optax, and the step
profiler.

Parameters are made by the JAX package and carried over with
``ray_tpu_torch.convert``; tokens and activations come from a numpy seed.
Both sides run in fp32, so they differ only in the order of fp32 sums:
losses agree to 1e-5, gradients and updated parameters to 1e-5 of their
leaf's largest value (plus 1e-7).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import int8 as jint8
from ray_tpu.train.train_step import make_train_step as jax_train_step
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import int8 as tint8
from ray_tpu_torch.train import (PHASES, StepBreakdown, make_train_step,
                                 param_leaves, profile_train_step)

torch.set_num_threads(1)

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5


def _configs(**kw):
    return (jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32, **kw),
            tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _configs()
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16))
    return jparams, tokens


def _torch_params(jparams, requires_grad=True):
    params = convert.from_jax(jparams, device="cpu")
    for leaf in param_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def _leaves_np(tree):
    """Leaves (torch tensors or JAX arrays) in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    return [np.asarray(tree)]


def assert_trees_close(got, want, rtol=GRAD_RTOL):
    got, want = _leaves_np(got), _leaves_np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * np.abs(w).max() + 1e-7)


def _torch_loss_and_grads(tcfg, jparams, tokens):
    params = _torch_params(jparams)
    loss = tl.loss_fn(params, torch.from_numpy(tokens), tcfg)
    loss.backward()
    grads = {k: v.grad if isinstance(v, torch.Tensor) else
             {n: t.grad for n, t in v.items()} for k, v in params.items()}
    return float(loss.detach()), grads


@pytest.mark.parametrize("attention", ["full", "flash"])
@pytest.mark.parametrize("policy", ["full", "dots", "selective"])
def test_loss_and_grads_match_jax(setup, attention, policy):
    jparams, tokens = setup
    jcfg, tcfg = _configs(attention=attention, remat_policy=policy)
    # JAX's flash on the CPU runs blockwise_attention (llama.py:268-270)
    jloss, jgrads = jax.value_and_grad(functools.partial(
        jl.loss_fn, cfg=jcfg))(jparams, jnp.asarray(tokens))
    loss, grads = _torch_loss_and_grads(tcfg, jparams, tokens)
    assert loss == pytest.approx(float(jloss), abs=LOSS_TOL)
    assert_trees_close(grads, jgrads)


def test_remat_policies_identical_and_unknown_raises(setup):
    jparams, tokens = setup
    _, ref_cfg = _configs(remat=False)
    ref_loss, ref_grads = _torch_loss_and_grads(ref_cfg, jparams, tokens)
    for policy in ("full", "dots", "dots_no_batch", "selective"):
        for attention in ("full", "flash"):
            _, tcfg = _configs(remat_policy=policy, attention=attention)
            loss, grads = _torch_loss_and_grads(tcfg, jparams, tokens)
            assert loss == pytest.approx(ref_loss, abs=1e-6), policy
            assert_trees_close(grads, ref_grads, rtol=1e-6)
    with pytest.raises(ValueError, match="remat_policy"):
        tl.remat_policy_fn("nope")
    _, bad = _configs(remat_policy="nope")
    with pytest.raises(ValueError, match="remat_policy"):
        tl.loss_fn(_torch_params(jparams), torch.from_numpy(tokens), bad)
    _, ring = _configs(attention="ring")
    with pytest.raises(ValueError, match="mesh"):
        tl.loss_fn(_torch_params(jparams), torch.from_numpy(tokens), ring)


def test_grad_reaches_every_leaf_and_serving_runs_without_grad(setup):
    jparams, tokens = setup
    _, tcfg = _configs(attention="flash", remat_policy="selective")
    params = _torch_params(jparams)
    tl.loss_fn(params, torch.from_numpy(tokens), tcfg).backward()
    for leaf in param_leaves(params):
        assert leaf.grad is not None and leaf.grad.abs().sum() > 0
    with torch.no_grad():
        logits = tl.forward(params, torch.from_numpy(tokens), tcfg)
    assert logits.grad_fn is None and not logits.requires_grad
    # serving's forward callers disable grad themselves: the engine against
    # the full forward, as chip_smoke.py's oracle phase runs it on the card
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.phase_oracle(torch.device("cpu"), tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_and_straight_through_grads_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, 5, 48)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jd), jnp.asarray(w, jd)
    jout, vjp = jax.vjp(jint8.int8_matmul, jx, jw)
    jdx, jdw = vjp(jnp.asarray(g, jd))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tw = torch.from_numpy(w).to(td).requires_grad_()
    out = tint8.int8_matmul(tx, tw)
    out.backward(torch.from_numpy(g).to(td))
    # the int8 values and int32 sums agree exactly; the fp32 rescale and
    # the exact fp32 gradient products differ in summation order only,
    # then each side rounds to the working dtype (one bf16 step)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for got, want in ((out, jout), (tx.grad, jdx), (tw.grad, jdw)):
        assert got.dtype == td
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=tol, atol=tol * np.abs(want).max())


def test_int8_mlp_loss_and_grads_match_jax(setup):
    jparams, tokens = setup
    jcfg, tcfg = _configs(int8_mlp=True, remat_policy="selective")
    jloss, jgrads = jax.value_and_grad(functools.partial(
        jl.loss_fn, cfg=jcfg))(jparams, jnp.asarray(tokens))
    loss, grads = _torch_loss_and_grads(tcfg, jparams, tokens)
    assert loss == pytest.approx(float(jloss), abs=LOSS_TOL)
    assert_trees_close(grads, jgrads, rtol=1e-4)


def _load_adam_state(params, opt, jp, jstate):
    """Put JAX's parameters and optax's Adam moments into the torch
    parameters and ``torch.optim.AdamW``'s state: mu -> exp_avg, nu ->
    exp_avg_sq, count -> step (a float tensor), leaf by leaf in JAX's
    flattening order."""
    adam = next(s for s in jstate if isinstance(s, optax.ScaleByAdamState))
    leaves = param_leaves(params)
    with torch.no_grad():
        for leaf, p, mu, nu in zip(leaves, _leaves_np(jp),
                                   _leaves_np(adam.mu), _leaves_np(adam.nu)):
            leaf.copy_(torch.from_numpy(p.copy()))
            opt.state[leaf] = {
                "step": torch.tensor(float(adam.count)),
                "exp_avg": torch.from_numpy(mu.copy()),
                "exp_avg_sq": torch.from_numpy(nu.copy())}


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_train_step_matches_optax(setup, name):
    """SGD: three chained steps. AdamW: each of three steps from JAX's
    state (parameters and optax's moments loaded into torch's), because
    chained Adam steps drift apart with the machine's fp32 sum order:
    1/sqrt(nu) turns fp32 noise in near-zero gradients into updates of
    nearly +-lr (a loss gap of 1e-5 by the third step), while one step from
    a common state agrees to 1e-6 in the loss."""
    jparams, tokens = setup
    jcfg, tcfg = _configs(attention="flash", remat_policy="selective")
    jopt, topt = {
        "sgd": (optax.sgd(1e-2),
                lambda ps: torch.optim.SGD(ps, lr=1e-2)),
        "adamw": (optax.adamw(1e-3),     # b1 .9, b2 .999, eps 1e-8, wd 1e-4
                  lambda ps: torch.optim.AdamW(ps, lr=1e-3,
                                               weight_decay=1e-4)),
    }[name]
    jinit, jstep = jax_train_step(
        lambda p, b: jl.loss_fn(p, b, jcfg), jopt, donate=False)
    init, step = make_train_step(lambda p, b: tl.loss_fn(p, b, tcfg), topt)
    jp, jstate = jparams, jinit(jparams)
    params = _torch_params(jparams, requires_grad=False)
    opt = init(params)
    batch = torch.from_numpy(tokens)
    for _ in range(3):
        if name == "adamw":
            _load_adam_state(params, opt, jp, jstate)
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(tokens))
        out, opt, m = step(params, opt, batch)
        assert out is params
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 abs=LOSS_TOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        if name == "adamw":
            assert_trees_close(params, jp)
    assert all(leaf.grad is None for leaf in param_leaves(params))
    assert_trees_close(params, jp)


def test_num_params_and_flops_per_token_match_jax():
    bench = dict(vocab_size=32000, dim=3072, n_layers=8, n_heads=24,
                 n_kv_heads=12, ffn_dim=12288)
    for jcfg, tcfg in ((jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()),
                       (jl.LlamaConfig.llama3_8b(), tl.LlamaConfig.llama3_8b()),
                       (jl.LlamaConfig(**bench), tl.LlamaConfig(**bench))):
        assert tl.num_params(tcfg) == jl.num_params(jcfg)
        for L in (16, 2048):
            assert tl.flops_per_token(tcfg, L) == jl.flops_per_token(jcfg, L)
    assert tl.num_params(tl.LlamaConfig(**bench)) == 1_230_818_304
    defaults = dataclasses.asdict(tl.LlamaConfig())
    for field in ("attention", "remat", "remat_policy", "int8_mlp"):
        assert defaults[field] == getattr(jl.LlamaConfig(), field), field


def test_profile_train_step_sums_and_leaves_state_untouched(setup):
    jparams, tokens = setup
    _, tcfg = _configs(attention="flash", remat_policy="selective")
    loss = functools.partial(tl.loss_fn, cfg=tcfg)
    opt_fn = functools.partial(torch.optim.AdamW, lr=1e-3)
    init, step = make_train_step(loss, opt_fn)
    params = _torch_params(jparams, requires_grad=False)
    opt = init(params)
    batch = torch.from_numpy(tokens)
    step(params, opt, batch)           # optimizer state exists
    before_p = [t.detach().clone() for t in param_leaves(params)]
    before_s = {i: {k: v.clone() for k, v in s.items()}
                for i, s in enumerate(opt.state.values())}
    bd = profile_train_step(loss, opt_fn, params, opt, batch, steps=2,
                            warmup=1)
    assert isinstance(bd, StepBreakdown)
    assert set(bd.phases) == set(PHASES)
    assert all(v >= 0.0 for v in bd.phases.values())
    assert bd.step_time_s > 0 and bd.compile_time_s >= 0
    assert bd.compile_source == "inferred"
    assert sum(bd.phases.values()) == pytest.approx(bd.step_time_s,
                                                    rel=1e-9)
    assert bd.phase_ms()["forward"] == pytest.approx(
        bd.phases["forward"] * 1e3)
    for a, b in zip(param_leaves(params), before_p):
        assert torch.equal(a.detach(), b)
    for i, s in enumerate(opt.state.values()):
        for k, v in s.items():
            assert torch.equal(v, before_s[i][k]), k
