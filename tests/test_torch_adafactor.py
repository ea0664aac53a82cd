"""The port's Adafactor against ``optax.adafactor(1e-3)``, on the CPU.

Synthetic trees cover both kinds of leaf and the boundary between them:
leaves whose second-largest dim is 127 keep a full second moment, 128 and
up factor it, over either order of the two largest dims and over equal
ones, stacked 3-D leaves among them, with a parameter whose RMS is under
optax's 1e-3 floor. A Llama config at widths of 128 and 256 does the same
through ``loss_fn`` and ``make_train_step``.

Each step is held against optax from optax's own state, mapped onto the
optimizer's by ``load_adafactor_state`` (``v_row``, ``v_col`` or ``v``,
and the count), as the AdamW parity test does; three chained steps follow
the same trajectory on both sides. Both sides compute in fp32 from the
same gradients, so they differ in the order of fp32 sums only (the means
of g² and the RMS of the update and of the parameter): parameters agree
to 1e-6 of their leaf's largest value and second moments to 1e-5 of
theirs. Through the Llama's ``loss_fn`` the gradients themselves differ
by summation order too (tests/test_torch_train.py), and the same limits
hold.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import FactoredState

from ray_tpu.models import llama as jl
from ray_tpu.train.train_step import make_train_step as jax_train_step
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import Adafactor, make_train_step, param_leaves
from ray_tpu_torch.train.optim import factored_dims

torch.set_num_threads(1)

PARAM_RTOL = 1e-6
STATE_RTOL = 1e-5
LOSS_TOL = 1e-5

# name -> (shape, parameter scale); the second-largest dim decides
SYNTHETIC = {
    "vector": ((300,), 1.0),
    "scalar_like": ((1,), 0.5),
    "below_boundary": ((127, 300), 0.1),
    "at_boundary": ((128, 300), 0.1),
    "transposed": ((300, 128), 0.1),
    "equal_dims": ((2, 128, 128), 0.05),
    "stacked": ((3, 128, 256), 0.05),
    "stacked_transposed": ((3, 256, 130), 0.05),
    "stacked_small": ((4, 127, 200), 0.05),
    "tiny_scale": ((128, 160), 1e-5),
}


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    return [np.asarray(tree)]


def _close(got, want, rtol):
    got, want = _leaves_np(got), _leaves_np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * np.abs(w).max() + 1e-30)


def load_adafactor_state(params, opt, jparams, jstate):
    """optax's state -> the optimizer's, leaf by leaf in JAX's flattening
    order: the parameters, the count, and ``v_row``/``v_col`` for a
    factored leaf or ``v`` for the others (optax keeps (1,) placeholders
    in the slots a leaf does not use)."""
    fs = next(s for s in jstate if isinstance(s, FactoredState))
    leaves = param_leaves(params)
    with torch.no_grad():
        for leaf, p, vr, vc, v in zip(
                leaves, _leaves_np(jparams), _leaves_np(fs.v_row),
                _leaves_np(fs.v_col), _leaves_np(fs.v)):
            leaf.copy_(torch.from_numpy(p.copy()))
            state = {"step": torch.tensor(float(fs.count))}
            if factored_dims(tuple(leaf.shape)) is None:
                state["v"] = torch.from_numpy(v.copy())
            else:
                state["v_row"] = torch.from_numpy(vr.copy())
                state["v_col"] = torch.from_numpy(vc.copy())
            opt.state[leaf] = state


def _state_tree(opt, params):
    """The optimizer's second moments in optax's layout."""
    out = {"v_row": [], "v_col": [], "v": []}
    for leaf in param_leaves(params):
        s = opt.state[leaf]
        for k in out:
            out[k].append(s[k].numpy() if k in s else None)
    return out


def _assert_state_close(opt, params, jstate, rtol):
    fs = next(s for s in jstate if isinstance(s, FactoredState))
    mine = _state_tree(opt, params)
    for key in ("v_row", "v_col", "v"):
        for got, want in zip(mine[key], _leaves_np(getattr(fs, key))):
            if got is None:
                assert want.shape == (1,) and not want.any()
                continue
            assert got.shape == want.shape, key
            np.testing.assert_allclose(
                got, want, rtol=0, atol=rtol * np.abs(want).max())
    for leaf in param_leaves(params):
        assert float(opt.state[leaf]["step"]) == float(fs.count)


def _synthetic(seed):
    rng = np.random.default_rng(seed)
    return {name: (scale * rng.standard_normal(shape)).astype(np.float32)
            for name, (shape, scale) in SYNTHETIC.items()}


def test_factored_dims_match_optax():
    from optax._src.factorized import _factored_dims
    for shape, _ in SYNTHETIC.values():
        assert factored_dims(shape) == _factored_dims(shape, True, 128), \
            shape
    assert factored_dims((127, 300)) is None
    assert factored_dims((128, 300)) == (0, 1)
    assert factored_dims((300, 128)) == (1, 0)


@pytest.mark.parametrize("chained", [False, True])
def test_adafactor_matches_optax_on_synthetic_trees(chained):
    """Three steps on gradients from a numpy seed: each from optax's
    state, or all three chained on both sides."""
    jparams = {k: jnp.asarray(v) for k, v in _synthetic(0).items()}
    tx = optax.adafactor(1e-3)
    jstate = tx.init(jparams)
    params = {k: torch.from_numpy(v) for k, v in _synthetic(0).items()}
    opt = Adafactor(param_leaves(params), lr=1e-3)
    for step in range(3):
        grads = _synthetic(step + 1)
        if not chained:
            load_adafactor_state(params, opt, jparams, jstate)
        updates, jstate = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for leaf, g in zip(param_leaves(params), _leaves_np(grads)):
            leaf.grad = torch.from_numpy(g)
        opt.step()
        _close(params, jparams, PARAM_RTOL)
        _assert_state_close(opt, params, jstate, STATE_RTOL)
    assert int(next(s for s in jstate
                    if isinstance(s, FactoredState)).count) == 3


def test_adafactor_update_is_clipped_and_scaled():
    """One step by hand on an unfactored leaf: the first update is
    g / sqrt(g² + 1e-30), clipped to RMS 1, times lr and the parameter's
    RMS floored at 1e-3."""
    g = torch.tensor([3.0, -4.0, 0.0, 2.0])
    for scale in (2.0, 1e-5):
        p = torch.full((4,), scale)
        opt = Adafactor([p], lr=0.1)
        p.grad = g.clone()
        opt.step()
        u = g / torch.sqrt(g * g + 1e-30)
        u = u / max(1.0, float(u.pow(2).mean().sqrt()))
        want = scale - 0.1 * max(scale, 1e-3) * u
        torch.testing.assert_close(p, want, rtol=1e-6, atol=0)
        assert float(opt.state[p]["step"]) == 1.0


@pytest.fixture(scope="module")
def llama():
    kw = dict(dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256, n_layers=2,
              attention="flash", remat_policy="selective")
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32))
    return jcfg, tcfg, jparams, tokens


def test_llama_leaves_cover_both_kinds(llama):
    _, tcfg, jparams, _ = llama
    kinds = {k: factored_dims(tuple(v.shape))
             for k, v in jparams["layers"].items()}
    assert kinds["wq"] == (1, 2) and kinds["w_down"] == (2, 1)
    assert kinds["wk"] is None and kinds["attn_norm"] is None


@pytest.mark.parametrize("chained", [False, True])
def test_train_step_with_adafactor_matches_optax(llama, chained):
    """Three steps of ``make_train_step`` against the JAX package's with
    ``optax.adafactor(1e-3)``: each from optax's state, or chained."""
    jcfg, tcfg, jparams, tokens = llama
    jinit, jstep = jax_train_step(
        lambda p, b: jl.loss_fn(p, b, jcfg), optax.adafactor(1e-3),
        donate=False)
    init, step = make_train_step(
        functools.partial(tl.loss_fn, cfg=tcfg),
        functools.partial(Adafactor, lr=1e-3))
    jp, jstate = jparams, jinit(jparams)
    params = convert.from_jax(jparams, device="cpu")
    opt = init(params)
    batch = torch.from_numpy(tokens)
    for _ in range(3):
        if not chained:
            load_adafactor_state(params, opt, jp, jstate)
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(tokens))
        out, opt, m = step(params, opt, batch)
        assert out is params
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 abs=LOSS_TOL)
        _close(params, jp, PARAM_RTOL)
        _assert_state_close(opt, params, jstate, STATE_RTOL)
    assert all(leaf.grad is None for leaf in param_leaves(params))
