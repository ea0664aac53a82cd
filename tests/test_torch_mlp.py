"""The port's MLP (``ray_tpu_torch.models.mlp``) against the JAX package's
(``ray_tpu.models.mlp``), on the CPU: logits, loss and gradients in fp32
(summation order only: 1e-5 of each tensor's largest value), a list
parameter tree through ``convert`` and ``make_train_step``, and the
package's exports."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import mlp as jmlp
from ray_tpu.train.train_step import make_train_step as jax_train_step
from ray_tpu_torch import convert
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.train import (make_train_step, param_leaves,
                                 profile_train_step)

torch.set_num_threads(1)

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max() + 1e-7)


@pytest.fixture(scope="module")
def setup():
    cfg = jmlp.MLPConfig(in_dim=20, hidden=32, n_hidden=2, out_dim=5)
    jparams = jmlp.mlp_init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 20)).astype(np.float32)
    y = rng.integers(0, 5, 16)
    return jparams, x, y


def test_logits_loss_and_grads_match_jax(setup):
    jparams, x, y = setup
    jlogits = jmlp.mlp_apply(jparams, jnp.asarray(x))
    jloss, jgrads = jax.value_and_grad(jmlp.mlp_loss)(
        jparams, (jnp.asarray(x), jnp.asarray(y)))
    params = convert.from_jax(jparams, device="cpu")
    assert isinstance(params, list) and len(params) == 3
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    _close(tmlp.mlp_apply(params, torch.from_numpy(x)), jlogits)
    loss = tmlp.mlp_loss(params, (torch.from_numpy(x), torch.from_numpy(y)))
    assert loss.item() == pytest.approx(float(jloss), abs=RTOL)
    loss.backward()
    for layer, jlayer in zip(params, jgrads):
        for k in ("w", "b"):
            _close(layer[k].grad, jlayer[k])


def test_train_step_on_the_list_tree_matches_optax_sgd(setup):
    jparams, x, y = setup
    jinit, jstep = jax_train_step(jmlp.mlp_loss, optax.sgd(0.1),
                                  donate=False)
    init, step = make_train_step(
        tmlp.mlp_loss, lambda ps: torch.optim.SGD(ps, lr=0.1))
    jp, jstate = jparams, jinit(jparams)
    params = convert.from_jax(jparams, device="cpu")
    opt = init(params)
    jbatch = (jnp.asarray(x), jnp.asarray(y))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for _ in range(3):
        jp, jstate, jm = jstep(jp, jstate, jbatch)
        params, opt, m = step(params, opt, batch)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 abs=RTOL)
    for layer, jlayer in zip(params, jp):
        for k in ("w", "b"):
            _close(layer[k], jlayer[k])


def test_profile_train_step_takes_the_list_tree(setup):
    jparams, x, y = setup
    params = convert.from_jax(jparams, device="cpu")
    opt_fn = lambda ps: torch.optim.SGD(ps, lr=0.1)   # noqa: E731
    init, _ = make_train_step(tmlp.mlp_loss, opt_fn)
    opt = init(params)
    before = [t.detach().clone() for t in param_leaves(params)]
    bd = profile_train_step(tmlp.mlp_loss, opt_fn, params, opt,
                            (torch.from_numpy(x), torch.from_numpy(y)),
                            steps=2, warmup=1, emit=False)
    assert sum(bd.phases.values()) == pytest.approx(bd.step_time_s,
                                                    rel=1e-9)
    for a, b in zip(param_leaves(params), before):
        assert torch.equal(a.detach(), b)


def test_init_tree_and_convert_round_trip(setup):
    jparams, _, _ = setup
    cfg = tmlp.MLPConfig(in_dim=20, hidden=32, n_hidden=2, out_dim=5)
    params = tmlp.mlp_init(cfg, seed=1, device="cpu")
    assert [{k: tuple(v.shape) for k, v in p.items()} for p in params] == \
        [{k: tuple(v.shape) for k, v in p.items()} for p in jparams]
    assert all(not p["b"].any() for p in params)
    back = convert.to_numpy(convert.from_jax(jparams, device="cpu"))
    assert isinstance(back, list)
    for got, want in zip(back, jparams):
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmlp.mlp_init(cfg)


def test_models_exports_match_the_jax_package():
    """What ``ray_tpu.models`` exports, less what needs the mesh."""
    import ray_tpu.models as jmodels
    import ray_tpu_torch.models as tmodels
    assert set(tmodels.__all__) == set(jmodels.__all__) - {"param_specs"}
    for name in ("MLPConfig", "mlp_init", "mlp_apply"):
        assert name in ray_tpu_torch.__all__
        assert getattr(ray_tpu_torch, name) is getattr(tmodels, name)
