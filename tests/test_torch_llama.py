"""PyTorch port of the Llama model against the JAX package, on the CPU.

Parameters are made by the JAX package from a PRNG key and carried to
the port with ``ray_tpu_torch.convert``; token ids and activations come
from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl

# tiny shapes: one intra-op thread, leaving the cores to the tests
# that run beside these ones
torch.set_num_threads(1)

# fp32 on both sides: the two differ only in summation order
ATOL = 1e-4


def _configs(**kw):
    return (jl.LlamaConfig.tiny(dtype=jnp.float32, **kw),
            tl.LlamaConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _configs()
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, tcfg, jparams, convert.from_jax(jparams, device="cpu")


def test_forward_logits_match_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    want = np.asarray(jl.forward(jparams, jnp.asarray(tokens), jcfg))
    got = tl.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_forward_gqa_and_mha_match_jax():
    for kv_heads in (8, 2, 1):
        jcfg, tcfg = _configs(n_layers=2, n_kv_heads=kv_heads)
        jparams = jl.init_params(jcfg, jax.random.PRNGKey(kv_heads))
        tokens = np.random.default_rng(kv_heads).integers(
            0, jcfg.vocab_size, (1, 9))
        want = np.asarray(jl.forward(jparams, jnp.asarray(tokens), jcfg))
        got = tl.forward(convert.from_jax(jparams, device="cpu"),
                         torch.from_numpy(tokens), tcfg).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3
    w = rng.standard_normal(64, np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl._rmsnorm(jnp.asarray(x, jd), jnp.asarray(w), 1e-5)
    got = tl._rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(w), 1e-5)
    assert got.dtype == td
    # same cast order (fp32 stats, cast back, then times w in x's dtype):
    # bf16 agrees to one rounding step, fp32 to summation order
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("positions_shape", ["[L]", "[B,L]", "[T]"])
def test_rope_matches_jax(positions_shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16), np.float32)
    if positions_shape == "[L]":
        pos = np.arange(7)
    elif positions_shape == "[B,L]":
        pos = rng.integers(0, 500, (2, 7))
    else:   # the ragged step: [1, T, H, D] with absolute positions [T]
        x, pos = x[:1], rng.integers(0, 500, 7)
    want = np.asarray(jl._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_convert_round_trip(tiny):
    jcfg, _, jparams, tparams = tiny
    back = convert.to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # the same tree and shapes as the port's own init
    own = tl.init_params(tl.LlamaConfig.tiny(), seed=0, device="cpu")
    assert jax.tree.map(np.shape, back) == \
        jax.tree.map(lambda t: tuple(t.shape), own)
    # bf16 survives exactly (as float32 on the numpy side)
    b16 = {"w": jnp.asarray(np.asarray(jparams["embed"]), jnp.bfloat16)}
    t16 = convert.from_jax(b16, device="cpu")["w"]
    assert t16.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.to_numpy({"w": t16})["w"],
                                  np.asarray(b16["w"].astype(jnp.float32)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            convert.from_jax(b16)            # the default device is cuda


def test_num_params_matches_jax_and_tree():
    for preset in ("tiny", "llama3_8b"):
        jcfg = getattr(jl.LlamaConfig, preset)()
        tcfg = getattr(tl.LlamaConfig, preset)()
        assert tl.num_params(tcfg) == jl.num_params(jcfg)
    tcfg = tl.LlamaConfig.tiny()
    params = tl.init_params(tcfg, seed=1, device="cpu")
    n = sum(t.numel() for t in jax.tree.leaves(
        params, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    assert n == tl.num_params(tcfg)
    # Llama-3-8B widths with the tied embedding both packages use
    assert tl.num_params(tl.LlamaConfig.llama3_8b()) == 7_504_924_672


def test_init_params_seeded_and_device_checked():
    cfg = tl.LlamaConfig.tiny(param_dtype=torch.bfloat16)
    a = tl.init_params(cfg, seed=5, device="cpu")
    b = tl.init_params(cfg, seed=5, device="cpu")
    assert a["layers"]["wq"].dtype == torch.bfloat16
    assert torch.equal(a["layers"]["w_up"], b["layers"]["w_up"])
    std = a["layers"]["wq"].float().std().item()
    assert abs(std - cfg.dim ** -0.5) < 0.1 * cfg.dim ** -0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tl.init_params(cfg, seed=5)      # the default device is cuda
