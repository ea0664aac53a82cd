"""The port's sharded training on a device mesh against the JAX package's,
on the CPU: ``TorchTrainer`` runs 2 or 4 worker processes of the port's
cluster runtime, joined by gloo, each rank training tiny Llama on its
shards (``shard_params`` by ``param_specs``); the JAX step runs the same
``MeshSpec`` over as many of its 8 virtual CPU devices. Both start from
the same parameters (made by the JAX package, carried over with
``convert``) and the same tokens (a numpy seed).

Per mesh (dp 2, fsdp 2, tp 2, dp 2 x fsdp 2, fsdp 2 x tp 2): one step's
loss (rel 2e-4, the limit of tests/test_multihost_train.py) and every
gradient leaf gathered from the ranks (1e-5 of its largest value), then
three chained steps of SGD (losses, gradient norms and the parameters
after them, to the same limits) and of AdamW (losses; the gradient norm of
the first step: chained Adam steps drift with the fp32 sum order, see
tests/test_torch_train.py). tests/test_torch_sharded_optim.py uses the
helpers here for the prefetching fsdp step and the sharded Adafactor.
"""

import functools

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import convert, train
from ray_tpu_torch.parallel.mesh import MeshSpec

LOSS_RTOL = 2e-4
GRAD_RTOL = 1e-5
BATCH = (8, 32)
MESHES = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2), "tp2": dict(tp=2),
          "dp2_fsdp2": dict(dp=2, fsdp=2), "fsdp2_tp2": dict(fsdp=2, tp=2)}


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 4,
    })
    yield rt
    rt.shutdown()


def _make_loop():
    """The rank program, by value (worker processes cannot import this
    module): one step's loss and gathered gradients, then chained steps
    of each optimizer named in the config, every rank reporting."""
    def loop(cfg):
        import functools

        import torch
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.train.optim import Adafactor
        from ray_tpu_torch.train.train_step import (local_shard,
                                                    param_leaves,
                                                    reduce_gradients)

        torch.set_num_threads(1)
        mesh = train.get_context().global_mesh()
        tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32,
                                   **cfg["model"])
        specs = tl.param_specs(tcfg)
        tokens = train.shard_batch(torch.tensor(cfg["tokens"]), mesh)

        def fresh():
            tree = {k: ({n: torch.tensor(a) for n, a in v.items()}
                        if isinstance(v, dict) else torch.tensor(v))
                    for k, v in cfg["params"].items()}
            return train.shard_params(tree, mesh, specs)

        def full(tree):
            return [t.full_tensor().numpy() for t in param_leaves(tree)]

        out = {}
        if cfg.get("grads"):
            params = fresh()
            local = {k: ({n: local_shard(t) for n, t in v.items()}
                         if isinstance(v, dict) else local_shard(v))
                     for k, v in params.items()}
            leaves = param_leaves(local)
            for t in leaves:
                t.requires_grad_(True)
            loss = tl.loss_fn(local, tokens, tcfg, mesh=mesh)
            loss.backward()
            reduce_gradients(leaves)
            out["loss"] = loss.item()
            out["grads"] = [DTensor.from_local(
                t.grad, mesh, t.shard_info.placements,
                run_check=False).full_tensor().numpy() for t in leaves]
        optimizers = {
            "sgd": lambda ps: torch.optim.SGD(ps, lr=1e-2),
            "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-3,
                                                  weight_decay=1e-4),
            "adafactor": lambda ps: Adafactor(ps, lr=1e-3)}
        for name in cfg.get("optimizers", ()):
            params = fresh()
            init_fn, step_fn = train.make_train_step(
                functools.partial(tl.loss_fn, cfg=tcfg, mesh=mesh),
                optimizers[name])
            opt = init_fn(params)
            hist = []
            for _ in range(3):
                params, opt, m = step_fn(params, opt, tokens)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            out[name] = {"metrics": hist, "params": full(params)}
        train.report(out)
    return loop


def _fit(spec, cfg, path):
    result = train.TorchTrainer(
        _make_loop(), train_loop_config=cfg,
        scaling_config=train.ScalingConfig(num_workers=MeshSpec(**spec).size,
                                           mesh=MeshSpec(**spec)),
        run_config=train.RunConfig(storage_path=str(path))).fit()
    return result.metrics


# ------------------------------------------------------------ the JAX side


def _jax_setup(model=None):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32, **(model or {}))
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, BATCH).astype(np.int32)
    return jcfg, params, tokens


def _jax_mesh(spec):
    import jax

    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    size = MeshSpec(**spec).size
    return build_mesh(JMeshSpec(**spec), devices=jax.devices()[:size])


def _jax_run(spec, jcfg, params, tokens, optimizers=()):
    """JAX's loss and gradients on the mesh, then three chained steps of
    each optimizer: {"loss", "grads", name: {"metrics", "params"}}."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.models import llama as jl
    from ray_tpu.train.train_step import make_train_step, shard_params
    mesh = _jax_mesh(spec)
    loss = functools.partial(jl.loss_fn, cfg=jcfg, mesh=mesh)
    with mesh:
        sharded = shard_params(params, mesh, jl.param_specs(jcfg))
        batch = jax.device_put(jnp.asarray(tokens),
                               NamedSharding(mesh, JP(("dp", "fsdp"))))
        value, grads = jax.jit(jax.value_and_grad(loss))(sharded, batch)
        out = {"loss": float(value),
               "grads": [np.asarray(g) for g in jax.tree.leaves(grads)]}
        for name in optimizers:
            opt = {"sgd": optax.sgd(1e-2), "adamw": optax.adamw(1e-3),
                   "adafactor": optax.adafactor(1e-3)}[name]
            init_fn, step_fn = make_train_step(loss, opt, donate=False)
            p = shard_params(params, mesh, jl.param_specs(jcfg))
            state = init_fn(p)
            hist = []
            for _ in range(3):
                p, state, m = step_fn(p, state, batch)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            out[name] = {"metrics": hist,
                         "params": [np.asarray(x) for x in
                                    jax.tree.leaves(p)]}
    return out


def _close(got, want, rtol=GRAD_RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * np.abs(w).max() + 1e-7)


def _port_cfg(params, tokens, model=None, **kw):
    return {"params": convert.to_numpy(convert.from_jax(params, "cpu")),
            "tokens": tokens.astype(np.int64), "model": model or {}, **kw}


#: flash attention per shard (the plain versions on the CPU; JAX's
#: blockwise scan there) under selective remat
STEP_MODEL = {"attention": "flash", "remat_policy": "selective"}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_matches_jax(cluster, tmp_path, mesh):
    spec = MESHES[mesh]
    jcfg, params, tokens = _jax_setup(STEP_MODEL)
    want = _jax_run(spec, jcfg, params, tokens, ("sgd", "adamw"))
    got = _fit(spec, _port_cfg(params, tokens, STEP_MODEL, grads=True,
                               optimizers=("sgd", "adamw")), tmp_path)
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    _close(got["grads"], want["grads"])
    for name in ("sgd", "adamw"):
        (l, n), (jl_, jn) = got[name]["metrics"][0], want[name]["metrics"][0]
        assert n == pytest.approx(jn, rel=GRAD_RTOL), name
        for (l, n), (jl_, jn) in zip(got[name]["metrics"],
                                     want[name]["metrics"]):
            assert l == pytest.approx(jl_, rel=LOSS_RTOL), name
    # SGD's chained steps stay within the gradients' limit
    for (_, n), (_, jn) in zip(got["sgd"]["metrics"], want["sgd"]["metrics"]):
        assert n == pytest.approx(jn, rel=GRAD_RTOL)
    _close(got["sgd"]["params"], want["sgd"]["params"])
