"""The optimizer state of a sharded run through a checkpoint, on the CPU:
``TorchTrainer`` runs 2 gloo ranks on fsdp 2, tiny Llama at widths whose
matrices Adafactor factors after sharding (``v_row``/``v_col``), with a
checkpoint of the parameters and ``opt.state_dict()`` at every step.

- Both ranks fail once after step 2; the run restarts from that
  checkpoint and its steps 3 and 4 must equal an uninterrupted run's
  (loss to rel 1e-6, the parameters to 1e-6 of their largest value):
  every rank must get back its own shard of every state tensor.
- The port's checkpoint after step 1 must hold the optimizer state of the
  whole leaves: equal to the state the JAX package's checkpoint holds
  after the same step on its fsdp 2 mesh (optax's ``FactoredState`` or
  ``ScaleByAdamState``), first moments to 1e-5 of their largest value,
  as the gradients (tests/test_torch_sharded_train.py), second moments
  to 2e-5 (a square doubles the gradients' relative error).
"""

import functools

import jax
import numpy as np
import optax
import pytest

from ray_tpu_torch import train
from ray_tpu_torch.parallel.mesh import MeshSpec
from test_torch_sharded_optim import FACTORED
from test_torch_sharded_train import (_jax_mesh, _jax_setup,  # noqa: F401
                                      _port_cfg, cluster)

SPEC = dict(fsdp=2)
STEPS = 4
FAIL_AFTER = 2
OPTIMIZERS = ("adafactor", "adamw")


def _make_loop():
    """The rank program, by value: ``cfg["steps"]`` steps of
    ``cfg["opt"]``, a checkpoint at each, a restore when the run
    restarts; with ``cfg["marker"]`` every rank raises once after step
    ``cfg["fail_after"]``. Reports each step's loss, and the gathered
    parameters at the end."""
    def loop(cfg):
        import functools
        import os

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.train.optim import Adafactor

        torch.set_num_threads(1)
        ctx = train.get_context()
        mesh = ctx.global_mesh()
        tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32,
                                   **cfg["model"])
        tree = {k: ({n: torch.tensor(a) for n, a in v.items()}
                    if isinstance(v, dict) else torch.tensor(v))
                for k, v in cfg["params"].items()}
        params = train.shard_params(tree, mesh, tl.param_specs(tcfg))
        tokens = train.shard_batch(torch.tensor(cfg["tokens"]), mesh)
        make = {"adafactor": functools.partial(Adafactor, lr=1e-3),
                "adamw": functools.partial(torch.optim.AdamW, lr=1e-3,
                                           weight_decay=1e-4)}[cfg["opt"]]
        init_fn, step_fn = train.make_train_step(
            functools.partial(tl.loss_fn, cfg=tcfg, mesh=mesh), make)
        opt = init_fn(params)
        if ctx.get_checkpoint() is not None:
            state = ctx.get_checkpoint().load(target={"params": params,
                                                      "opt": None})
            with torch.no_grad():
                for dst, src in zip(train.param_leaves(params),
                                    train.param_leaves(state["params"])):
                    dst.to_local().copy_(src.to_local())
            opt.load_state_dict(state["opt"])
        while ctx.step < cfg["steps"]:
            if cfg.get("marker") and ctx.step == cfg["fail_after"]:
                first = not os.path.exists(cfg["marker"])
                dist.barrier()
                if first:
                    # the marker is written before any rank raises: a rank
                    # that raised first could get rank 0 killed before it
                    # wrote it, and the retry would fail again
                    if ctx.rank == 0:
                        open(cfg["marker"], "w").close()
                    dist.barrier()
                    raise RuntimeError("planted failure")
            params, opt, m = step_fn(params, opt, tokens)
            train.report({"loss": float(m["loss"])},
                         checkpoint_tree={"params": params,
                                          "opt": opt.state_dict()})
        train.report({"values": [t.full_tensor().numpy() for t in
                                 train.param_leaves(params)]})
    return loop


def _fit(cfg, path, name):
    return train.TorchTrainer(
        _make_loop(), train_loop_config=cfg,
        scaling_config=train.ScalingConfig(num_workers=2,
                                           mesh=MeshSpec(**SPEC)),
        run_config=train.RunConfig(
            name=name, storage_path=str(path),
            failure_config=train.FailureConfig(max_failures=1))).fit()


def _losses(result):
    return {m["_step"]: m["loss"] for m in result.metrics_history
            if "loss" in m}


@pytest.fixture(scope="module")
def runs(cluster, tmp_path_factory):
    """Per optimizer: the uninterrupted run and the restarted one."""
    jcfg, params, tokens = _jax_setup(FACTORED)
    out = {}
    for name in OPTIMIZERS:
        path = tmp_path_factory.mktemp(name)
        cfg = {**_port_cfg(params, tokens, FACTORED), "opt": name,
               "steps": STEPS}
        whole = _fit(cfg, path, "whole")
        restarted = _fit({**cfg, "marker": str(path / "failed-once"),
                          "fail_after": FAIL_AFTER}, path, "restarted")
        out[name] = (whole, restarted)
    return jcfg, params, tokens, out


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_restart_restores_each_ranks_optimizer_state(runs, opt):
    whole, restarted = runs[3][opt]
    after = _losses(restarted)
    assert sorted(after) == list(range(FAIL_AFTER + 1, STEPS + 1)), after
    want = _losses(whole)
    for step, loss in after.items():
        assert loss == pytest.approx(want[step], rel=1e-6), step
    for a, b in zip(restarted.metrics["values"], whole.metrics["values"]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def _jax_state_after_one_step(jcfg, params, tokens, opt, path):
    """One step of ``opt`` on the JAX package's fsdp 2 mesh, checkpointed
    by its CheckpointManager and read back by its ``Checkpoint.load``:
    the optax state's moments, as lists of leaves."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from optax._src.factorized import FactoredState

    from ray_tpu.models import llama as jl
    from ray_tpu.train.checkpoint import Checkpoint, CheckpointManager
    from ray_tpu.train.train_step import make_train_step, shard_params
    mesh = _jax_mesh(SPEC)
    loss = functools.partial(jl.loss_fn, cfg=jcfg, mesh=mesh)
    tx = {"adafactor": optax.adafactor(1e-3),
          "adamw": optax.adamw(1e-3, weight_decay=1e-4)}[opt]
    with mesh:
        p = shard_params(params, mesh, jl.param_specs(jcfg))
        batch = jax.device_put(jnp.asarray(tokens),
                               NamedSharding(mesh, JP(("dp", "fsdp"))))
        init_fn, step_fn = make_train_step(loss, tx, donate=False)
        p, state, _ = step_fn(p, init_fn(p), batch)
        tree = {"params": p, "opt": state}
        ck = CheckpointManager(str(path)).save(tree, 1)
    back = Checkpoint(ck.path).load(target=tree)["opt"]
    kind = FactoredState if opt == "adafactor" else optax.ScaleByAdamState
    s = next(x for x in back if isinstance(x, kind))
    keys = ("v_row", "v_col", "v") if opt == "adafactor" else ("mu", "nu")
    moments = {k: [np.asarray(x) for x in jax.tree.leaves(getattr(s, k))]
               for k in keys}
    return moments, int(np.asarray(s.count))


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_sharded_optimizer_checkpoint_matches_jax(runs, opt, tmp_path):
    from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
    jcfg, params, tokens, out = runs
    whole = out[opt][0]
    path = CheckpointManager(whole.path).dir_for(1)
    mine = Checkpoint(path).load()["opt"]["state"]
    want, count = _jax_state_after_one_step(jcfg, params, tokens, opt,
                                            tmp_path)
    names = {"mu": "exp_avg", "nu": "exp_avg_sq"}
    first = ("mu",)
    n_leaves = len(jax.tree.leaves(params))
    assert sorted(mine) == list(range(n_leaves))
    for key, leaves in want.items():
        for i, w in enumerate(leaves):
            got = mine[i].get(names.get(key, key))
            if got is None:       # optax's (1,) placeholder of a slot
                assert opt == "adafactor" and w.shape == (1,), (key, i)
                continue
            assert got.shape == w.shape, (key, i)
            tol = 1e-5 if key in first else 2e-5
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=tol * np.abs(w).max())
        assert all(float(mine[i]["step"]) == count
                   for i in range(n_leaves))
