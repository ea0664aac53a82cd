"""Sharded checkpoints of the port, in the JAX package's format.

- The commit protocol cases of tests/test_checkpoint_chaos.py
  (``TestCommitProtocol``, ``TestAsyncWriter``), run on each package's
  ``CheckpointManager``: only committed checkpoints are visible, debris is
  collected, prunes wait for a newer commit, a corrupt shard falls back,
  the async writer's errors surface.
- Across packages and world sizes: a checkpoint the JAX package writes on
  its 8-device fsdp mesh restores into the port's DTensors on 2 gloo
  ranks (fsdp 2), and one the port writes from 2 ranks (each rank its
  own shard file) restores into the JAX package on its 8-device mesh.
  The values come back equal, and the next step's loss agrees (rel 2e-4,
  the limit of tests/test_multihost_train.py).
"""

import functools
import importlib
import os

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import convert, train
from ray_tpu_torch.parallel.mesh import MeshSpec

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
LOSS_RTOL = 2e-4


@pytest.fixture(params=PACKAGES)
def ckpt(request):
    """(the package's checkpoint module, its fault injector), the
    injector reset after the test."""
    fi = importlib.import_module(f"{request.param}.util.fault_injector")
    yield importlib.import_module(f"{request.param}.train.checkpoint"), fi
    fi.reset()
    os.environ.pop(fi.ENV_VAR, None)


# ------------------------------------------------------- commit protocol


def test_latest_skips_manifestless_dirs(ckpt, tmp_path):
    cm, _ = ckpt
    mgr = cm.CheckpointManager(str(tmp_path))
    mgr.save({"x": np.array([1])}, 1)
    half = str(tmp_path / "checkpoint_00000002")
    os.makedirs(half)
    open(os.path.join(half, "shard-00000.npz"), "wb").write(b"partial")
    latest = cm.CheckpointManager(str(tmp_path), rank=1).latest()
    assert latest is not None
    assert latest.path.endswith("checkpoint_00000001")


def test_gc_debris_at_init(ckpt, tmp_path):
    cm, _ = ckpt
    os.makedirs(tmp_path / "tmpabc123")
    os.makedirs(tmp_path / ".removing.checkpoint_00000009.1234")
    open(tmp_path / "arrays.npz.tmp.999", "wb").close()
    half = tmp_path / "checkpoint_00000005"
    os.makedirs(half)
    open(half / "shard-00000.npz", "wb").close()
    mgr = cm.CheckpointManager(str(tmp_path))
    mgr.save({"x": np.array([1])}, 7)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_00000007"]


def test_prune_only_removes_older_than_newest_commit(ckpt, tmp_path):
    cm, _ = ckpt
    mgr = cm.CheckpointManager(str(tmp_path), num_to_keep=1)
    mgr.save({"x": np.array([1])}, 1)
    os.makedirs(tmp_path / "checkpoint_00000002")  # "in flight"
    mgr._prune()
    assert mgr.fs.exists(
        str(tmp_path / "checkpoint_00000001" / cm.MANIFEST_FILE))
    (tmp_path / "checkpoint_00000002").rmdir()
    mgr.save({"x": np.array([2])}, 2)
    mgr.flush()
    assert [d for d in sorted(os.listdir(tmp_path))
            if d.startswith("checkpoint_")] == ["checkpoint_00000002"]


def test_resave_committed_step_drops_manifest_first(ckpt, tmp_path):
    cm, fi = ckpt
    mgr = cm.CheckpointManager(str(tmp_path))
    mgr.save({"x": np.array([1])}, 1)
    fi.configure("checkpoint.shard_write=raise")
    with pytest.raises(RuntimeError):
        mgr.save({"x": np.array([2])}, 1)
    assert cm.CheckpointManager(str(tmp_path), rank=1).latest() is None


def test_corrupt_falls_back_to_previous_committed(ckpt, tmp_path):
    cm, _ = ckpt
    mgr = cm.CheckpointManager(str(tmp_path))
    mgr.save({"x": np.array([1])}, 1)
    mgr.save({"x": np.array([2])}, 2)
    with open(os.path.join(mgr.latest().path, "shard-00000.npz"),
              "wb") as f:
        f.write(b"bitrot")
    assert int(mgr.latest().load()["x"][0]) == 1


def test_corrupt_without_fallback_raises_typed(ckpt, tmp_path):
    cm, _ = ckpt
    ck = cm.CheckpointManager(str(tmp_path)).save({"x": np.array([1])}, 1)
    with open(os.path.join(ck.path, "shard-00000.npz"), "wb") as f:
        f.write(b"bitrot")
    with pytest.raises(cm.CheckpointCorrupt):
        cm.Checkpoint(ck.path).load()


def test_async_saves_commit_on_flush(ckpt, tmp_path):
    cm, _ = ckpt
    mgr = cm.CheckpointManager(str(tmp_path), num_to_keep=2,
                               async_save=True)
    for step in (1, 2, 3):
        mgr.save_async({"x": np.array([step])}, step)
    mgr.flush()
    assert not mgr.in_flight()
    assert int(mgr.latest().load()["x"][0]) == 3
    assert [d for d in sorted(os.listdir(tmp_path))
            if d.startswith("checkpoint_")] == ["checkpoint_00000002",
                                                 "checkpoint_00000003"]


def test_writer_error_surfaces_on_next_save(ckpt, tmp_path):
    cm, fi = ckpt
    mgr = cm.CheckpointManager(str(tmp_path), async_save=True)
    fi.configure("checkpoint.shard_write=raise")
    mgr.save_async({"x": np.array([1])}, 1)
    mgr.flush(raise_errors=False)
    fi.reset()
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        mgr.save_async({"x": np.array([2])}, 2)
    mgr.save_async({"x": np.array([3])}, 3)
    mgr.flush()
    assert int(mgr.latest().load()["x"][0]) == 3


def test_writer_error_surfaces_at_flush(ckpt, tmp_path):
    cm, fi = ckpt
    mgr = cm.CheckpointManager(str(tmp_path), async_save=True)
    fi.configure("checkpoint.manifest_write=raise")
    mgr.save_async({"x": np.array([1])}, 1)
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        mgr.flush()
    assert mgr.latest() is None


def test_torch_leaves_round_trip(tmp_path):
    """Tensors come back as numpy arrays, or, given a target, as tensors
    of the target's dtype (bf16 is stored widened to fp32)."""
    import torch
    from ray_tpu_torch.train.checkpoint import Checkpoint
    tree = {"w": torch.arange(6.).reshape(2, 3),
            "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            "opt": {"state": {0: {"step": torch.tensor(3.0)}},
                    "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.99),
                                      "params": [0]}]}}
    ck = Checkpoint.save(tree, str(tmp_path / "checkpoint_00000001"))
    host = ck.load()
    assert host["w"].dtype == np.float32 and host["h"].dtype == np.float32
    back = ck.load(target=tree)
    assert torch.equal(back["w"], tree["w"])
    assert back["h"].dtype == torch.bfloat16
    assert torch.equal(back["h"], tree["h"])
    assert back["opt"]["state"][0]["step"].item() == 3.0
    assert back["opt"]["param_groups"] == tree["opt"]["param_groups"]


# ------------------------------------------- across packages and meshes


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 2,
    })
    yield rt
    rt.shutdown()


def _make_loop():
    """The port's side on 2 ranks (fsdp 2): restore a checkpoint into its
    sharded parameters (``restore``), or train one SGD step and
    checkpoint (``save``); then report the gathered parameters and the
    loss of the next step on ``tokens``."""
    def loop(cfg):
        import functools

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.train.checkpoint import Checkpoint, gather_to_host
        from ray_tpu_torch.train.train_step import param_leaves

        torch.set_num_threads(1)
        mesh = train.get_context().global_mesh()
        mcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
        tree = {k: ({n: torch.tensor(a) for n, a in v.items()}
                    if isinstance(v, dict) else torch.tensor(v))
                for k, v in cfg["params"].items()}
        params = train.shard_params(tree, mesh, tl.param_specs(mcfg))
        tokens = train.shard_batch(torch.tensor(cfg["tokens"]), mesh)
        loss = functools.partial(tl.loss_fn, cfg=mcfg, mesh=mesh)
        if cfg["mode"] == "restore":
            params = Checkpoint(cfg["path"]).load(
                target={"params": params})["params"]
            init_fn, step_fn = train.make_train_step(
                loss, functools.partial(torch.optim.SGD, lr=1e-2))
        else:
            init_fn, step_fn = train.make_train_step(
                loss, functools.partial(torch.optim.SGD, lr=1e-2))
            opt = init_fn(params)
            params, opt, _ = step_fn(params, opt, tokens)
            train.report({}, checkpoint_tree={"params": params})
        values = [t.numpy() for t in param_leaves(gather_to_host(params))]
        with torch.no_grad():
            next_loss = loss(params, tokens).item()
        train.report({"values": values, "next_loss": next_loss})
    return loop


def _port_fit(cfg, path):
    return train.TorchTrainer(
        _make_loop(), train_loop_config=cfg,
        scaling_config=train.ScalingConfig(num_workers=2,
                                           mesh=MeshSpec(fsdp=-1)),
        run_config=train.RunConfig(name="x", storage_path=str(path))).fit()


def _jax_side():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    cfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    mesh = build_mesh(JMeshSpec(fsdp=-1))      # the 8 virtual devices
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    batch = jax.device_put(jnp.asarray(tokens),
                           NamedSharding(mesh, JP(("dp", "fsdp"))))
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s),
                             jl.param_specs(cfg),
                             is_leaf=lambda x: isinstance(x, JP))
    loss = jax.jit(functools.partial(jl.loss_fn, cfg=cfg, mesh=mesh))
    return cfg, mesh, params, tokens, batch, shardings, loss


def test_jax_checkpoint_restores_into_the_port(cluster, tmp_path):
    import jax
    import optax

    from ray_tpu.train.checkpoint import CheckpointManager
    from ray_tpu.train.train_step import make_train_step
    cfg, mesh, params, tokens, batch, shardings, loss = _jax_side()
    with mesh:
        p = jax.device_put(params, shardings)
        init_fn, step_fn = make_train_step(
            lambda q, b: loss(q, b), optax.sgd(1e-2), donate=False)
        p, _, _ = step_fn(p, init_fn(p), batch)
        ck = CheckpointManager(str(tmp_path / "jax")).save({"params": p}, 1)
        want_loss = float(loss(p, batch))
    got = _port_fit({"mode": "restore", "path": ck.path,
                     "params": convert.to_numpy(convert.from_jax(
                         params, "cpu")),
                     "tokens": tokens.astype(np.int64)}, tmp_path / "port")
    want = [np.asarray(x) for x in jax.tree.leaves(p)]
    assert len(got.metrics["values"]) == len(want)
    for a, b in zip(got.metrics["values"], want):
        np.testing.assert_array_equal(a, b)
    assert got.metrics["next_loss"] == pytest.approx(want_loss,
                                                     rel=LOSS_RTOL)


def test_port_checkpoint_restores_into_jax(cluster, tmp_path):
    import jax

    from ray_tpu.train.checkpoint import Checkpoint
    cfg, mesh, params, tokens, batch, shardings, loss = _jax_side()
    result = _port_fit({"mode": "save",
                        "params": convert.to_numpy(convert.from_jax(
                            params, "cpu")),
                        "tokens": tokens.astype(np.int64)},
                       tmp_path / "port")
    path = result.checkpoint.path
    assert sorted(f for f in os.listdir(path) if f.endswith(".npz")) == [
        "shard-00000.npz", "shard-00001.npz"]     # one file per rank
    with mesh:
        restored = Checkpoint(path).load(
            shardings={"params": shardings})["params"]
        got_loss = float(loss(restored, batch))
    for a, b in zip(jax.tree.leaves(restored), result.metrics["values"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert got_loss == pytest.approx(result.metrics["next_loss"],
                                     rel=LOSS_RTOL)
