"""``TorchTrainer`` over worker processes of the port's cluster runtime,
joined by gloo: the programs of tests/test_multihost_train.py on the port.

- 2 ranks on an fsdp mesh train tiny Llama to the loss of 1 rank (rel
  2e-4, the JAX test's limit): the same parameters (one seed, then each
  rank keeps its shards) and batches;
- elastic shrink: 4 workers on a dp mesh, rank 1 exits at step 3, the
  group restarts at 3 ranks from the last committed checkpoint (the
  replicated parameters restored onto the new mesh) and the loss keeps
  falling;
- the fill-axis rule and the policy's sizing;
- ``use_gpu`` on a worker that finds no card raises (no fallback to the
  CPU), and the default (None) leases a card whenever the cluster has
  one; the CPU runs here say ``use_gpu=False``;
- ``shard_params``/``shard_batch`` refuse a leaf on another device type
  than the mesh's.
"""

import gc
import json
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.parallel.mesh import MeshSpec


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, num_gpus=1, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 4,
    })
    yield rt
    rt.shutdown()


def _make_loop():
    def loop(cfg):
        import functools

        import numpy as np
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl

        torch.set_num_threads(1)
        ctx = train.get_context()
        mesh = ctx.global_mesh()
        assert mesh.size() == cfg["world"] == ctx.get_world_size()
        assert torch.distributed.get_backend() == "gloo"
        mcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
        params = train.shard_params(tl.init_params(mcfg, 11, device="cpu"),
                                    mesh, tl.param_specs(mcfg))
        init_fn, step_fn = train.make_train_step(
            functools.partial(tl.loss_fn, cfg=mcfg, mesh=mesh),
            functools.partial(torch.optim.SGD, lr=1e-2))
        opt = init_fn(params)
        rng = np.random.default_rng(11)
        for _ in range(3):
            batch = torch.tensor(rng.integers(0, mcfg.vocab_size, (8, 32)))
            params, opt, metrics = step_fn(params, opt,
                                           train.shard_batch(batch, mesh))
        train.report({"loss": float(metrics["loss"])})
    return loop


def _fit(num_workers, name, path):
    return train.TorchTrainer(
        _make_loop(), train_loop_config={"world": num_workers},
        scaling_config=train.ScalingConfig(num_workers=num_workers,
                                           mesh=MeshSpec(fsdp=-1),
                                           use_gpu=False),
        run_config=train.RunConfig(name=name, storage_path=str(path))).fit()


def test_two_rank_mesh_matches_single(cluster, tmp_path):
    multi = _fit(2, "mh2", tmp_path)
    single = _fit(1, "mh1", tmp_path)
    assert multi.metrics["loss"] == pytest.approx(
        single.metrics["loss"], rel=2e-4), (multi.metrics, single.metrics)


def _make_elastic_loop():
    """Fixed batch (one row tiled over dp: the mean loss compares across
    world sizes and falls under SGD), a checkpoint every step, rank 1
    exits once, after the kill step's checkpoint is committed."""
    def loop(cfg):
        import functools
        import os
        import time

        import numpy as np
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.parallel.mesh import P

        torch.set_num_threads(1)
        ctx = train.get_context()
        mesh = ctx.global_mesh()
        n_dp = mesh.size(1)
        mcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
        host = tl.init_params(mcfg, 7, device="cpu")
        specs = {k: ({n: P() for n in v} if isinstance(v, dict) else P())
                 for k, v in host.items()}
        params = train.shard_params(host, mesh, specs)
        restored = ctx.get_checkpoint() is not None
        if restored:
            # the replicated leaves restored onto the new (smaller) mesh
            params = ctx.get_checkpoint().load(
                target={"params": params})["params"]
        init_fn, step_fn = train.make_train_step(
            functools.partial(tl.loss_fn, cfg=mcfg, mesh=mesh),
            functools.partial(torch.optim.SGD, lr=5e-2))
        opt = init_fn(params)
        row = np.random.default_rng(3).integers(0, mcfg.vocab_size, (1, 32))
        batch = train.shard_batch(torch.tensor(np.tile(row, (n_dp, 1))),
                                  mesh, spec=P("dp"))
        while ctx.step < cfg["total_steps"]:
            if (ctx.get_rank() == 1 and ctx.step == cfg["kill_at"]
                    and not os.path.exists(cfg["marker"])):
                # exit once rank 0 has committed this step's checkpoint
                # (it commits after every rank's shard arrived): the
                # restart then starts from it, not from a race with it
                latest = ctx.ckpt_manager.latest
                deadline = time.monotonic() + 60
                while (latest() is None or not latest().path.endswith(
                        f"_{ctx.step:08d}")) and time.monotonic() < deadline:
                    time.sleep(0.05)
                open(cfg["marker"], "w").close()
                os._exit(1)
            params, opt, metrics = step_fn(params, opt, batch)
            train.report({"loss": float(metrics["loss"]),
                          "world_size": ctx.get_world_size(),
                          "restored": restored},
                         checkpoint_tree={"params": params})
    return loop


def test_elastic_shrink_on_worker_loss(cluster, tmp_path):
    marker = str(tmp_path / "killed-once")
    kill_at = 3
    deadline = time.monotonic() + 30
    while rt.available_resources().get("CPU", 0) < 4 and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    result = train.TorchTrainer(
        _make_elastic_loop(),
        train_loop_config={"total_steps": 6, "kill_at": kill_at,
                           "marker": marker},
        scaling_config=train.ScalingConfig(
            num_workers=4, min_workers=2, grow_poll_s=0.5,
            grow_cooldown_s=120.0, mesh=MeshSpec(dp=-1), use_gpu=False),
        run_config=train.RunConfig(
            name="elastic1", storage_path=str(tmp_path),
            failure_config=train.FailureConfig(max_failures=2))).fit()
    assert result.error is None, result.error
    history = result.metrics_history
    assert history[0]["_step"] == kill_at + 1, history[0]
    assert history[0]["restored"] is True
    assert result.metrics["world_size"] == 3
    assert history[-1]["_step"] == 6
    killed = json.load(open(train.CheckpointManager(result.path).dir_for(
        kill_at) + "/metrics.json"))
    assert history[0]["loss"] < killed["loss"], (history[0], killed)


def test_elastic_requires_fill_axis(cluster, tmp_path):
    trainer = train.TorchTrainer(
        _make_elastic_loop(), train_loop_config={},
        scaling_config=train.ScalingConfig(
            num_workers=2, min_workers=1, mesh=MeshSpec(fsdp=2),
            use_gpu=False),
        run_config=train.RunConfig(name="elastic-bad",
                                   storage_path=str(tmp_path)))
    with pytest.raises(ValueError, match="fill"):
        trainer.fit()


def _dataset_loop(pkg):
    """tests/test_data.py's rank program for ``pkg``: this rank's dataset
    shard in batches of 4, its rows and their sum reported."""
    def loop(cfg):
        import importlib
        train = importlib.import_module(f"{pkg}.train")
        ctx = train.get_context()
        total = n = 0
        for batch in train.get_dataset_shard("train").iter_batches(
                batch_size=4):
            total += int(batch["id"].sum())
            n += len(batch["id"])
        train.report({"rows": n, "sum": total, "rank": ctx.get_rank()})
    return loop


def test_trainer_with_dataset_shards_matches_jax(cluster, tmp_path):
    """tests/test_data.py's ``test_trainer_with_dataset_shards``: two
    workers each read a disjoint half of a 24-row dataset in 6 blocks
    (``datasets=``). The JAX program runs in the JAX package's local
    mode, as its test does; the port's local mode takes one rank, so its
    program runs on this cluster (two worker processes over gloo). Rank
    0's report must be the same in both."""
    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu import train as jtrain
    from ray_tpu_torch import data as tdata
    ray_tpu.init(local_mode=True, num_cpus=4)
    # the JAX local-mode store's plain lock deadlocks when the cyclic
    # collector frees an ObjectRef inside it (tests/test_data.py's
    # program hung so): no collection while the JAX program runs
    gc.disable()
    try:
        want = jtrain.JaxTrainer(
            _dataset_loop("ray_tpu"), train_loop_config={},
            scaling_config=jtrain.ScalingConfig(num_workers=2),
            run_config=jtrain.RunConfig(storage_path=str(tmp_path / "j")),
            datasets={"train": jdata.range(24, num_blocks=6)}).fit().metrics
    finally:
        ray_tpu.shutdown()
        gc.enable()
        gc.collect()
    got = train.TorchTrainer(
        _dataset_loop("ray_tpu_torch"), train_loop_config={},
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False),
        run_config=train.RunConfig(storage_path=str(tmp_path / "t")),
        datasets={"train": tdata.range(24, num_blocks=6)}).fit().metrics
    assert want["rows"] == 12          # rank 0's disjoint half
    assert {k: got[k] for k in ("rows", "sum", "rank")} == \
        {k: want[k] for k in ("rows", "sum", "rank")}


def test_elastic_policy_sizing():
    from ray_tpu_torch.train.scaling_policy import ElasticScalingPolicy
    pol = ElasticScalingPolicy(2, 8, {"CPU": 2.0})
    assert pol.initial_size(lambda: {"CPU": 16.0}) == 8
    assert pol.initial_size(lambda: {"CPU": 9.0}) == 4
    assert pol.initial_size(lambda: {"CPU": 1.0}) == 2   # floor
    assert pol.after_failure(5, None) == 4
    assert pol.after_failure(2, None) == 2               # never below min


@pytest.mark.parametrize("use_gpu", [True, None])
def test_use_gpu_without_a_card_raises(cluster, tmp_path, use_gpu):
    """The lease gives the worker card "0", but torch finds no CUDA here:
    setup raises before the loop, and the run fails. The default
    (``use_gpu=None``) leases a card too, since this cluster has one."""
    def loop():
        pass

    trainer = train.TorchTrainer(
        loop, scaling_config=train.ScalingConfig(num_workers=1,
                                                 use_gpu=use_gpu),
        run_config=train.RunConfig(name="nogpu", storage_path=str(tmp_path)))
    with pytest.raises(train.TrainingFailedError, match="finds no card"):
        trainer.fit()


def test_use_gpu_defaults_to_the_clusters_cards():
    sc = train.ScalingConfig(num_workers=2)
    assert sc.use_gpu is None
    assert sc.resolve({"CPU": 8.0, "GPU": 1.0}).use_gpu is True
    assert sc.resolve({"CPU": 8.0}).use_gpu is False
    assert sc.resolve({"CPU": 8.0, "GPU": 0.0}).use_gpu is False
    off = train.ScalingConfig(use_gpu=False)
    assert off.resolve({"GPU": 4.0}) is off
    assert off.resolve({"GPU": 4.0}).worker_resources() == {"CPU": 1.0}
    assert sc.resolve({"GPU": 1.0}).worker_resources() == {"CPU": 1.0,
                                                           "GPU": 1.0}


def test_a_reused_process_joins_a_new_group():
    """A worker process that runs a second group (a restart, another run)
    must first leave the first: ``setup_torch_worker`` destroys a group
    it finds, and ``teardown_torch_worker`` clears the meshes built over
    it."""
    import socket

    import torch.distributed as dist

    from ray_tpu_torch.train.backend import (global_mesh, setup_torch_worker,
                                             teardown_torch_worker)
    meshes = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        setup_torch_worker({"coordinator": f"127.0.0.1:{port}",
                            "world_size": 1, "rank": 0})
        meshes.append(global_mesh(MeshSpec(fsdp=-1)))
        assert dist.get_backend() == "gloo" and meshes[-1].size() == 1
    assert meshes[0] is not meshes[1]
    teardown_torch_worker()
    assert not dist.is_initialized()


def test_leaves_on_another_device_type_are_refused():
    """A leaf on another device than the mesh's would be copied there by
    ``distribute_tensor`` (a loop building CUDA leaves on a CPU mesh would
    train on the host): ``shard_params`` and ``shard_batch`` raise. The
    "meta" device stands in for the card here."""
    import socket

    import torch

    from ray_tpu_torch.parallel.mesh import P
    from ray_tpu_torch.train.backend import (global_mesh, setup_torch_worker,
                                             teardown_torch_worker)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    setup_torch_worker({"coordinator": f"127.0.0.1:{port}",
                        "world_size": 1, "rank": 0})
    try:
        mesh = global_mesh(MeshSpec(fsdp=-1))
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError, match="meta tensor on a cpu mesh"):
            train.shard_params({"w": torch.zeros(4, 4, device="meta")},
                               mesh, {"w": P("fsdp", None)})
        with pytest.raises(ValueError, match="meta tensor on a cpu mesh"):
            train.shard_batch(torch.zeros(4, 8, dtype=torch.long,
                                          device="meta"), mesh)
        ok = train.shard_params({"w": torch.ones(4, 4)}, mesh,
                                {"w": P("fsdp", None)})
        assert ok["w"].to_local().device.type == "cpu"
    finally:
        teardown_torch_worker()
