"""The RL learners' mesh path: PPO, IMPALA and BC through ``build(mesh=)``
over 2 gloo ranks, against the JAX learners on a mesh over 2 of the
conftest's 8 virtual CPU devices, in fp32.

``TorchTrainer`` runs 2 worker processes of the port's cluster runtime
joined by gloo (``MeshSpec(dp=2)``); each rank builds the algorithm with
``build(device="cpu", mesh=...)``, as a user's rank program would. The
JAX side shards the env axis over ``("dp", "fsdp")`` of its mesh. Both
start from the JAX package's parameters (carried over with ``convert``)
and take the same batch from the JAX package's env runner and, for PPO,
the same permutations (JAX's ``permutation(k, N)`` for ``k in
split(key, epochs)``). Per algorithm: one update's loss metrics (rtol
1e-5) and parameters (rtol 1e-5 / atol 1e-6 of each leaf), and the two
ranks' parameters equal to the bit. Then one ``train()`` iteration on
each rank, the first rank's sampling replaced by the same batch: the
ranks end equal to the bit, and equal the unsharded port algorithm's
iteration within the same limits (the sums run in another order).
"""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import convert, train
from ray_tpu_torch.parallel.mesh import MeshSpec

RTOL = 1e-5
ATOL = 1e-6
T, B = 32, 8
PPO_KW = dict(lr=1e-3, num_epochs=4, minibatches=4)
IMPALA_LR = 1e-3
BC_KW = dict(lr=1e-3, batch_size=64)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 2,
    })
    yield rt
    rt.shutdown()


def _make_loop():
    """The rank program, by value (worker processes cannot import this
    module): every algorithm built with ``mesh=``, its update and one
    iteration; every rank's parameters gathered to rank 0's report."""
    def loop(cfg):
        import numpy as np
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import rllib, train
        from ray_tpu_torch.rllib import bc as tbc

        torch.set_num_threads(1)
        mesh = train.get_context().global_mesh()

        def tensors(tree):
            return {k: torch.tensor(v) for k, v in tree.items()}

        def host(tree):
            return {k: v.detach().numpy() for k, v in tree.items()}

        def gathered(value):
            out = [None] * dist.get_world_size()
            dist.all_gather_object(out, value)
            return out

        class StubRunner:
            """An eval runner whose sample is a fixed episode list."""

            class _Sample:
                @staticmethod
                def remote():
                    import ray_tpu_torch
                    return ray_tpu_torch.put(
                        {"episode_returns": np.asarray([10.0, 30.0])})

            sample = _Sample()

            class _Set:
                @staticmethod
                def remote(*a, **k):
                    import ray_tpu_torch
                    return ray_tpu_torch.put(None)

            set_weights = _Set()

        class Rows:
            """A dataset only the first rank may read."""

            def __init__(self, batches, readable):
                self.batches, self.readable = batches, readable

            def iter_batches(self, batch_size, drop_last):
                assert self.readable, "a non-root rank read the dataset"
                return iter(self.batches)

        out = {}
        # PPO: one update with the JAX permutations, then one iteration
        ppo_cfg = rllib.PPOConfig(num_env_runners=0, seed=3, **cfg["ppo_kw"])
        algo = ppo_cfg.build(device="cpu", mesh=mesh)
        assert (algo.is_root, len(algo.runners)) == (
            dist.get_rank() == 0, 0)
        new, m = algo.learner.update(tensors(cfg["params"]), cfg["batch"],
                                     perms=cfg["perms"])
        out["ppo"] = gathered((host(new), m["loss"]))
        algo.params = tensors(cfg["params"])
        algo.learner.initialized = False        # a fresh Adam
        if algo.is_root:
            algo._sample = lambda: (cfg["batch"], np.asarray([20.0]))
        res = algo.train()
        out["ppo_train"] = gathered((host(algo.params),
                                     res["learner"]["loss"],
                                     res["episode_return_mean"]))
        # IMPALA
        imp = rllib.IMPALAConfig(num_env_runners=0, batches_per_iteration=1,
                                 lr=cfg["impala_lr"], seed=3).build(
            device="cpu", mesh=mesh)
        new, m = imp.learner.update(tensors(cfg["params"]),
                                    cfg["impala_batch"])
        out["impala"] = gathered((host(new), m))
        imp.params = tensors(cfg["params"])
        imp.learner.initialized = False
        if imp.is_root:
            imp._next_batch = lambda: (None, cfg["impala_batch"])
        res = imp.train()
        out["impala_train"] = gathered((host(imp.params), res["learner"],
                                        res["env_steps_this_iter"]))
        # BC: the whole batch on every rank, read by the first only
        bc = tbc.BCConfig(
            dataset=Rows(cfg["bc_batches"], dist.get_rank() == 0),
            num_eval_runners=0, seed=3, **cfg["bc_kw"]).build(
            device="cpu", mesh=mesh)
        bc.params = tensors(cfg["params"])
        bc.learner.init(bc.params)
        if bc.is_root:
            bc.runners = [StubRunner()]
        res = bc.train()
        out["bc_train"] = gathered((host(bc.params), res["learner"],
                                    res["episode_return_mean"]))
        train.report(out)
    return loop


def _jax_side():
    import jax

    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    from ray_tpu.rllib import bc as jbc
    from ray_tpu.rllib import env_runner as jrunner
    from ray_tpu.rllib import impala as jimpala
    from ray_tpu.rllib import learner as jlearner
    from ray_tpu.rllib import module as jmod

    mesh = build_mesh(JMeshSpec(dp=2), devices=jax.devices()[:2])
    jp = jmod.init_module(jax.random.PRNGKey(4), 4, 2)
    runner = jrunner.EnvRunner("CartPole-v1", B, T, seed=4)
    runner.set_weights(jp)
    batch = runner.sample()
    assert batch["dones"].any()
    key = jax.random.PRNGKey(9)
    N = T * B
    perms = [np.asarray(jax.random.permutation(k, N))
             for k in jax.random.split(key, PPO_KW["num_epochs"])]
    ppo = jlearner.PPOLearner(mesh=mesh, **PPO_KW)
    ppo_new, ppo_m = ppo.update(jp, batch, key)

    imp_batch = dict(batch)
    imp_batch["logp"] = batch["logp"] + np.random.default_rng(5).normal(
        0, 0.3, batch["logp"].shape).astype(np.float32)
    imp = jimpala.IMPALALearner(lr=IMPALA_LR, mesh=mesh)
    imp_new, imp_m = imp.update(jp, imp_batch)

    rng = np.random.default_rng(6)
    bc_batches = [{"obs": rng.normal(size=(64, 4)).astype(np.float32),
                   "action": rng.integers(0, 2, 64).astype(np.int32)}
                  for _ in range(3)]
    bcl = jbc.BCLearner(lr=BC_KW["lr"], mesh=mesh)
    bcl.init(jp)
    bc_new, bc_losses = jp, []
    for b in bc_batches:
        bc_new, m = bcl.update(bc_new, b)
        bc_losses.append(m["bc_loss"])

    def leaves(tree):
        return convert.to_numpy(convert.from_jax(tree, device="cpu"))

    cfg = {"params": leaves(jp), "batch": batch, "perms": perms,
           "impala_batch": imp_batch, "bc_batches": bc_batches,
           "ppo_kw": PPO_KW, "impala_lr": IMPALA_LR, "bc_kw": BC_KW}
    want = {"ppo": (leaves(ppo_new), ppo_m["loss"]),
            "impala": (leaves(imp_new), imp_m),
            "bc": (leaves(bc_new), float(np.mean(bc_losses)))}
    return cfg, want


@pytest.fixture(scope="module")
def runs(cluster, tmp_path_factory):
    cfg, want = _jax_side()
    result = train.TorchTrainer(
        _make_loop(), train_loop_config=cfg,
        scaling_config=train.ScalingConfig(num_workers=2,
                                           mesh=MeshSpec(dp=2),
                                           use_gpu=False),
        run_config=train.RunConfig(
            storage_path=str(tmp_path_factory.mktemp("rl_mesh")))).fit()
    return result.metrics, want, cfg


def _close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _ranks_equal(per_rank):
    first = per_rank[0][0]
    for other, *_ in per_rank[1:]:
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    assert all(r[1:] == per_rank[0][1:] for r in per_rank)


def test_ppo_update_over_two_ranks_matches_jax(runs):
    got, want, _ = runs
    _ranks_equal(got["ppo"])
    params, loss = got["ppo"][0]
    _close(params, want["ppo"][0])
    assert loss == pytest.approx(want["ppo"][1], rel=RTOL)


def test_impala_update_over_two_ranks_matches_jax(runs):
    got, want, _ = runs
    _ranks_equal(got["impala"])
    params, m = got["impala"][0]
    _close(params, want["impala"][0])
    for k in ("loss", "v_loss", "entropy"):
        assert m[k] == pytest.approx(want["impala"][1][k], rel=RTOL), k


def test_bc_over_two_ranks_matches_jax(runs):
    got, want, _ = runs
    _ranks_equal(got["bc_train"])
    params, m, ret = got["bc_train"][0]
    _close(params, want["bc"][0])
    assert m["bc_loss"] == pytest.approx(want["bc"][1], rel=RTOL)
    assert ret == 20.0          # the first rank's returns, broadcast


def test_iterations_over_two_ranks_match_one_rank(runs):
    """``train()`` on the mesh (the first rank samples, draws the
    permutations and broadcasts them) against the port's unsharded
    algorithm on the same batch: PPO's and IMPALA's parameters within
    the limits, both ranks equal to the bit."""
    import torch

    from ray_tpu_torch import rllib
    got, _, cfg = runs
    _ranks_equal(got["ppo_train"])
    _ranks_equal(got["impala_train"])
    torch.set_num_threads(1)

    def tensors(tree):
        return {k: torch.tensor(v) for k, v in tree.items()}

    ppo = rllib.PPOConfig(num_env_runners=0, seed=3, **PPO_KW).build(
        device="cpu")
    ppo.params = tensors(cfg["params"])
    ppo._sample = lambda: (cfg["batch"], np.asarray([20.0]))
    res = ppo.train()
    params, loss, ret = got["ppo_train"][0]
    _close(params, {k: v.numpy() for k, v in ppo.params.items()})
    assert loss == pytest.approx(res["learner"]["loss"], rel=RTOL)
    assert ret == res["episode_return_mean"] == 20.0

    imp = rllib.IMPALAConfig(num_env_runners=0, batches_per_iteration=1,
                             lr=IMPALA_LR, seed=3).build(device="cpu")
    imp.params = tensors(cfg["params"])
    imp._next_batch = lambda: (None, cfg["impala_batch"])
    res = imp.train()
    params, m, steps = got["impala_train"][0]
    _close(params, {k: v.numpy() for k, v in imp.params.items()})
    assert steps == res["env_steps_this_iter"] == T * B
    for k in ("loss", "v_loss", "entropy"):
        assert m[k] == pytest.approx(res["learner"][k], rel=RTOL), k
