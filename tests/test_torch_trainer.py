"""``TorchTrainer`` through the programs of tests/test_train.py's
``TestJaxTrainer``, each run by both packages in local mode (one worker,
no process group): the MLP end to end, a failure restarted from the
latest checkpoint, the checkpoint frequency, and the failure budget
running out. The JAX package runs its loop (``JaxTrainer``, optax), the
port its own (``TorchTrainer``, torch.optim); both must meet the same
assertions.
"""

import importlib
import os

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(scope="module", params=PACKAGES)
def pkg(request):
    mod = importlib.import_module(request.param)
    mod.init(local_mode=True, num_cpus=4)
    yield mod
    mod.shutdown()


def _train(pkg):
    return importlib.import_module(f"{pkg.__name__}.train")


def _jax_mlp_loop(config):
    import jax
    import optax

    from ray_tpu import train as rt_train
    from ray_tpu.models.mlp import MLPConfig, mlp_init, mlp_loss
    from ray_tpu.train import make_train_step
    ctx = rt_train.get_context()
    cfg = MLPConfig(in_dim=16, hidden=32, out_dim=4)
    params = mlp_init(cfg, jax.random.PRNGKey(0))
    start = 0
    if ctx.get_checkpoint() is not None:
        state = ctx.get_checkpoint().load()
        params, start = state["params"], int(state["step"])
    init_fn, step_fn = make_train_step(mlp_loss, optax.adam(1e-2))
    opt_state = init_fn(params)
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 16))
    y = jax.random.randint(jax.random.PRNGKey(2), (64,), 0, 4)
    _steps(rt_train, config, start, lambda p, s: step_fn(p, s, (x, y)),
           params, opt_state)


def _torch_mlp_loop(config):
    import functools

    import torch

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models.mlp import MLPConfig, mlp_init, mlp_loss
    ctx = rt_train.get_context()
    cfg = MLPConfig(in_dim=16, hidden=32, out_dim=4)
    params = mlp_init(cfg, seed=0, device="cpu")
    start = 0
    if ctx.get_checkpoint() is not None:
        state = ctx.get_checkpoint().load(
            target={"params": params, "step": 0})
        params, start = state["params"], int(state["step"])
    init_fn, step_fn = rt_train.make_train_step(
        mlp_loss, functools.partial(torch.optim.Adam, lr=1e-2))
    opt_state = init_fn(params)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 16, generator=g)
    y = torch.randint(0, 4, (64,), generator=g)
    _steps(rt_train, config, start, lambda p, s: step_fn(p, s, (x, y)),
           params, opt_state)


def _steps(rt_train, config, start, step, params, opt_state):
    """tests/test_train.py's loop body: a step, the injected failure,
    then a report offering a checkpoint of params and the next step."""
    for i in range(start, config["steps"]):
        params, opt_state, metrics = step(params, opt_state)
        if config.get("fail_at") is not None and i == config["fail_at"] \
                and not os.path.exists(config["fail_marker"]):
            open(config["fail_marker"], "w").close()
            raise RuntimeError("injected worker failure")
        rt_train.report({"loss": float(metrics["loss"]), "step": i},
                        checkpoint_tree={"params": params, "step": i + 1})


def _fit(pkg, loop_config, tmp_path, name, failure=None, ckpt=None,
         loop=None):
    train = _train(pkg)
    trainer_cls = train.TorchTrainer if pkg.__name__ == "ray_tpu_torch" \
        else train.JaxTrainer
    if loop is None:
        loop = _torch_mlp_loop if pkg.__name__ == "ray_tpu_torch" \
            else _jax_mlp_loop
    run = train.RunConfig(name=name, storage_path=str(tmp_path))
    if failure is not None:
        run.failure_config = train.FailureConfig(max_failures=failure)
    if ckpt is not None:
        run.checkpoint_config = train.CheckpointConfig(
            checkpoint_frequency=ckpt)
    return trainer_cls(loop, train_loop_config=loop_config,
                       scaling_config=train.ScalingConfig(num_workers=1),
                       run_config=run).fit()


def test_mlp_end_to_end(pkg, tmp_path):
    result = _fit(pkg, {"steps": 5, "fail_at": None}, tmp_path, "mlp")
    assert result.metrics["step"] == 4
    assert len(result.metrics_history) == 5
    losses = [m["loss"] for m in result.metrics_history]
    assert losses[-1] < losses[0]
    assert result.checkpoint is not None
    assert int(result.checkpoint.load()["step"]) == 5


def test_failure_restart_resumes_from_checkpoint(pkg, tmp_path):
    marker = str(tmp_path / "failed_once")
    result = _fit(pkg, {"steps": 6, "fail_at": 3, "fail_marker": marker},
                  tmp_path, "mlp_ft", failure=1)
    assert os.path.exists(marker)  # the failure really happened
    steps = [m["step"] for m in result.metrics_history]
    assert steps[-1] == 5
    assert result.checkpoint is not None
    manager = importlib.import_module(
        f"{pkg.__name__}.train.checkpoint").CheckpointManager
    assert manager.step_of(result.checkpoint.path) >= 6


def test_checkpoint_frequency_thins_saves(pkg, tmp_path):
    result = _fit(pkg, {"steps": 6, "fail_at": None}, tmp_path, "freq",
                  ckpt=3)
    dirs = sorted(d for d in os.listdir(result.path)
                  if d.startswith("checkpoint_"))
    assert dirs == ["checkpoint_00000003", "checkpoint_00000006"]


def test_failure_budget_exhausted_raises(pkg, tmp_path):
    def always_fail(config):
        raise RuntimeError("boom")

    failed = importlib.import_module(
        f"{pkg.__name__}.train.trainer").TrainingFailedError
    with pytest.raises(failed):
        _fit(pkg, None, tmp_path, "f", failure=1, loop=always_fail)
