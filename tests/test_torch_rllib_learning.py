"""The port's four RL algorithms learn, at the JAX package's own test
settings and gates (tests/test_rllib.py, which ``chip_smoke.rl_cases``
holds for phase 11 too), on the CPU through the port's local-mode
runtime.

The parity of each learner's single update with the JAX package is in
tests/test_torch_rllib.py; these are kept apart so that each file stays
short under ``--dist loadfile``.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

import ray_tpu_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

# tests/test_rllib.py's bound on the first episode-return mean
FIRST_MEAN_BOUND = {"PPO": 60.0, "DQN": 60.0, "SAC": -700.0}


@pytest.fixture
def torch_rt():
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("algo", ["PPO", "IMPALA", "DQN", "SAC"])
def test_algorithm_learns(algo, torch_rt):
    config, iterations, gate = chip_smoke.rl_cases()[algo]
    trainer = config.build(device="cpu")
    first, best = None, float("-inf")
    try:
        for _ in range(iterations):
            result = trainer.train()
            mean = result["episode_return_mean"]
            if first is None and result["episodes_this_iter"]:
                first = mean
            if mean == mean:
                best = max(best, mean)
            if best >= gate:
                break
    finally:
        trainer.stop()
    if algo in FIRST_MEAN_BOUND:
        assert first is not None and first < FIRST_MEAN_BOUND[algo], \
            f"env suspiciously easy from the start: {first}"
    assert best >= gate, f"{algo} failed to learn: first={first}, best={best}"


@pytest.mark.parametrize("runner_device", [None, "cpu", "cuda"])
def test_runners_sample_on_the_configs_runner_device(runner_device,
                                                      torch_rt):
    """The env runners' device is the config's ``runner_device`` (None:
    the learner's), whatever the runtime's mode; a card asked for where
    there is none fails the build instead of sampling on the CPU."""
    from ray_tpu_torch.core.worker import global_worker
    config, _, _ = chip_smoke.rl_cases()["PPO"]
    config = dataclasses.replace(config, runner_device=runner_device)
    want = torch.device(runner_device or "cpu")
    if want.type == "cuda" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            config.build(device="cpu")
        return
    trainer = config.build(device="cpu")
    try:
        trainer.train()
        actors = global_worker.backend.actors
        devices = {actors[r.actor_id].instance.device
                   for r in trainer.runners}
        params = [t for r in trainer.runners
                  for t in actors[r.actor_id].instance.params.values()]
    finally:
        trainer.stop()
    assert devices == {want}
    assert params and all(t.device.type == want.type for t in params)

