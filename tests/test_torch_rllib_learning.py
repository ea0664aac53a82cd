"""The port's four RL algorithms learn, at the JAX package's own test
settings and gates (tests/test_rllib.py, which ``chip_smoke.rl_cases``
holds for phase 11 too), on the CPU through the port's local-mode
runtime.

The parity of each learner's single update with the JAX package is in
tests/test_torch_rllib.py; these are kept apart so that each file stays
short under ``--dist loadfile``.
"""

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
