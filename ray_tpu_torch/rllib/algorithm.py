"""PPO Algorithm — EnvRunner group + Learner orchestration.

The port of ``ray_tpu/rllib/algorithm.py``: per iteration, runner actors
sample in parallel, the learner does one PPO update, and fresh weights
broadcast to the runners through the object store. Besides the JAX
package's result keys, each result carries ``time_sample_s`` (waiting on
the runners' batches) and ``time_learn_s`` (the learner update).

On a device mesh (``build(mesh=)``, on every rank) the first rank samples
and broadcasts the batch and the epochs' permutations; every rank runs
the update on its columns of the env axis (``learner.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.env import ENV_REGISTRY
from ray_tpu_torch.rllib.learner import PPOLearner
from ray_tpu_torch.rllib.module import init_module
from ray_tpu_torch.rllib.trainer_base import (TrainerBase, check_build,
                                              from_root)


@dataclasses.dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 16
    rollout_length: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatches: int = 4
    hidden: tuple = (64, 64)
    seed: int = 0
    # the env runners' device ("cpu", "cuda"); None: the learner's
    runner_device: Optional[str] = None

    def build(self, device="cuda", mesh=None) -> "PPO":
        return PPO(self, device=device, mesh=mesh)


class PPO(TrainerBase):
    def __init__(self, config: PPOConfig, device="cuda", mesh=None):
        self.config = config
        self.device = check_build(device, mesh)
        self.mesh = mesh
        spec = ENV_REGISTRY[config.env](1)
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.params = init_module(self._gen, spec.observation_dim,
                                  spec.num_actions, config.hidden)
        self.learner = PPOLearner(
            lr=config.lr, gamma=config.gamma,
            gae_lambda=config.gae_lambda, clip=config.clip,
            vf_coeff=config.vf_coeff, entropy_coeff=config.entropy_coeff,
            num_epochs=config.num_epochs, minibatches=config.minibatches,
            mesh=mesh)
        self._make_runners(config.env, config.num_env_runners,
                           config.num_envs_per_runner,
                           config.rollout_length, config.seed)

    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: Algorithm.train)."""
        t0 = time.monotonic()
        t_sample = t_learn = t0
        batch = returns = perms = None
        if self.is_root:
            self._broadcast_weights()
            t_sample = time.monotonic()
            batch, returns = self._sample()
            t_learn = time.monotonic()
            # each epoch's permutation, sent to every rank of a mesh
            perms = [torch.randperm(batch["rewards"].size,
                                    generator=self._gen,
                                    device=self.device).cpu().numpy()
                     for _ in range(self.config.num_epochs)]
        batch, returns, perms = from_root((batch, returns, perms),
                                          self.mesh)
        self.params, metrics = self.learner.update(self.params, batch,
                                                   perms=perms)
        t_done = time.monotonic()
        self._track_returns(returns)
        return self._base_result(
            episodes=int(len(returns)), t0=t0,
            env_steps_this_iter=int(batch["rewards"].size),
            time_sample_s=t_learn - t_sample,
            time_learn_s=t_done - t_learn, learner=metrics)

    def _sample(self):
        """One batch from every runner, concatenated along the env axis,
        and the episode returns."""
        batches = ray_tpu_torch.get(
            [r.sample.remote() for r in self.runners], timeout=600)
        batch = {
            k: np.concatenate([b[k] for b in batches],
                              axis=1 if batches[0][k].ndim > 1 else 0)
            for k in ("obs", "actions", "logp", "values", "rewards",
                      "dones")}
        batch["last_value"] = np.concatenate(
            [b["last_value"] for b in batches])
        returns = np.concatenate(
            [b["episode_returns"] for b in batches])
        return batch, returns
