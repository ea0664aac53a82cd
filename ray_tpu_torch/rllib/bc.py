"""BC — offline behavior cloning from a ray_tpu_torch.data dataset.

The port of ``ray_tpu/rllib/bc.py``. Role-equivalent to the reference's
offline-RL stack (reference: rllib/algorithms/bc/bc.py +
rllib/offline/offline_data.py: recorded episodes stream from a Dataset
into the Learner). The learner is one supervised update (cross-entropy of
the policy head against recorded actions) stepping optax's ``adam`` as
the JAX learner does, and ingest is the dataset's ``iter_batches`` — the
Data -> Train path end to end. Evaluation runs greedy EnvRunner actors.
Besides the JAX package's result keys, each result carries
``time_data_s`` (waiting on the dataset's batches) and ``time_learn_s``
(the learner updates).

On a device mesh (``build(mesh=)``) the JAX ``BCLearner`` keeps the mesh
and shards nothing; here every rank is a process, the first reads the
dataset and runs the evaluation runners, broadcasting each batch and the
returns, and every rank computes the same whole-batch update.

``record_dataset`` is the offline-writer half (reference:
rllib/offline/offline_env_runner.py): roll a trained policy and persist
(obs, action) rows as a Dataset.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.env import ENV_REGISTRY
from ray_tpu_torch.rllib.learner import Adam, params_device, value_and_grad
from ray_tpu_torch.rllib.module import forward, init_module
from ray_tpu_torch.rllib.trainer_base import (TrainerBase, check_build,
                                              from_root)


class BCLearner:
    """Supervised update: -log pi(a_recorded | obs), one Adam step."""

    def __init__(self, *, lr: float = 1e-3, mesh=None):
        self.optimizer = Adam(lr)
        self.mesh = mesh   # kept, as the JAX learner keeps it: no shards

    def init(self, params) -> None:
        self.optimizer.init(params)

    @staticmethod
    def _loss(p, obs, actions):
        logits, _ = forward(p, obs)
        logp = torch.log_softmax(logits, -1)
        return -logp.gather(1, actions[:, None])[:, 0].mean(), None

    def update(self, params, batch: Dict[str, np.ndarray]):
        dev = params_device(params)
        obs = torch.as_tensor(np.asarray(batch["obs"], np.float32),
                              device=dev)
        actions = torch.as_tensor(np.asarray(batch["action"], np.int64),
                                  device=dev)
        loss, _, grads = value_and_grad(self._loss, params, obs, actions)
        return self.optimizer.step(params, grads), {"bc_loss": float(loss)}


def record_dataset(algo, num_samples: int = 8192):
    """Roll `algo`'s current policy through its own runners and persist
    the visited (obs, action) pairs as a ray_tpu_torch.data Dataset — the
    offline-data writer (reference: offline_env_runner.py)."""
    from ray_tpu_torch.data import from_numpy

    algo._broadcast_weights()
    obs_parts, act_parts = [], []
    total = 0
    while total < num_samples:
        batches = ray_tpu_torch.get(
            [r.sample.remote() for r in algo.runners], timeout=600)
        for b in batches:
            T, B = b["actions"].shape
            obs_parts.append(
                b["obs"].reshape(T * B, -1).astype(np.float32))
            act_parts.append(b["actions"].reshape(T * B).astype(np.int32))
            total += T * B
    obs = np.concatenate(obs_parts)[:num_samples]
    act = np.concatenate(act_parts)[:num_samples]
    return from_numpy({"obs": obs, "action": act})


@dataclasses.dataclass
class BCConfig:
    dataset: Any = None          # ray_tpu_torch.data Dataset: {obs, action}
    env: str = "CartPole-v1"     # evaluation environment
    lr: float = 1e-3
    batch_size: int = 512
    num_eval_runners: int = 1
    num_envs_per_runner: int = 16
    eval_rollout_length: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0
    # the env runners' device ("cpu", "cuda"); None: the learner's
    runner_device: Optional[str] = None

    def build(self, device="cuda", mesh=None) -> "BC":
        if self.dataset is None:
            raise ValueError("BCConfig.dataset is required (use "
                             "rllib.record_dataset to create one)")
        return BC(self, device=device, mesh=mesh)


class BC(TrainerBase):
    """train() = one epoch over the dataset + one greedy evaluation."""

    def __init__(self, config: BCConfig, device="cuda", mesh=None):
        self.config = config
        self.device = check_build(device, mesh)
        self.mesh = mesh
        spec = ENV_REGISTRY[config.env](1)
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.params = init_module(self._gen, spec.observation_dim,
                                  spec.num_actions, config.hidden)
        self.learner = BCLearner(lr=config.lr, mesh=mesh)
        self.learner.init(self.params)
        # greedy evaluation runners (epsilon 0 => argmax over the policy
        # head): offline training, ONLINE measurement
        self._make_runners(config.env, config.num_eval_runners,
                           config.num_envs_per_runner,
                           config.eval_rollout_length, config.seed,
                           exploration="epsilon_greedy")

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        losses = []
        n = 0
        data_s = learn_s = 0.0
        batches = iter(self.config.dataset.iter_batches(
            batch_size=self.config.batch_size, drop_last=True)) \
            if self.is_root else None
        while True:
            t = time.monotonic()
            batch = next(batches, None) if self.is_root else None
            batch = from_root(batch, self.mesh)
            t_learn = time.monotonic()
            data_s += t_learn - t
            if batch is None:
                break
            self.params, metrics = self.learner.update(self.params, batch)
            learn_s += time.monotonic() - t_learn
            losses.append(metrics["bc_loss"])
            n += len(batch["action"])
        # greedy eval episode returns
        returns = None
        if self.is_root:
            self._broadcast_weights(epsilon=0.0)
            evals = ray_tpu_torch.get(
                [r.sample.remote() for r in self.runners], timeout=600)
            returns = np.concatenate([b["episode_returns"] for b in evals])
        returns = from_root(returns, self.mesh)
        self._track_returns(returns)
        return self._base_result(
            episodes=int(len(returns)), t0=t0,
            env_steps_this_iter=n, time_data_s=data_s,
            time_learn_s=learn_s,
            learner={"bc_loss": float(np.mean(losses)) if losses
                     else float("nan")})
