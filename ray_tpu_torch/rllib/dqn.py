"""DQN — replay-based off-policy training on the same Learner/EnvRunner
seams as PPO.

The port of ``ray_tpu/rllib/dqn.py``: sample rollouts into a replay
buffer, then N learner updates per iteration with a periodically-synced
target network. The update is double DQN (the online net picks a', the
target net scores it) with optax's Huber loss (delta 1); the Q-network
reuses the shared RLModule torso (its policy head emits Q-values; the
value head is unused). Exploration is epsilon-greedy on the runners with
a linear decay schedule driven by the algorithm.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.env import ENV_REGISTRY
from ray_tpu_torch.rllib.learner import (Adam, params_device, to_device,
                                         value_and_grad)
from ray_tpu_torch.rllib.module import forward, init_module
from ray_tpu_torch.rllib.replay import ReplayBuffer
from ray_tpu_torch.rllib.trainer_base import TrainerBase, check_build


def huber_loss(errors: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax ``huber_loss``: 0.5·min(|e|, δ)² + δ·(|e| − min(|e|, δ))."""
    abs_errors = errors.abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_errors - quadratic)


class DQNLearner:
    """The double-DQN update (reference: dqn learner loss)."""

    def __init__(self, *, lr: float = 1e-3, gamma: float = 0.99,
                 max_grad_norm: float = 10.0):
        self.gamma = gamma
        self.optimizer = Adam(lr, max_norm=max_grad_norm)
        self.initialized = False

    def _loss(self, p, target_params, batch):
        q, _ = forward(p, batch["obs"])
        rows = torch.arange(q.shape[0], device=q.device)
        q_sa = q[rows, batch["actions"]]
        # double DQN: online net picks a', target net scores it
        with torch.no_grad():
            q_next_online, _ = forward(p, batch["next_obs"])
            a_next = torch.argmax(q_next_online, dim=-1)
            q_next_target, _ = forward(target_params, batch["next_obs"])
            q_next = q_next_target[rows, a_next]
        nonterminal = 1.0 - batch["dones"].float()
        target = batch["rewards"] + self.gamma * nonterminal * q_next
        td = q_sa - target
        return huber_loss(td).mean(), td.abs().mean().detach()

    def update(self, params, target_params, batch: Dict[str, np.ndarray]
               ) -> Tuple[Any, Dict[str, float]]:
        if not self.initialized:
            self.optimizer.init(params)
            self.initialized = True
        jb = to_device(batch, tuple(batch), params_device(params))
        loss, td_abs, grads = value_and_grad(self._loss, params,
                                             target_params, jb)
        params = self.optimizer.step(params, grads)
        m = torch.stack([loss, td_abs]).tolist()
        return params, {"loss": m[0], "td_abs_mean": m[1]}


@dataclasses.dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_length: int = 32
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    train_batch_size: int = 256
    updates_per_iter: int = 16
    learning_starts: int = 1_000
    target_sync_every: int = 200      # gradient updates between target syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iters: int = 30
    hidden: tuple = (64, 64)
    seed: int = 0
    # the env runners' device ("cpu", "cuda"); None: the learner's
    runner_device: Optional[str] = None

    def build(self, device="cuda") -> "DQN":
        return DQN(self, device=device)


class DQN(TrainerBase):
    def __init__(self, config: DQNConfig, device="cuda"):
        self.config = config
        self.device = check_build(device)
        spec = ENV_REGISTRY[config.env](1)
        gen = torch.Generator(device=self.device).manual_seed(config.seed)
        self.params = init_module(gen, spec.observation_dim,
                                  spec.num_actions, config.hidden)
        # updates return new tensors, so sharing them here is a copy
        self.target_params = self.params
        self.learner = DQNLearner(lr=config.lr, gamma=config.gamma)
        self.buffer = ReplayBuffer(config.buffer_capacity,
                                   spec.observation_dim, seed=config.seed)
        self._make_runners(config.env, config.num_env_runners,
                           config.num_envs_per_runner,
                           config.rollout_length, config.seed,
                           exploration="epsilon_greedy")
        self.num_updates = 0

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end -
                                           cfg.epsilon_start)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.monotonic()
        eps = self._epsilon()
        self._broadcast_weights(epsilon=eps)
        t_sample = time.monotonic()
        batches = ray_tpu_torch.get(
            [r.sample.remote() for r in self.runners], timeout=600)
        t_sample = time.monotonic() - t_sample
        returns: List[float] = []
        for b in batches:
            T, B = b["rewards"].shape
            # trajectory -> transitions: s'[t] = s[t+1], except at
            # boundaries where the true pre-reset obs stands in (the
            # auto-reset obs belongs to the NEXT episode); only true
            # terminations mask the TD bootstrap — a 500-step CartPole
            # truncation bootstraps through (gym terminated/truncated)
            next_obs = np.concatenate([b["obs"][1:], b["last_obs"][None]])
            next_obs = np.where(b["dones"][..., None], b["final_obs"],
                                next_obs)
            terminal = b["dones"] & ~b["truncated"]
            self.buffer.add_batch(
                b["obs"].reshape(T * B, -1),
                b["actions"].reshape(T * B),
                b["rewards"].reshape(T * B),
                terminal.reshape(T * B),
                next_obs.reshape(T * B, -1))
            returns.extend(b["episode_returns"].tolist())
        metrics: Dict[str, float] = {}
        t_learn = time.monotonic()
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                sample = self.buffer.sample(cfg.train_batch_size)
                self.params, metrics = self.learner.update(
                    self.params, self.target_params, sample)
                self.num_updates += 1
                if self.num_updates % cfg.target_sync_every == 0:
                    self.target_params = self.params
        t_learn = time.monotonic() - t_learn
        self._track_returns(returns)
        return self._base_result(
            episodes=len(returns), t0=t0,
            buffer_size=len(self.buffer), epsilon=round(eps, 4),
            num_updates=self.num_updates, time_sample_s=t_sample,
            time_learn_s=t_learn, learner=metrics)
