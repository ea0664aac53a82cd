"""EnvRunner — the rollout actor.

The port of ``ray_tpu/rllib/env_runner.py``: an actor stepping a numpy
vector env with the current policy on ``device``, returning fixed-size
trajectory batches as numpy arrays. Weights arrive as an ObjectRef (one
store write per sync, every runner reads the same copy); in local mode
that copy is shared by reference, so the learner puts a snapshot
(``module.snapshot``) that its next update cannot reach.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib.env import ENV_REGISTRY
from ray_tpu_torch.rllib.module import (forward, sample_actions,
                                        sample_squashed, tree_map)

EXPLORATIONS = ("categorical", "epsilon_greedy", "squashed_gaussian")


class EnvRunner:
    def __init__(self, env_name: str, num_envs: int, rollout_len: int,
                 seed: int = 0, exploration: str = "categorical",
                 device="cuda"):
        """exploration: "categorical" samples the policy distribution
        (on-policy, PPO); "epsilon_greedy" takes argmax over the logits
        head (Q-values for DQN) with probability 1-epsilon;
        "squashed_gaussian" samples SAC's actor. The policy runs on
        ``device`` (the card unless the caller asks for the CPU), its
        noise drawn from a generator there seeded ``seed``."""
        if exploration not in EXPLORATIONS:
            raise ValueError(f"exploration {exploration!r} is not one of "
                             f"{EXPLORATIONS}")
        self.device = resolve_device(device)
        self.env = ENV_REGISTRY[env_name](num_envs)
        self.rollout_len = rollout_len
        self.obs = self.env.reset(seed=seed)
        self.params = None
        self.exploration = exploration
        self.epsilon = 1.0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def _sample(self, obs: np.ndarray):
        """-> (actions, logp, values) as numpy arrays."""
        x = torch.as_tensor(obs, device=self.device)
        if self.exploration == "categorical":
            a, logp, v = sample_actions(self.params, x, self._gen)
        elif self.exploration == "squashed_gaussian":
            a, logp = sample_squashed(self.params["actor"], x, self._gen,
                                      float(self.env.action_scale))
            v = torch.zeros(x.shape[0], device=self.device)
        else:
            logits, v = forward(self.params, x)
            greedy = torch.argmax(logits, dim=-1)
            explore = torch.rand(greedy.shape, generator=self._gen,
                                 device=self.device) < self.epsilon
            rand = torch.randint(0, logits.shape[-1], greedy.shape,
                                 generator=self._gen, device=self.device)
            a = torch.where(explore, rand, greedy)
            # logp meaningless for Q-learning; zeros keep the batch shape
            logp = torch.zeros_like(v)
        return a.cpu().numpy(), logp.cpu().numpy(), v.cpu().numpy()

    def set_weights(self, params: Any, epsilon: float = None) -> bool:
        # on this runner's device: a cluster worker gets CPU tensors, and
        # a runner's device may differ from the learner's
        self.params = tree_map(lambda t: t.to(self.device), params)
        if epsilon is not None:
            self.epsilon = float(epsilon)
        return True

    def sample(self) -> Dict[str, np.ndarray]:
        """Collect rollout_len steps from every env.

        Returns obs/actions/logp/values/rewards/dones [T, B] (+obs dims)
        plus last_value [B] for GAE bootstrap and episode-return stats.
        """
        assert self.params is not None, "set_weights before sample"
        T, B = self.rollout_len, self.env.num_envs
        act_shape = (T, B, self.env.action_dim) \
            if self.env.continuous else (T, B)
        out = {
            "obs": np.zeros((T, B, self.env.observation_dim), np.float32),
            "actions": np.zeros(act_shape,
                                np.float32 if self.env.continuous
                                else np.int32),
            "logp": np.zeros((T, B), np.float32),
            "values": np.zeros((T, B), np.float32),
            "rewards": np.zeros((T, B), np.float32),
            "dones": np.zeros((T, B), np.bool_),
            "truncated": np.zeros((T, B), np.bool_),
            "final_obs": np.zeros((T, B, self.env.observation_dim),
                                  np.float32),
        }
        self.env.episode_returns.clear()
        for t in range(T):
            actions, logp, values = self._sample(self.obs)
            actions = actions.astype(out["actions"].dtype)
            out["obs"][t] = self.obs
            out["actions"][t] = actions
            out["logp"][t] = logp
            out["values"][t] = values
            self.obs, rewards, dones, info = self.env.step(actions)
            out["rewards"][t] = rewards
            out["dones"][t] = dones
            if "truncated" in info:
                out["truncated"][t] = info["truncated"]
            if "final_obs" in info:
                out["final_obs"][t] = info["final_obs"]
        _, _, last_value = self._sample(self.obs)
        out["last_value"] = last_value
        out["last_obs"] = np.asarray(self.obs, np.float32)
        out["episode_returns"] = np.asarray(self.env.episode_returns,
                                            np.float32)
        return out
