"""Uniform replay buffer for off-policy algorithms.

Role-equivalent to the reference's replay buffers (reference:
rllib/utils/replay_buffers/replay_buffer.py — ring storage + uniform
sampling; the prioritized variant layers a sum-tree on the same seams).
Host-side numpy ring: the learner's jitted update consumes the sampled
arrays, so storage never needs to live on device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 action_dim: Optional[int] = None):
        """action_dim=None stores discrete int32 actions [N]; an int
        stores continuous float32 actions [N, action_dim] (SAC)."""
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        if action_dim is None:
            self.actions = np.zeros(capacity, np.int32)
        else:
            self.actions = np.zeros((capacity, action_dim), np.float32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.bool_)
        self._write = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_batch(self, obs, actions, rewards, dones, next_obs) -> None:
        """Append N transitions (vectorized ring write with wraparound)."""
        n = len(actions)
        idx = (self._write + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.next_obs[idx] = next_obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.dones[idx] = dones
        self._write = int((self._write + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
            "next_obs": self.next_obs[idx],
        }
