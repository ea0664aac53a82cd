"""Vectorized env API + dependency-free CartPole and Pendulum.

Role-equivalent to the reference's env layer (reference:
rllib/env/single_agent_env_runner.py:66 runs gym vector envs): a VectorEnv
steps B environments in lockstep with numpy arrays — auto-resetting done
envs, the convention the runner's trajectory collection assumes.
CartPole-v1 (discrete) and Pendulum-v1 (continuous control) dynamics
reimplemented in numpy (no gym in the image).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


class VectorEnv:
    num_envs: int
    observation_dim: int
    #: discrete envs set num_actions; continuous envs set
    #: continuous=True + action_dim + action_scale instead
    num_actions: int = 0
    continuous: bool = False
    action_dim: int = 0
    action_scale: float = 1.0

    def reset(self, seed: int = 0) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
        """actions [B] (discrete) or [B, action_dim] (continuous) ->
        (obs [B, D], rewards [B], dones [B], info).
        Done envs auto-reset; obs is the NEW episode's first obs. info
        carries the boundary facts the auto-reset hides from learners:
        ``truncated`` [B] (done by TIME LIMIT, not failure — off-policy
        TD targets must bootstrap THROUGH these, gym's terminated/
        truncated split) and ``final_obs`` [B, D] (the pre-reset
        observation, the true s' for boundary transitions)."""
        raise NotImplementedError


class CartPoleVectorEnv(VectorEnv):
    """CartPole-v1 physics (standard constants), vectorized.

    Episode ends when |x| > 2.4, |theta| > 12deg, or 500 steps; reward 1
    per step. Solved threshold ~475.
    """

    GRAVITY = 9.8
    MASS_CART = 1.0
    MASS_POLE = 0.1
    LENGTH = 0.5           # half pole length
    FORCE = 10.0
    TAU = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * 2 * np.pi / 360
    MAX_STEPS = 500

    def __init__(self, num_envs: int):
        self.num_envs = num_envs
        self.observation_dim = 4
        self.num_actions = 2
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)
        self._rng = np.random.default_rng(0)
        self.episode_returns: list = []     # completed-episode returns
        self._ret = np.zeros(num_envs, np.float64)

    def reset(self, seed: int = 0) -> np.ndarray:
        self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, (self.num_envs, 4))
        self._steps[:] = 0
        self._ret[:] = 0
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        x, x_dot, th, th_dot = self._state.T
        force = np.where(actions == 1, self.FORCE, -self.FORCE)
        costh, sinth = np.cos(th), np.sin(th)
        total_mass = self.MASS_CART + self.MASS_POLE
        pm_len = self.MASS_POLE * self.LENGTH
        temp = (force + pm_len * th_dot ** 2 * sinth) / total_mass
        th_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.LENGTH * (4.0 / 3.0
                           - self.MASS_POLE * costh ** 2 / total_mass))
        x_acc = temp - pm_len * th_acc * costh / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        th = th + self.TAU * th_dot
        th_dot = th_dot + self.TAU * th_acc
        self._state = np.stack([x, x_dot, th, th_dot], axis=1)
        self._steps += 1
        self._ret += 1.0

        failed = ((np.abs(x) > self.X_LIMIT)
                  | (np.abs(th) > self.THETA_LIMIT))
        truncated = (~failed) & (self._steps >= self.MAX_STEPS)
        dones = failed | truncated
        rewards = np.ones(self.num_envs, np.float32)
        final_obs = self._state.astype(np.float32)
        if dones.any():
            idx = np.flatnonzero(dones)
            self.episode_returns.extend(self._ret[idx].tolist())
            self._state[idx] = self._rng.uniform(-0.05, 0.05,
                                                 (len(idx), 4))
            self._steps[idx] = 0
            self._ret[idx] = 0
        return (self._state.astype(np.float32), rewards,
                dones.astype(np.bool_),
                {"truncated": truncated.astype(np.bool_),
                 "final_obs": final_obs})


class PendulumVectorEnv(VectorEnv):
    """Pendulum-v1 dynamics (standard constants), vectorized — the
    CONTINUOUS-control env (torque in [-2, 2]) the SAC stack trains on.

    obs = [cos θ, sin θ, θ̇]; cost = θ̄² + 0.1·θ̇² + 0.001·u²
    (θ̄ = angle wrapped to [-π, π]); fixed 200-step episodes (time-limit
    truncation, never early termination). Random policy ≈ -1200 mean
    return; a trained SAC policy reaches ≈ -150..-250.
    """

    G = 10.0
    M = 1.0
    L = 1.0
    DT = 0.05
    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    MAX_STEPS = 200

    continuous = True
    action_dim = 1
    action_scale = MAX_TORQUE

    def __init__(self, num_envs: int):
        self.num_envs = num_envs
        self.observation_dim = 3
        self._th = np.zeros(num_envs)
        self._thdot = np.zeros(num_envs)
        self._steps = np.zeros(num_envs, np.int64)
        self._rng = np.random.default_rng(0)
        self.episode_returns: list = []
        self._ret = np.zeros(num_envs)

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._th), np.sin(self._th),
                         self._thdot], axis=1).astype(np.float32)

    def reset(self, seed: int = 0) -> np.ndarray:
        self._rng = np.random.default_rng(seed)
        self._th = self._rng.uniform(-np.pi, np.pi, self.num_envs)
        self._thdot = self._rng.uniform(-1.0, 1.0, self.num_envs)
        self._steps[:] = 0
        self._ret[:] = 0
        return self._obs()

    def step(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions, np.float64).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th_wrapped = ((self._th + np.pi) % (2 * np.pi)) - np.pi
        cost = (th_wrapped ** 2 + 0.1 * self._thdot ** 2
                + 0.001 * u ** 2)
        self._thdot = np.clip(
            self._thdot + (3 * self.G / (2 * self.L) * np.sin(self._th)
                           + 3.0 / (self.M * self.L ** 2) * u) * self.DT,
            -self.MAX_SPEED, self.MAX_SPEED)
        self._th = self._th + self._thdot * self.DT
        self._steps += 1
        rewards = (-cost).astype(np.float32)
        self._ret += rewards
        dones = self._steps >= self.MAX_STEPS
        final_obs = self._obs()
        if dones.any():
            idx = np.flatnonzero(dones)
            self.episode_returns.extend(self._ret[idx].tolist())
            self._th[idx] = self._rng.uniform(-np.pi, np.pi, len(idx))
            self._thdot[idx] = self._rng.uniform(-1.0, 1.0, len(idx))
            self._steps[idx] = 0
            self._ret[idx] = 0
        # every Pendulum done is a TIME LIMIT, never a failure state
        return (self._obs(), rewards, dones.astype(np.bool_),
                {"truncated": dones.astype(np.bool_),
                 "final_obs": final_obs})


ENV_REGISTRY = {"CartPole-v1": CartPoleVectorEnv,
                "Pendulum-v1": PendulumVectorEnv}
