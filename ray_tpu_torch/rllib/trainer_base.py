"""Shared trainer scaffold for the algorithm classes.

The port of ``ray_tpu/rllib/trainer_base.py``: runner-pool construction,
weight broadcast, the episode-return window and teardown. Runners and
learner share one device. Weights go out as a detached snapshot: local
mode stores values by reference, and torch tensors, unlike JAX arrays,
can change under a runner that holds them."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.module import snapshot

RETURN_WINDOW = 100


def check_build(device, mesh) -> torch.device:
    """The device an algorithm's ``build`` runs on; a mesh raises, since
    this package has no device mesh yet."""
    if mesh is not None:
        raise ValueError("a mesh argument needs a device mesh, which this "
                         "port does not have yet")
    return resolve_device(device)


class TrainerBase:
    """Runner-pool construction, weight broadcast, episode-return window,
    and teardown — the parts every algorithm shares."""

    runners: List[Any]
    params: Any
    device: torch.device

    def _make_runners(self, env: str, num_runners: int, num_envs: int,
                      rollout_len: int, seed: int,
                      exploration: str = "categorical") -> None:
        runner_cls = ray_tpu_torch.remote(num_cpus=1)(EnvRunner)
        self.runners = [
            runner_cls.remote(env, num_envs, rollout_len, seed=seed + i,
                              exploration=exploration, device=self.device)
            for i in range(num_runners)]
        self.iteration = 0
        self._return_window: List[float] = []

    def _put_weights(self):
        """One store write of a snapshot the learner cannot reach."""
        return ray_tpu_torch.put(snapshot(self.params))

    def _broadcast_weights(self, epsilon: Optional[float] = None) -> None:
        """One store write, every runner reads the same copy."""
        ref = self._put_weights()
        kw = {} if epsilon is None else {"epsilon": epsilon}
        ray_tpu_torch.get([r.set_weights.remote(ref, **kw)
                           for r in self.runners], timeout=120)

    def _track_returns(self, returns) -> None:
        if len(returns):
            self._return_window.extend(
                returns.tolist() if hasattr(returns, "tolist")
                else list(returns))
            self._return_window = self._return_window[-RETURN_WINDOW:]

    def _return_mean(self) -> float:
        return float(np.mean(self._return_window)) \
            if self._return_window else float("nan")

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass

    def get_weights(self):
        return self.params

    def set_weights(self, params) -> None:
        self.params = params

    def _base_result(self, *, episodes: int, t0: float,
                     **extra) -> Dict[str, Any]:
        import time
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": self._return_mean(),
            "episodes_this_iter": episodes,
            "time_this_iter_s": round(time.monotonic() - t0, 3),
            **extra,
        }
