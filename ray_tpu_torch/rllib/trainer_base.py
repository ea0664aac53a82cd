"""Shared trainer scaffold for the algorithm classes.

The port of ``ray_tpu/rllib/trainer_base.py``: runner-pool construction,
weight broadcast, the episode-return window and teardown. The runners
sample on the config's ``runner_device``, the learner's device unless it
names another; in cluster mode a runner is a worker process, and weights
reach it as CPU tensors (``core/serialization.py``) that it moves to its
device. Weights go out as a detached snapshot: local mode stores values
by reference, and torch tensors, unlike JAX arrays, can change under a
runner that holds them.

On a device mesh (``build(mesh=)``: PPO, IMPALA and BC) every rank is a
process that builds the algorithm, as ``TorchTrainer``'s loop does. Where
the JAX package has one controller holding the whole batch, here the
mesh's first rank owns the runners and broadcasts what they sample (and
PPO's permutations) over the mesh's group (``from_root``); every rank
builds the same parameters from the config's seed, runs the same update
and so holds the same parameters, and the first rank sends the weights
to the runners."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.module import snapshot

RETURN_WINDOW = 100


def check_build(device, mesh=None) -> torch.device:
    """The device an algorithm's ``build`` runs on: ``device``, which a
    mesh (a ``DeviceMesh`` from ``parallel.mesh.build_mesh``) must have
    the type of."""
    if mesh is not None and not (hasattr(mesh, "device_type")
                                 and hasattr(mesh, "get_rank")):
        raise ValueError(f"build(mesh=...) takes a torch DeviceMesh "
                         f"(parallel.mesh.build_mesh), not a "
                         f"{type(mesh).__name__}")
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {dev.type} learner on a {mesh.device_type} "
                         f"mesh: build on the mesh's device type")
    return dev


def mesh_root(mesh) -> int:
    """The global rank of the mesh's first rank."""
    return int(mesh.mesh.flatten()[0])


def from_root(value, mesh):
    """``value`` as the mesh's first rank holds it, on every rank (a
    pickled broadcast over the mesh's group); as is without a mesh or on
    a mesh of one rank. Pass host values (numpy, lists): a tensor would
    be unpickled on the device it came from."""
    from ray_tpu_torch.parallel.mesh import axis_group
    group = None if mesh is None else axis_group(
        mesh, tuple(mesh.mesh_dim_names))
    if group is None:
        return value
    import torch.distributed as dist
    box = [value]
    dist.broadcast_object_list(box, src=mesh_root(mesh), group=group)
    return box[0]


class TrainerBase:
    """Runner-pool construction, weight broadcast, episode-return window,
    and teardown — the parts every algorithm shares."""

    runners: List[Any]
    params: Any
    device: torch.device
    config: Any
    mesh: Any = None

    @property
    def is_root(self) -> bool:
        """Whether this rank owns the runners: always without a mesh."""
        return self.mesh is None or self.mesh.get_rank() == mesh_root(
            self.mesh)

    def _make_runners(self, env: str, num_runners: int, num_envs: int,
                      rollout_len: int, seed: int,
                      exploration: str = "categorical") -> None:
        self.iteration = 0
        self._return_window: List[float] = []
        self.runners = []
        if not self.is_root:
            return
        runner_cls = ray_tpu_torch.remote(num_cpus=1)(EnvRunner)
        device = self.device if self.config.runner_device is None \
            else resolve_device(self.config.runner_device)
        self.runners = [
            runner_cls.remote(env, num_envs, rollout_len, seed=seed + i,
                              exploration=exploration, device=device)
            for i in range(num_runners)]

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
