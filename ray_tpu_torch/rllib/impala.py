"""IMPALA — asynchronous sampling with V-trace off-policy correction.

The port of ``ray_tpu/rllib/impala.py``: env runners sample continuously
with whatever weights they last received, and the learner consumes
rollout batches as they land (wait-any over in-flight sample refs),
correcting for policy lag with V-trace (Espeholt et al. 2018) clipped
importance weights, then pushes fresh weights to that runner only. The
runners sample while the learner updates, so each push is a snapshot
(``module.snapshot``): a runner never reads parameters halfway through an
update.

On a device mesh (``build(mesh=)``) each rank is a process: the first
owns the runners and broadcasts each batch, every rank runs the update on
its own columns of the env axis (V-trace along T, the bootstrap value
from its own ``last_obs`` rows), the loss terms are global sums over the
T·B samples, and the gradients are summed over the ranks before the clip
at 40 (``learner.py``), so every rank holds the same parameters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.env import ENV_REGISTRY
from ray_tpu_torch.rllib.learner import (Adam, env_shards, global_sum,
                                         mesh_loss, params_device,
                                         shard_env, to_device,
                                         value_and_grad)
from ray_tpu_torch.rllib.module import forward, init_module
from ray_tpu_torch.rllib.trainer_base import (TrainerBase, check_build,
                                              from_root)


def vtrace(behavior_logp, target_logp, values, rewards, dones, last_value,
           *, gamma: float, rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace targets and policy-gradient advantages.

    All inputs [T, B] (last_value [B]). Returns (vs [T, B], pg_adv [T, B]):
    vs are the off-policy-corrected value targets, pg_adv the clipped-rho
    advantages for the policy gradient.
    """
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rho = torch.clamp(rhos, max=rho_clip)
    cs = torch.clamp(rhos, max=c_clip)
    nonterminal = 1.0 - dones.float()
    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    # bootstrap past episode ends: the value after a terminal step is 0
    deltas = clipped_rho * (rewards + gamma * v_next * nonterminal - values)
    corrections = torch.empty_like(deltas)
    acc = torch.zeros_like(last_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * cs[t] * nonterminal[t] * acc
        corrections[t] = acc
    vs = values + corrections
    vs_next = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = clipped_rho * (rewards + gamma * vs_next * nonterminal - values)
    return vs, pg_adv


class IMPALALearner:
    """One V-trace actor-critic update (reference:
    rllib/algorithms/impala/impala_learner.py role)."""

    def __init__(self, *, lr: float = 6e-4, gamma: float = 0.99,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 rho_clip: float = 1.0, c_clip: float = 1.0,
                 max_grad_norm: float = 40.0, mesh=None):
        self.optimizer = Adam(lr, max_norm=max_grad_norm)
        self.cfg = dict(gamma=gamma, vf=vf_coeff, ent=entropy_coeff,
                        rho_clip=rho_clip, c_clip=c_clip)
        self.mesh = mesh
        self.initialized = False

    def _loss(self, p, batch):
        """Sums over this rank's [T, B / ranks] samples over the whole
        batch's T·B, summed over the ranks."""
        cfg = self.cfg
        T, B = batch["rewards"].shape
        logits, values = forward(p, batch["obs"].reshape(T * B, -1))
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(
            1, batch["actions"].reshape(T * B)[:, None])[:, 0].reshape(T, B)
        values = values.reshape(T, B)
        # bootstrap value from last_obs under the CURRENT params: the
        # runner's shipped last_value came from weights up to several
        # updates old (the policy lag V-trace corrects)
        _, last_value = forward(p, batch["last_obs"])
        vs, pg_adv = vtrace(
            batch["logp"], logp.detach(), values.detach(), batch["rewards"],
            batch["dones"], last_value.detach(), gamma=cfg["gamma"],
            rho_clip=cfg["rho_clip"], c_clip=cfg["c_clip"])
        size = T * B * env_shards(self.mesh)[0]
        pg_loss = -(pg_adv * logp).sum()
        v_loss = 0.5 * ((values - vs) ** 2).sum()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).sum()
        total = (pg_loss + cfg["vf"] * v_loss - cfg["ent"] * entropy) / size
        return (mesh_loss(total, self.mesh),
                (global_sum(v_loss, self.mesh) / size,
                 global_sum(entropy, self.mesh) / size))

    def update(self, params, batch: Dict[str, np.ndarray]):
        if not self.initialized:
            self.optimizer.init(params)
            self.initialized = True
        jb = to_device(batch, ("obs", "actions", "logp", "rewards", "dones",
                               "last_obs"), params_device(params))
        if self.mesh is not None:
            jb = shard_env(jb, self.mesh, batch_major=("last_obs",))
        loss, (v_loss, entropy), grads = value_and_grad(
            self._loss, params, jb, mesh=self.mesh)
        params = self.optimizer.step(params, grads)
        m = torch.stack([loss, v_loss, entropy]).tolist()
        return params, {"loss": m[0], "v_loss": m[1], "entropy": m[2]}


@dataclasses.dataclass
class IMPALAConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 16
    rollout_length: int = 32
    batches_per_iteration: int = 8
    lr: float = 6e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_clip: float = 1.0
    c_clip: float = 1.0
    hidden: tuple = (64, 64)
    seed: int = 0
    # the env runners' device ("cpu", "cuda"); None: the learner's
    runner_device: Optional[str] = None

    def build(self, device="cuda", mesh=None) -> "IMPALA":
        return IMPALA(self, device=device, mesh=mesh)


class IMPALA(TrainerBase):
    """Async trainer: every runner always has a sample() in flight; the
    learner updates on whichever batch lands first and pushes fresh
    weights to THAT runner only — no global barrier, runners never idle
    (reference: impala.py training_step's async sample+learn loop)."""

    def __init__(self, config: IMPALAConfig, device="cuda", mesh=None):
        self.config = config
        self.device = check_build(device, mesh)
        self.mesh = mesh
        spec = ENV_REGISTRY[config.env](1)
        gen = torch.Generator(device=self.device).manual_seed(config.seed)
        self.params = init_module(gen, spec.observation_dim,
                                  spec.num_actions, config.hidden)
        self.learner = IMPALALearner(
            lr=config.lr, gamma=config.gamma, vf_coeff=config.vf_coeff,
            entropy_coeff=config.entropy_coeff, rho_clip=config.rho_clip,
            c_clip=config.c_clip, mesh=mesh)
        self._make_runners(config.env, config.num_env_runners,
                           config.num_envs_per_runner,
                           config.rollout_length, config.seed)
        # one sample PERMANENTLY in flight per runner — the async core
        # (on a mesh, the first rank's runners)
        self._inflight: Dict[Any, Any] = {}
        if self.is_root:
            self._broadcast_weights()
            self._inflight = {r.sample.remote(): r for r in self.runners}

    def train(self) -> Dict[str, Any]:
        """One iteration = consume batches_per_iteration async batches."""
        t0 = time.monotonic()
        env_steps = 0
        episodes = 0
        t_sample = t_learn = 0.0
        metrics: Dict[str, float] = {}
        for _ in range(self.config.batches_per_iteration):
            t = time.monotonic()
            runner = batch = None
            if self.is_root:
                runner, batch = self._next_batch()
            batch = from_root(batch, self.mesh)
            t_sample += time.monotonic() - t
            t = time.monotonic()
            self.params, metrics = self.learner.update(self.params, batch)
            t_learn += time.monotonic() - t
            env_steps += int(batch["rewards"].size)
            returns = batch["episode_returns"]
            episodes += len(returns)
            self._track_returns(returns)
            # fresh weights to this runner only, then it resamples —
            # other runners keep producing with their (stale) weights
            if runner is not None:
                runner.set_weights.remote(self._put_weights())
                self._inflight[runner.sample.remote()] = runner
        return self._base_result(
            episodes=episodes, t0=t0, env_steps_this_iter=env_steps,
            time_sample_s=t_sample, time_learn_s=t_learn, learner=metrics)

    def _next_batch(self):
        """(runner, batch) of whichever in-flight sample lands first."""
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                      timeout=600)
        if not ready:
            from ray_tpu_torch.exceptions import GetTimeoutError
            raise GetTimeoutError(
                f"no env-runner produced a batch within 600s "
                f"({len(self._inflight)} in flight — runners dead?)")
        runner = self._inflight.pop(ready[0])
        return runner, ray_tpu_torch.get(ready[0])
