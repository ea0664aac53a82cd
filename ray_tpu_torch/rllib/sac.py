"""SAC — continuous-control off-policy training (squashed-Gaussian actor,
twin Q critics, automatic entropy temperature).

The port of ``ray_tpu/rllib/sac.py``. The JAX learner runs an iteration's
whole schedule (N minibatches of critic + actor + alpha steps and the
polyak target blend) as one jitted ``lax.scan``; here the same schedule
is a Python loop. One step, in the JAX package's order:

  1. alpha = exp(log alpha), taken once, for the critic target and the
     actor loss;
  2. the critics step toward r + gamma (1 - d) (min target-Q(s', a') -
     alpha logpi(a')), a' from the pre-update actor with the first noise;
  3. the actor loss is taken against the UPDATED critics, with the
     second noise;
  4. the alpha loss uses that actor loss's logpi (the pre-update actor);
  5. the soft target update blends in the updated critics.

Runs on the same TrainerBase/EnvRunner/ReplayBuffer seams as DQN; the
runners sample with exploration="squashed_gaussian".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.env import ENV_REGISTRY
from ray_tpu_torch.rllib.learner import (Adam, params_device, to_device,
                                         tree_unflatten, value_and_grad)
from ray_tpu_torch.rllib.module import (init_sac_module, q_forward,
                                        sample_squashed, snapshot, tree_map)
from ray_tpu_torch.rllib.replay import ReplayBuffer
from ray_tpu_torch.rllib.trainer_base import TrainerBase, check_build
from ray_tpu_torch.train.train_step import param_leaves


class SACLearner:
    """Per minibatch: critic MSE to the entropy-penalized double-Q
    target, reparameterized actor ascent, temperature descent to
    target_entropy, and the polyak target update. ``state`` holds the
    target critics and log alpha; the three ``Adam``s their moments.

    On a CUDA device the step runs as a CUDA graph: the first
    ``GRAPH_WARMUP`` steps of the first update run eagerly on a side
    stream, then one step is captured on static buffers and replayed for
    every later step (the same ops on the same shapes; an eager step is
    hundreds of small launches, each costing more host time than its
    kernel takes)."""

    GRAPH_WARMUP = 3

    def __init__(self, *, lr: float = 3e-4, gamma: float = 0.99,
                 tau: float = 0.005, target_entropy: float = -1.0,
                 action_scale: float = 1.0):
        self.gamma = gamma
        self.tau = tau
        self.target_entropy = target_entropy
        self.action_scale = action_scale
        self.opt_critic = Adam(lr)
        self.opt_actor = Adam(lr)
        self.opt_alpha = Adam(lr)
        self.state = None
        self._graph = None

    def _init_state(self, params):
        critic = {"q1": params["q1"], "q2": params["q2"]}
        log_alpha = torch.zeros((), device=params_device(params))
        self.opt_critic.init(critic)
        self.opt_actor.init(params["actor"])
        self.opt_alpha.init(log_alpha)
        return {"target": critic, "log_alpha": log_alpha}

    def _step(self, params, state, batch, eps_next, eps_actor):
        """One SAC step: -> (params, state, [critic loss, actor loss,
        alpha]), new tensors but for the Adams' moments."""
        scale = self.action_scale
        alpha = torch.exp(state["log_alpha"])
        with torch.no_grad():
            a2, logp2 = sample_squashed(params["actor"], batch["next_obs"],
                                        action_scale=scale, eps=eps_next)
            tq = torch.minimum(
                q_forward(state["target"]["q1"], batch["next_obs"], a2),
                q_forward(state["target"]["q2"], batch["next_obs"], a2))
            nonterminal = 1.0 - batch["dones"].float()
            y = batch["rewards"] + self.gamma * nonterminal * (
                tq - alpha * logp2)

        def critic_loss(critic, _):
            q1 = q_forward(critic["q1"], batch["obs"], batch["actions"])
            q2 = q_forward(critic["q2"], batch["obs"], batch["actions"])
            return ((q1 - y) ** 2 + (q2 - y) ** 2).mean(), None

        critic = {"q1": params["q1"], "q2": params["q2"]}
        closs, _, cgrad = value_and_grad(critic_loss, critic, None)
        critic = self.opt_critic.step(critic, cgrad)

        def actor_loss(actor, _):
            a, logp = sample_squashed(actor, batch["obs"],
                                      action_scale=scale, eps=eps_actor)
            q = torch.minimum(q_forward(critic["q1"], batch["obs"], a),
                              q_forward(critic["q2"], batch["obs"], a))
            return (alpha * logp - q).mean(), logp.detach()

        aloss, logp, agrad = value_and_grad(actor_loss, params["actor"],
                                            None)
        actor = self.opt_actor.step(params["actor"], agrad)

        # d/d(log alpha) of -(log alpha * (logp + target_entropy)).mean()
        tgrad = -(logp + self.target_entropy).mean()
        log_alpha = self.opt_alpha.step(state["log_alpha"], tgrad)

        with torch.no_grad():
            blend = torch._foreach_mul(param_leaves(state["target"]),
                                       1 - self.tau)
            torch._foreach_add_(blend, param_leaves(critic), alpha=self.tau)
        state = {"target": tree_unflatten(state["target"], blend),
                 "log_alpha": log_alpha}
        return ({"actor": actor, "q1": critic["q1"], "q2": critic["q2"]},
                state, torch.stack([closs, aloss, torch.exp(log_alpha)]))

    def update(self, params, batches: Dict[str, np.ndarray],
               generator: Optional[torch.Generator] = None, *,
               noise: Optional[Dict[str, np.ndarray]] = None):
        """batches: arrays stacked [N, batch, ...], the iteration's
        schedule. Step i's two standard normal noises [batch, A] are
        ``noise["next"][i]`` and ``noise["actor"][i]`` when given, else
        drawn from ``generator``."""
        if self.state is None:
            self.state = self._init_state(params)
        dev = params_device(params)
        jb = to_device(batches, tuple(batches), dev)
        if noise is None:
            shape = jb["actions"].shape
            noise = {k: torch.randn(shape, generator=generator, device=dev)
                     for k in ("next", "actor")}
        else:
            noise = to_device(noise, ("next", "actor"), dev)
        steps = [({k: v[i] for k, v in jb.items()}, noise["next"][i],
                  noise["actor"][i]) for i in range(jb["rewards"].shape[0])]
        if dev.type == "cuda":
            params, total = self._run_graphed(params, steps)
        else:
            total = 0.0
            for step in steps:
                params, self.state, m = self._step(params, self.state, *step)
                total = total + m
        m = (total / len(steps)).tolist()
        return params, {"critic_loss": m[0], "actor_loss": m[1],
                        "alpha": m[2]}

    def _run_graphed(self, params, steps):
        """The steps through the captured graph (capturing it first, after
        the warm-up steps, if this shape has none yet); -> (new params,
        the sum of the steps' metrics)."""
        total = 0.0
        shape = tuple(steps[0][0]["obs"].shape)
        if self._graph is None or self._graph.shape != shape:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for step in steps[:self.GRAPH_WARMUP]:
                    params, self.state, m = self._step(params, self.state,
                                                       *step)
                    total = total + m
            torch.cuda.current_stream().wait_stream(side)
            steps = steps[self.GRAPH_WARMUP:]
            if not steps:
                return params, total
            self._graph = _CapturedStep(self._step, params, self.state,
                                        steps[0], shape)
            self.state = self._graph.state
        g = self._graph
        torch._foreach_copy_(param_leaves(g.params), param_leaves(params))
        for step in steps:
            total = total + g.replay(*step)
        return snapshot(g.params), total


class _CapturedStep:
    """``SACLearner._step`` captured once as a CUDA graph. The parameters,
    the learner state and the step's inputs live in static buffers: a
    replay reads them and copies the step's results back into them."""

    def __init__(self, step, params, state, example, shape):
        self.shape = shape
        self.params = snapshot(params)
        self.state = snapshot(state)
        self.inputs = [tree_map(torch.clone, x) for x in example]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            new_params, new_state, self.metrics = step(
                self.params, self.state, *self.inputs)
            torch._foreach_copy_(
                param_leaves(self.params) + param_leaves(self.state),
                param_leaves(new_params) + param_leaves(new_state))

    def replay(self, batch, eps_next, eps_actor) -> torch.Tensor:
        torch._foreach_copy_(param_leaves(self.inputs),
                             param_leaves([batch, eps_next, eps_actor]))
        self.graph.replay()
        return self.metrics.clone()


@dataclasses.dataclass
class SACConfig:
    env: str = "Pendulum-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_length: int = 32
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    buffer_capacity: int = 100_000
    train_batch_size: int = 256
    # near-1:1 update-to-data ratio (SAC's operating point — at 1:16 the
    # critic converges but the policy never moves)
    updates_per_iter: int = 256
    learning_starts: int = 1_000
    target_entropy: float = None   # default: -action_dim
    hidden: tuple = (64, 64)
    seed: int = 0
    # the env runners' device ("cpu", "cuda"); None: the learner's
    runner_device: Optional[str] = None

    def build(self, device="cuda") -> "SAC":
        return SAC(self, device=device)


class SAC(TrainerBase):
    def __init__(self, config: SACConfig, device="cuda"):
        self.config = config
        self.device = check_build(device)
        spec = ENV_REGISTRY[config.env](1)
        if not spec.continuous:
            raise ValueError(f"SAC needs a continuous-action env, "
                             f"{config.env} is discrete")
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.params = init_sac_module(self._gen, spec.observation_dim,
                                      spec.action_dim, config.hidden)
        te = config.target_entropy
        self.learner = SACLearner(
            lr=config.lr, gamma=config.gamma, tau=config.tau,
            target_entropy=float(-spec.action_dim if te is None else te),
            action_scale=float(spec.action_scale))
        self.buffer = ReplayBuffer(config.buffer_capacity,
                                   spec.observation_dim,
                                   seed=config.seed,
                                   action_dim=spec.action_dim)
        self._make_runners(config.env, config.num_env_runners,
                           config.num_envs_per_runner,
                           config.rollout_length, config.seed,
                           exploration="squashed_gaussian")
        self.num_updates = 0

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.monotonic()
        self._broadcast_weights()
        t_sample = time.monotonic()
        batches = ray_tpu_torch.get(
            [r.sample.remote() for r in self.runners], timeout=600)
        t_sample = time.monotonic() - t_sample
        returns: List[float] = []
        for b in batches:
            T, B = b["rewards"].shape
            # s' at a boundary is the PRE-reset obs (auto-reset hid it),
            # and only true failures mask the bootstrap — a time-limit
            # truncation bootstraps through (on Pendulum EVERY done is a
            # truncation, so masking them would teach the critic V=0 at
            # arbitrary states)
            next_obs = np.concatenate([b["obs"][1:], b["last_obs"][None]])
            next_obs = np.where(b["dones"][..., None], b["final_obs"],
                                next_obs)
            terminal = b["dones"] & ~b["truncated"]
            self.buffer.add_batch(
                b["obs"].reshape(T * B, -1),
                b["actions"].reshape(T * B, -1),
                b["rewards"].reshape(T * B),
                terminal.reshape(T * B),
                next_obs.reshape(T * B, -1))
            returns.extend(b["episode_returns"].tolist())
        metrics: Dict[str, float] = {}
        t_learn = time.monotonic()
        if len(self.buffer) >= cfg.learning_starts:
            stack = [self.buffer.sample(cfg.train_batch_size)
                     for _ in range(cfg.updates_per_iter)]
            batched = {k: np.stack([s[k] for s in stack])
                       for k in stack[0]}
            self.params, metrics = self.learner.update(
                self.params, batched, self._gen)
            self.num_updates += cfg.updates_per_iter
        t_learn = time.monotonic() - t_learn
        self._track_returns(returns)
        return self._base_result(
            episodes=len(returns), t0=t0,
            buffer_size=len(self.buffer),
            num_updates=self.num_updates, time_sample_s=t_sample,
            time_learn_s=t_learn, learner=metrics)
