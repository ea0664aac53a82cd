"""RLModule — the policy/value network as pure functions over tensors.

The port of ``ray_tpu/rllib/module.py``: a shared tanh MLP torso with policy
and value heads (the default architecture of the reference's catalog for
box-obs/discrete-action), and SAC's squashed-Gaussian actor with twin Q
critics. Parameters are dicts of tensors under the JAX package's key names
(``w0``, ``b0``, ..., ``w_pi``, ``b_pi``, ``w_v``, ``b_v``; ``w_out``,
``b_out``; SAC's ``{"actor", "q1", "q2"}``), so ``convert.from_jax``
carries a JAX module's parameters over as they are.

Randomness comes from an explicit ``torch.Generator`` (the JAX package
takes a PRNG key), and each sampler also takes its noise directly: the
tests feed it the noise that JAX draws from its key, so both packages
sample the same actions.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """fn over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def snapshot(tree):
    """A detached copy of a parameter tree: what a learner hands to its
    runners, which must not see the learner's next update."""
    return tree_map(lambda t: t.detach().clone(), tree)


def _randn(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def _init_torso(generator: torch.Generator, sizes) -> Params:
    """Kaiming-init tanh MLP torso: w{i}/b{i} per hidden layer."""
    params: Params = {}
    for i in range(len(sizes) - 1):
        params[f"w{i}"] = _randn(generator, (sizes[i], sizes[i + 1])) \
            * (2.0 / sizes[i]) ** 0.5
        params[f"b{i}"] = torch.zeros(sizes[i + 1], device=generator.device)
    return params


def _torso_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    n = sum(1 for k in params if k[0] == "w" and k[1:].isdigit())
    for i in range(n):
        x = torch.tanh(x @ params[f"w{i}"] + params[f"b{i}"])
    return x


def init_module(generator: torch.Generator, obs_dim: int, num_actions: int,
                hidden: Tuple[int, ...] = (64, 64)) -> Params:
    """Parameters on ``generator.device``, drawn from ``generator``."""
    sizes = (obs_dim,) + tuple(hidden)
    params = _init_torso(generator, sizes)
    dev = generator.device
    params["w_pi"] = _randn(generator, (sizes[-1], num_actions)) * 0.01
    params["b_pi"] = torch.zeros(num_actions, device=dev)
    params["w_v"] = _randn(generator, (sizes[-1], 1)) * 1.0
    params["b_v"] = torch.zeros(1, device=dev)
    return params


def forward(params: Params, obs: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, D] -> (logits [B, A], value [B])."""
    h = _torso_forward(params, obs)
    logits = h @ params["w_pi"] + params["b_pi"]
    value = (h @ params["w_v"] + params["b_v"])[:, 0]
    return logits, value


def gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise as ``jax.random.gumbel`` draws it:
    -log(-log(u)), u uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))


def sample_actions(params: Params, obs: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None):
    """-> (actions [B] int64, logp [B], value [B]). Gumbel-max sampling,
    which is ``jax.random.categorical``'s rule: argmax(logits + noise), the
    noise Gumbel from ``generator`` unless given."""
    logits, value = forward(params, obs)
    if noise is None:
        noise = gumbel(generator, logits.shape)
    actions = torch.argmax(logits + noise, dim=-1)
    logp = torch.log_softmax(logits, -1).gather(
        1, actions[:, None])[:, 0]
    return actions, logp, value


# ---------------------------------------------------------------------------
# Continuous control (SAC): squashed-Gaussian actor + twin Q critics
# ---------------------------------------------------------------------------

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


def _init_mlp(generator, sizes, out_dim, out_scale=0.01) -> Params:
    params = _init_torso(generator, sizes)
    params["w_out"] = _randn(generator, (sizes[-1], out_dim)) * out_scale
    params["b_out"] = torch.zeros(out_dim, device=generator.device)
    return params


def _mlp_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = _torso_forward(params, x)
    return x @ params["w_out"] + params["b_out"]


def init_sac_module(generator: torch.Generator, obs_dim: int,
                    action_dim: int, hidden: Tuple[int, ...] = (64, 64)):
    """{"actor", "q1", "q2"}: actor emits [mean, log_std] (2*A outputs);
    critics score (obs ++ action) -> scalar."""
    sizes = (obs_dim,) + tuple(hidden)
    qsizes = (obs_dim + action_dim,) + tuple(hidden)
    return {
        "actor": _init_mlp(generator, sizes, 2 * action_dim),
        "q1": _init_mlp(generator, qsizes, 1, out_scale=1.0),
        "q2": _init_mlp(generator, qsizes, 1, out_scale=1.0),
    }


def q_forward(qparams: Params, obs: torch.Tensor,
              action: torch.Tensor) -> torch.Tensor:
    """(obs [B, D], action [B, A]) -> q [B]."""
    return _mlp_forward(qparams, torch.cat([obs, action], dim=-1))[:, 0]


def sample_squashed(actor: Params, obs: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    action_scale: float = 1.0, *,
                    eps: Optional[torch.Tensor] = None):
    """Reparameterized tanh-squashed Gaussian: -> (action [B, A] in
    [-scale, scale], logp [B]) with the tanh log-det correction. ``eps``
    is the standard normal noise, from ``generator`` unless given."""
    out = _mlp_forward(actor, obs)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    if eps is None:
        eps = _randn(generator, mean.shape)
    pre = mean + std * eps
    logp_gauss = (-0.5 * ((pre - mean) / std) ** 2 - log_std
                  - 0.5 * math.log(2 * math.pi)).sum(-1)
    tanh = torch.tanh(pre)
    # log |d tanh/d pre| = log(1 - tanh^2) in its stable form, plus the
    # scale's change of variables
    logp = logp_gauss - (2 * (math.log(2.0) - pre - torch.nn.functional
                              .softplus(-2 * pre))).sum(-1)
    logp = logp - mean.shape[-1] * math.log(action_scale)
    return action_scale * tanh, logp


def greedy_squashed(actor: Params, obs: torch.Tensor,
                    action_scale: float = 1.0) -> torch.Tensor:
    """Deterministic (mean) action for evaluation."""
    mean, _ = torch.chunk(_mlp_forward(actor, obs), 2, dim=-1)
    return action_scale * torch.tanh(mean)
