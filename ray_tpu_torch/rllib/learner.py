"""PPO Learner — GAE + clipped PPO over shuffled minibatch epochs.

The port of ``ray_tpu/rllib/learner.py``. The JAX learner is one jitted
program (``lax.scan`` over epochs and minibatches); here the same schedule
runs as Python loops of torch ops on the parameters' device. Parameters
stay a dict of tensors; an update returns new tensors and never writes the
ones it was given, as the JAX update returns new arrays.

``Adam`` is optax's ``chain(clip_by_global_norm(max_norm), adam(lr))``
(or plain ``adam(lr)`` with no ``max_norm``), which every learner of this
package steps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.module import forward, tree_map
from ray_tpu_torch.train.train_step import global_norm, param_leaves


def tree_unflatten(tree, leaves: Sequence[torch.Tensor]):
    """The inverse of ``param_leaves``: ``leaves`` (in its order) put back
    into the structure of ``tree``, dict key order kept."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return next(it)

    return build(tree)


def value_and_grad(loss_fn: Callable[..., Tuple[torch.Tensor, Any]],
                   params, *args):
    """(loss, aux, grads) of ``loss_fn(params, *args) -> (loss, aux)``,
    grads a tree like ``params`` (``jax.value_and_grad(has_aux=True)``)."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, aux = loss_fn(p, *args)
    # a leaf the loss does not reach (DQN's value head) gets zeros, as in JAX
    grads = torch.autograd.grad(loss, param_leaves(p), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), aux, tree_unflatten(params, grads)


class Adam:
    """optax ``adam(lr)`` at its defaults (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, bias-corrected), after optax
    ``clip_by_global_norm(max_norm)`` when ``max_norm`` is given: a
    gradient tree whose global norm g reaches ``max_norm`` becomes
    t / g * max_norm. ``step`` returns new parameters; the moments and
    the step count are this object's state, on the parameters' device
    (no host read, so a step can be captured in a CUDA graph)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, max_norm: Optional[float] = None):
        self.lr = lr
        self.max_norm = max_norm
        self.count: Optional[torch.Tensor] = None
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params) -> None:
        leaves = param_leaves(params)
        # fp32, as optax's bias corrections are: 1 - fp32(b)^count
        self.count = torch.zeros((), device=leaves[0].device)
        self.mu = [torch.zeros_like(t) for t in leaves]
        self.nu = [torch.zeros_like(t) for t in leaves]

    @torch.no_grad()
    def step(self, params, grads):
        p, g = param_leaves(params), list(param_leaves(grads))
        if self.max_norm is not None:
            norm = global_norm(g)
            keep = norm < self.max_norm
            g = [torch.where(keep, t, t / norm * self.max_norm) for t in g]
        self.count.add_(1)
        torch._foreach_mul_(self.mu, self.B1)
        torch._foreach_add_(self.mu, g, alpha=1 - self.B1)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - self.B2)
        mu_hat = torch._foreach_div(self.mu, 1 - torch.pow(self.B1,
                                                           self.count))
        denom = torch._foreach_div(self.nu, 1 - torch.pow(self.B2,
                                                          self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        return tree_unflatten(params, torch._foreach_add(
            p, torch._foreach_div(mu_hat, denom), alpha=-self.lr))


def compute_gae(rewards, values, dones, last_value, *,
                gamma: float, lam: float):
    """[T, B] tensors -> (advantages [T, B], returns [T, B]), by the
    reverse recursion of the JAX package's ``lax.scan``."""
    nonterminal = 1.0 - dones.float()
    advs = torch.empty_like(values)
    adv, v_next = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next * nonterminal[t] - values[t]
        adv = delta + gamma * lam * nonterminal[t] * adv
        advs[t] = adv
        v_next = values[t]
    return advs, advs + values


def params_device(params) -> torch.device:
    return param_leaves(params)[0].device


def to_device(batch: Dict[str, np.ndarray], keys, device) -> Dict[str, Any]:
    """Host arrays -> tensors on ``device``; integer actions become int64,
    the index type torch takes (the envs make int32)."""
    out = {}
    for k in keys:
        t = torch.tensor(np.asarray(batch[k]), device=device)
        out[k] = t.long() if k == "actions" and not t.is_floating_point() \
            else t
    return out


class PPOLearner:
    def __init__(self, *, lr: float = 3e-4, gamma: float = 0.99,
                 gae_lambda: float = 0.95, clip: float = 0.2,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 num_epochs: int = 4, minibatches: int = 4,
                 max_grad_norm: float = 0.5):
        self.cfg = dict(gamma=gamma, lam=gae_lambda, clip=clip,
                        vf=vf_coeff, ent=entropy_coeff,
                        epochs=num_epochs, minibatches=minibatches)
        self.optimizer = Adam(lr, max_norm=max_grad_norm)
        self.initialized = False

    def init(self, params) -> None:
        self.optimizer.init(params)
        self.initialized = True

    def _loss(self, p, mb):
        clip, vf, ent = self.cfg["clip"], self.cfg["vf"], self.cfg["ent"]
        logits, value = forward(p, mb["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(1, mb["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - mb["logp_old"])
        surr = torch.minimum(
            ratio * mb["adv"],
            torch.clamp(ratio, 1 - clip, 1 + clip) * mb["adv"])
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        v_loss = 0.5 * ((value - mb["ret"]) ** 2).mean()
        return -surr.mean() + vf * v_loss - ent * entropy, (v_loss, entropy)

    def update(self, params, batch: Dict[str, np.ndarray],
               generator: Optional[torch.Generator] = None, *,
               perms: Optional[Sequence] = None
               ) -> Tuple[Any, Dict[str, float]]:
        """One PPO update from a host-side trajectory batch. Each epoch
        walks the flattened batch in the order of one permutation: row e
        of ``perms`` [epochs, T*B] when given, else ``torch.randperm``
        from ``generator``."""
        if not self.initialized:
            self.init(params)
        cfg = self.cfg
        dev = params_device(params)
        b = to_device(batch, ("obs", "actions", "logp", "values",
                              "rewards", "dones", "last_value"), dev)
        advs, rets = compute_gae(b["rewards"], b["values"], b["dones"],
                                 b["last_value"], gamma=cfg["gamma"],
                                 lam=cfg["lam"])
        T, B = b["rewards"].shape
        N = T * B
        flat = {
            "obs": b["obs"].reshape(N, -1),
            "actions": b["actions"].reshape(N),
            "logp_old": b["logp"].reshape(N),
            "adv": advs.reshape(N),
            "ret": rets.reshape(N),
        }
        # jnp.std: no Bessel correction
        flat["adv"] = (flat["adv"] - flat["adv"].mean()) / (
            flat["adv"].std(correction=0) + 1e-8)
        mb_size = N // cfg["minibatches"]
        losses = []
        for e in range(cfg["epochs"]):
            perm = (torch.tensor(np.asarray(perms[e]), device=dev).long()
                    if perms is not None else
                    torch.randperm(N, generator=generator, device=dev))
            idxs = perm[:cfg["minibatches"] * mb_size].reshape(
                cfg["minibatches"], mb_size)
            for idx in idxs:
                mb = {k: v[idx] for k, v in flat.items()}
                loss, _, grads = value_and_grad(self._loss, params, mb)
                params = self.optimizer.step(params, grads)
                losses.append(loss)
        return params, {"loss": float(torch.stack(losses).mean())}
