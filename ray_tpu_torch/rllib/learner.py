"""PPO Learner — GAE + clipped PPO over shuffled minibatch epochs.

The port of ``ray_tpu/rllib/learner.py``. The JAX learner is one jitted
program (``lax.scan`` over epochs and minibatches); here the same schedule
runs as Python loops of torch ops on the parameters' device. Parameters
stay a dict of tensors; an update returns new tensors and never writes the
ones it was given, as the JAX update returns new arrays.

``Adam`` is optax's ``chain(clip_by_global_norm(max_norm), adam(lr))``
(or plain ``adam(lr)`` with no ``max_norm``), which every learner of this
package steps.

On a device mesh (``mesh=``, a ``DeviceMesh`` from
``parallel.mesh.build_mesh``) every rank is a process holding the same
parameters and the whole batch, and the update is the unsharded one: the
env axis (dim 1 of ``[T, B, ...]``, dim 0 of ``last_value``) is sharded
over ``("dp", "fsdp")`` with ``train.shard_batch``, GAE runs along T on
each rank's own columns, the advantages are normalised with all-reduced
sums over all T·B samples, every rank walks the same permutations (a
minibatch's indices fall on the ranks in unequal shares), each minibatch
loss is a global sum over its samples divided by the minibatch size
(``collectives.loss_mean``), and the gradients are summed over the ranks
(``train_step.reduce_gradients``) before the global-norm clip, so every
rank takes the same Adam step. The unsharded path runs the same sums.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel.collectives import allreduce, loss_mean
from ray_tpu_torch.parallel.mesh import P, axis_index, axis_size
from ray_tpu_torch.rllib.module import forward, tree_map
from ray_tpu_torch.train.train_step import (ShardInfo, global_norm,
                                            param_leaves, reduce_gradients,
                                            shard_batch)

#: the mesh axes a learner shards the env axis over
DATA_AXES = ("dp", "fsdp")


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
                   params, *args, mesh=None):
    """(loss, aux, grads) of ``loss_fn(params, *args) -> (loss, aux)``,
    grads a tree like ``params`` (``jax.value_and_grad(has_aux=True)``).
    With a mesh the parameters are replicated on every rank: each leaf's
    gradient is summed over the ranks (``reduce_gradients``)."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, aux = loss_fn(p, *args)
    leaves = param_leaves(p)
    # a leaf the loss does not reach (DQN's value head) gets zeros, as in JAX
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    if mesh is not None:
        from torch.distributed.tensor import Replicate
        for t, g in zip(leaves, grads):
            t.grad = g
            t.shard_info = ShardInfo(mesh, tuple(
                Replicate() for _ in range(mesh.ndim)), tuple(t.shape))
        reduce_gradients(leaves)
        grads = [t.grad for t in leaves]
    return loss.detach(), aux, tree_unflatten(params, grads)


def env_shards(mesh) -> Tuple[int, int]:
    """(ranks the env axis is split over, this rank's shard index): the
    product of the mesh's dp and fsdp axes, dp major; (1, 0) without a
    mesh."""
    return (axis_size(mesh, DATA_AXES),
            axis_index(mesh, "dp") * axis_size(mesh, "fsdp")
            + axis_index(mesh, "fsdp"))


def shard_env(tensors: Dict[str, torch.Tensor], mesh, batch_major=()):
    """This rank's columns of each ``[T, B, ...]`` tensor (and rows of
    each ``[B, ...]`` one named in ``batch_major``): ``shard_batch`` over
    ``DATA_AXES``, its local shard. B must split into equal shares."""
    n, _ = env_shards(mesh)
    out = {}
    for k, t in tensors.items():
        dim = 0 if k in batch_major else 1
        if t.shape[dim] % n:
            raise ValueError(f"{k}: {t.shape[dim]} envs do not split into "
                             f"{n} equal shards over {DATA_AXES}")
        spec = P(DATA_AXES) if dim == 0 else P(None, DATA_AXES)
        out[k] = shard_batch(t, mesh, spec).to_local()
    return out


def global_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the ranks of ``DATA_AXES`` (no gradient)."""
    return allreduce(x.detach(), mesh, DATA_AXES)


def local_rows(idx: torch.Tensor, B: int, Bl: int, col0: int):
    """The rows of this rank's flattened ``[T, Bl]`` shard holding the
    samples ``idx`` of the flattened ``[T, B]`` batch that fall in its
    columns ``col0 .. col0 + Bl``, in ``idx``'s order."""
    col = idx % B
    idx = idx[(col >= col0) & (col < col0 + Bl)]
    return idx // B * Bl + (idx % B - col0)


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
                 max_grad_norm: float = 0.5, mesh=None):
        self.cfg = dict(gamma=gamma, lam=gae_lambda, clip=clip,
                        vf=vf_coeff, ent=entropy_coeff,
                        epochs=num_epochs, minibatches=minibatches)
        self.optimizer = Adam(lr, max_norm=max_grad_norm)
        self.mesh = mesh
        self.initialized = False

    def init(self, params) -> None:
        self.optimizer.init(params)
        self.initialized = True

    def _loss(self, p, mb, mb_size: int):
        """The minibatch's loss: sums over this rank's samples of it,
        over the whole minibatch's size, summed over the ranks."""
        clip, vf, ent = self.cfg["clip"], self.cfg["vf"], self.cfg["ent"]
        logits, value = forward(p, mb["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(1, mb["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - mb["logp_old"])
        surr = torch.minimum(
            ratio * mb["adv"],
            torch.clamp(ratio, 1 - clip, 1 + clip) * mb["adv"])
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).sum()
        v_loss = 0.5 * ((value - mb["ret"]) ** 2).sum()
        total = (-surr.sum() + vf * v_loss - ent * entropy) / mb_size
        return mesh_loss(total, self.mesh), None

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
        cfg, mesh = self.cfg, self.mesh
        dev = params_device(params)
        b = to_device(batch, ("obs", "actions", "logp", "values",
                              "rewards", "dones", "last_value"), dev)
        n, shard = env_shards(mesh)
        if mesh is not None:
            b = shard_env(b, mesh, batch_major=("last_value",))
        advs, rets = compute_gae(b["rewards"], b["values"], b["dones"],
                                 b["last_value"], gamma=cfg["gamma"],
                                 lam=cfg["lam"])
        T, Bl = b["rewards"].shape
        B, N = Bl * n, T * Bl * n
        flat = {
            "obs": b["obs"].reshape(T * Bl, -1),
            "actions": b["actions"].reshape(T * Bl),
            "logp_old": b["logp"].reshape(T * Bl),
            "adv": advs.reshape(T * Bl),
            "ret": rets.reshape(T * Bl),
        }
        # over all N samples, no Bessel correction (jnp.std)
        adv = flat["adv"]
        mean = global_sum(adv.sum(), mesh) / N
        std = (global_sum(((adv - mean) ** 2).sum(), mesh) / N).sqrt()
        flat["adv"] = (adv - mean) / (std + 1e-8)
        mb_size = N // cfg["minibatches"]
        losses = []
        for e in range(cfg["epochs"]):
            perm = (torch.tensor(np.asarray(perms[e]), device=dev).long()
                    if perms is not None else
                    torch.randperm(N, generator=generator, device=dev))
            idxs = perm[:cfg["minibatches"] * mb_size].reshape(
                cfg["minibatches"], mb_size)
            for idx in idxs:
                rows = idx if n == 1 else local_rows(idx, B, Bl, shard * Bl)
                mb = {k: v[rows] for k, v in flat.items()}
                loss, _, grads = value_and_grad(self._loss, params, mb,
                                                mb_size, mesh=mesh)
                params = self.optimizer.step(params, grads)
                losses.append(loss)
        return params, {"loss": float(torch.stack(losses).mean())}


def mesh_loss(total: torch.Tensor, mesh) -> torch.Tensor:
    """A loss whose terms are sums over this rank's samples divided by the
    whole batch's size, summed over the ranks of ``DATA_AXES``: the value
    every rank holds, and each rank's backward its own terms' share (the
    ranks' gradients sum to the loss's). ``loss_mean`` means over the
    ranks, hence the factor; ``total`` as is without a mesh."""
    n, _ = env_shards(mesh)
    return loss_mean(total * n if n > 1 else total, mesh, DATA_AXES)
