"""Adafactor — what ``optax.adafactor(learning_rate)`` computes at its
defaults (optax 0.2.6, ``optax/_src/alias.py`` ``adafactor``,
``optax/_src/factorized.py``), as a ``torch.optim.Optimizer``. The JAX
package's ``bench.py`` trains with it.

The chain, in optax's order, for each parameter leaf (one tensor: a
stacked ``[n_layers, ...]`` leaf takes its RMS over all layers at once,
as optax does):

  1. ``scale_by_factored_rms``: second moments of ``g² + 1e-30`` decayed
     by ``1 - (t + 1)^-0.8`` (t counted from 0 before the update). A leaf
     whose second-largest dim is at least 128 keeps them factored over
     its two largest dims (a row and a column mean: ``v_row`` has the
     largest dim removed, ``v_col`` the second largest); any other leaf
     keeps a full ``v``;
  2. ``clip_by_block_rms(1.0)``: the update divided by max(1, its RMS);
  3. the learning rate;
  4. ``scale_by_param_block_rms``: times max(RMS of the parameter, 1e-3);
  5. the sign flip of gradient descent.

No momentum and no weight decay (optax's defaults). Plain torch ops: optax
computes it outside any Pallas kernel.

A parameter that is one rank's shard of a leaf on a device mesh (it
carries ``shard_info``: ``train_step.local_shard``) is updated as the
global leaf would be: the factored dims are chosen on the global shape,
and the row and column means and the RMS of the update and of the
parameter are reduced over the mesh axes that shard the dims they run
over (the shards are equal).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_PARAM_SCALE = 1e-3


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second-largest and the largest dim of ``shape``,
    ties broken as numpy's argsort breaks them (optax ``_factored_dims``),
    or None when the leaf keeps a full second moment."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _group(p, axes_of):
    """The process group over the mesh axes ``axes_of(shard_info)`` of a
    sharded parameter, or None (a whole tensor, or axes of one rank)."""
    info = getattr(p, "shard_info", None)
    if info is None:
        return None
    from ray_tpu_torch.parallel.mesh import axis_group
    return axis_group(info.mesh, axes_of(info))


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(x, group=group)
    return x


def _mean(x: torch.Tensor, dim: int, group, keepdim=False) -> torch.Tensor:
    """Mean over ``dim``, whose shards (equal) lie on ``group``."""
    m = x.mean(dim=dim, keepdim=keepdim)
    if group is None:
        return m
    import torch.distributed as dist
    return _all_reduce(m, group).div_(dist.get_world_size(group))


def _rms(x: torch.Tensor, group=None, numel=None) -> torch.Tensor:
    """RMS of the whole leaf of ``numel`` values, ``x`` its shard on
    ``group`` (None: ``x`` is the whole leaf)."""
    if group is None:
        return torch.linalg.vector_norm(x) / (numel or x.numel()) ** 0.5
    sq = _all_reduce(torch.linalg.vector_norm(x) ** 2, group)
    return sq.sqrt() / numel ** 0.5


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)``. State per parameter: ``step`` (the count
    of updates so far, an fp32 CPU tensor), and ``v_row`` and ``v_col``
    or ``v`` in the parameter's dtype."""

    def __init__(self, params, lr: float = 1e-3):
        if lr < 0.0:
            raise ValueError(f"invalid learning rate {lr}")
        super().__init__(params, {"lr": lr})

    @staticmethod
    def _global_shape(p: torch.Tensor):
        info = getattr(p, "shard_info", None)
        return tuple(info.global_shape if info else p.shape)

    def state_dims(self, p: torch.Tensor, name: str) -> Tuple[int, ...]:
        """The dims of ``p`` that its state ``name`` keeps, in order: none
        for ``step``, all for ``v``, all but the largest (``v_row``) or
        the second largest (``v_col``) of the factored dims
        (``train_step`` lays the state of a sharded ``p`` out by them)."""
        if name == "step":
            return ()
        dims = factored_dims(self._global_shape(p))
        drop = {"v": None, "v_row": dims and dims[1],
                "v_col": dims and dims[0]}[name]
        return tuple(d for d in range(p.dim()) if d != drop)

    def _init_state(self, p: torch.Tensor) -> dict:
        state = {"step": torch.tensor(0.0)}
        dims = factored_dims(self._global_shape(p))
        if dims is None:
            state["v"] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            shape = list(p.shape)
            state["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
            state["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, group["lr"])
        return loss

    def _update(self, p: torch.Tensor, g: torch.Tensor, lr: float) -> None:
        state = self.state[p]
        if not state:
            state.update(self._init_state(p))
        # optax computes the decay in fp32 from the count before the update
        rho = float(1.0 - (state["step"] + 1.0) ** -DECAY_RATE)
        grad_sqr = g * g
        grad_sqr.add_(EPS)
        dims = factored_dims(self._global_shape(p))
        if dims is not None:
            d1, d0 = dims
            g0 = _group(p, lambda i: i.dim_axes(d0))
            g1 = _group(p, lambda i: i.dim_axes(d1))
            v_row, v_col = state["v_row"], state["v_col"]
            v_row.mul_(rho).add_(_mean(grad_sqr, d0, g0), alpha=1.0 - rho)
            v_col.mul_(rho).add_(_mean(grad_sqr, d1, g1), alpha=1.0 - rho)
            del grad_sqr
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / _mean(v_row, reduced_d1, g1, keepdim=True)
                          ).pow_(-0.5)
            update = g * row_factor.unsqueeze(d0)
            update.mul_(v_col.pow(-0.5).unsqueeze(d1))
        else:
            v = state["v"]
            v.mul_(rho).add_(grad_sqr, alpha=1.0 - rho)
            del grad_sqr
            update = g * v.pow(-0.5)
        # block-RMS clip, the learning rate, the parameter's RMS scale and
        # the descent sign, as one factor on the update
        whole = _group(p, lambda i: i.sharded_axes)
        numel = int(np.prod(self._global_shape(p)))
        denom = torch.clamp(_rms(update, whole, numel) / CLIPPING_THRESHOLD,
                            min=1.0)
        scale = torch.clamp(_rms(p, whole, numel), min=MIN_PARAM_SCALE)
        update.mul_(lr * scale / denom)
        p.sub_(update)
        state["step"] += 1.0
