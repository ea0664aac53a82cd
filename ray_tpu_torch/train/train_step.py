"""Train-step builder — the PyTorch port of ``ray_tpu/train/train_step.py``
(one card; ``shard_params`` / ``shard_batch`` come with the distributed
slice).

Where the JAX step is a pure function that returns new parameters and
optimizer state, this one updates the parameter tensors IN PLACE (the
optimizer steps them) and returns the same objects; gradients live only
between the backward and the update.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a (nested) parameter dict or list, in the order JAX
    flattens them: a dict by sorted key, a list in order, depth first."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, list):
        return [leaf for p in params for leaf in param_leaves(p)]
    return [leaf for key in sorted(params) for leaf in
            param_leaves(params[key])]


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all tensors together, in fp32 (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    optimizer: Callable[[List[torch.Tensor]],
                                        torch.optim.Optimizer]):
    """Build (init_fn, step_fn).

    loss_fn(params, batch) -> scalar loss. optimizer(leaves) builds a
    ``torch.optim.Optimizer`` over the list of parameter leaves (e.g.
    ``lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4)``, which
    is ``optax.adamw(1e-3)``). ``init_fn(params)`` marks the leaves as
    requiring grad and returns the optimizer (the optimizer state);
    ``step_fn(params, opt_state, batch)`` returns
    ``(params, opt_state, {"loss", "grad_norm"})``, both values 0-dim
    tensors on the parameters' device (read them when needed: reading
    waits for the card).
    """

    def init_fn(params) -> torch.optim.Optimizer:
        leaves = param_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        return optimizer(leaves)

    def step_fn(params, opt_state: torch.optim.Optimizer, batch):
        loss = loss_fn(params, batch)
        loss.backward()
        grads = [leaf.grad for leaf in param_leaves(params)]
        gnorm = global_norm(grads)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        metrics: Dict[str, torch.Tensor] = {"loss": loss.detach(),
                                            "grad_norm": gnorm}
        return params, opt_state, metrics

    return init_fn, step_fn
