"""Parameters across the two packages: the JAX parameter tree (leaves that
``numpy.asarray`` accepts: numpy arrays, or JAX arrays, which convert
without this module importing JAX) to the port's dict of tensors, and
back to numpy.

Names, nesting and shapes are the same in both packages (dicts, and
lists such as the MLP's layers), so conversion is leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch.models.llama import resolve_device


def _to_tensor(leaf, device) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: same bits
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    # copy: arrays exported from JAX are read-only views
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(fn: Callable[[Any], Any], tree):
    """fn over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def from_jax(tree, device="cuda"):
    """JAX parameter tree -> the port's tree of tensors on ``device`` (the
    card unless the caller asks for the CPU; raises when there is no
    card), dtypes kept."""
    dev = resolve_device(device)
    return _map(lambda leaf: _to_tensor(leaf, dev), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_numpy(tree):
    """The port's tensor tree -> numpy arrays (host copies). bf16 leaves
    become float32 arrays, which hold every bf16 value exactly (numpy has
    no bf16 of its own); ``jnp.asarray(a, jnp.bfloat16)`` restores them."""
    return _map(_to_numpy, tree)
