"""Parameters across the two packages: the JAX parameter tree (leaves that
``numpy.asarray`` accepts: numpy arrays, or JAX arrays, which convert
without this module importing JAX) to the port's dict of tensors, and
back to numpy.

Names, nesting and shapes are the same in both packages
(``models/llama.py: init_params``), so conversion is leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict

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


def from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """JAX parameter tree -> the port's {name: tensor} tree on ``device``
    (the card unless the caller asks for the CPU; raises when there is
    no card), dtypes kept."""
    dev = resolve_device(device)
    return {k: from_jax(v, dev) if isinstance(v, dict)
            else _to_tensor(v, dev) for k, v in tree.items()}


def to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tensor tree -> numpy arrays (host copies). bf16 leaves
    become float32 arrays, which hold every bf16 value exactly (numpy has
    no bf16 of its own); ``jnp.asarray(a, jnp.bfloat16)`` restores them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = to_numpy(v)
        else:
            t = v.detach().cpu()
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out
