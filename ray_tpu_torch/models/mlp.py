"""Minimal MLP classifier — the PyTorch port of ``ray_tpu/models/mlp.py``
(the Train MVP's model). ``mlp_specs`` waits for the device mesh."""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.models.llama import dense_init, resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 256
    n_hidden: int = 2
    out_dim: int = 10
    dtype: torch.dtype = torch.float32


def mlp_init(cfg: MLPConfig, seed: int = 0, device="cuda"):
    """A list of {"w": [din, dout], "b": [dout]} layers, weights N(0,
    1/din) from a ``torch.Generator`` seeded with ``seed``, biases 0."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dims = [cfg.in_dim] + [cfg.hidden] * cfg.n_hidden + [cfg.out_dim]
    return [{"w": dense_init(g, (din, dout), cfg.dtype, din),
             "b": torch.zeros(dout, dtype=cfg.dtype, device=dev)}
            for din, dout in zip(dims[:-1], dims[1:])]


def mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params, batch):
    """Mean cross-entropy of the logits against integer labels."""
    x, y = batch
    logp = torch.log_softmax(mlp_apply(params, x), dim=-1)
    return -logp.gather(-1, y.long()[:, None]).mean()
