"""Shared attention math of the full, ring and Ulysses paths — the PyTorch
port of ``ray_tpu/parallel/attention.py``.

One copy of the numerically sensitive fp32 softmax, so the parallel
strategies cannot drift apart.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention(q, k, v, sm_scale: Optional[float] = None,
              causal: bool = True) -> torch.Tensor:
    """q/k/v [B, L, H, D] -> [B, L, H, D] fp32.

    As the JAX function: q is scaled IN ITS OWN DTYPE (the scale rounded
    to it); the products take the input dtype's values with fp32
    accumulation (bf16 operands widen exactly to fp32); the softmax runs
    in fp32 and its probabilities are rounded to v's dtype before the PV
    product."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scale = torch.tensor(sm_scale, dtype=q.dtype, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        mask = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def causal_attention(q, k, v, sm_scale: Optional[float] = None
                     ) -> torch.Tensor:
    return attention(q, k, v, sm_scale, causal=True)
