"""Ulysses sequence parallelism: an all-to-all swap of heads and sequence
— the PyTorch port of ``ray_tpu/parallel/ulysses.py``.

The ranks of ``sp`` hold sequence blocks; an all-to-all regathers the
whole sequence while splitting the heads over the axis, full attention
runs locally per head group (``parallel.attention``), and a second
all-to-all restores the sequence split.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.parallel.attention import attention
from ray_tpu_torch.parallel.collectives import alltoall
from ray_tpu_torch.parallel.mesh import axis_size


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: this rank's [B, L_local, H, D] block; H % axis size == 0.
    Causal or not: the all-to-all regathers the WHOLE sequence per head
    group, so the mask is local. Returns [B, L_local, H, D] in q's
    dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n = axis_size(mesh, axis_name)
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses_attention needs heads ({q.shape[2]}) divisible by "
            f"the {axis_name!r} axis size ({n})")
    # [B, L/n, H, D] -> [B, L, H/n, D]: gather the sequence, split heads
    qg, kg, vg = (alltoall(x, mesh, axis_name, split_axis=2, concat_axis=1)
                  for x in (q, k, v))
    og = attention(qg, kg, vg, sm_scale, causal=causal)
    # [B, L, H/n, D] -> [B, L/n, H, D]
    return alltoall(og, mesh, axis_name, split_axis=1,
                    concat_axis=2).to(q.dtype)


def ulysses_attention_sharded(q, k, v, mesh, *, seq_axis: str = "sp",
                              causal: bool = True) -> torch.Tensor:
    """Ulysses on this rank's [B / (dp·fsdp), L / sp, H / tp, D] shard."""
    return ulysses_attention(q, k, v, mesh, seq_axis, causal)
