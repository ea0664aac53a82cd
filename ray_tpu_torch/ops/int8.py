"""int8 KV-page quantization — the PyTorch port of the KV half of
``ray_tpu/ops/int8.py`` (``int8_matmul`` comes with the training slice).

Symmetric per-(token, head) quantization: scale = max|x| / 127 over the
head_dim axis, in fp32; values round half to even (``torch.round``, as
``jnp.round``) against the fp32 scale, and only then is the scale stored
as bf16. Keeping that order makes the int8 values identical to the JAX
package's on the same inputs.
"""

from __future__ import annotations

import torch

#: dtype of the KV-page scale arrays (bf16: their footprint decides the
#: int8 capacity win; their rounding error is second order).
KV_SCALE_DTYPE = torch.bfloat16


def _quantize(x: torch.Tensor, dim: int):
    """Symmetric int8 quantization along ``dim``: (q_int8, fp32 scale with
    size 1 on ``dim``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv(x: torch.Tensor):
    """x [..., D] -> (q int8 [..., D], scale KV_SCALE_DTYPE [...])."""
    q, scale = _quantize(x, dim=-1)
    return q, scale[..., 0].to(KV_SCALE_DTYPE)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_kv: q int8 [..., D], scale [...] -> [..., D]."""
    return q.to(dtype) * scale.to(dtype)[..., None]
