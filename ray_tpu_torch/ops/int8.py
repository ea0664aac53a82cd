"""int8 quantization — the PyTorch port of ``ray_tpu/ops/int8.py``.

Symmetric quantization: scale = max|x| / 127 over one axis, in fp32;
values round half to even (``torch.round``, as ``jnp.round``) against the
fp32 scale. KV pages keep per-(token, head) scales, stored as bf16 only
after the values are rounded: that order makes the int8 values identical
to the JAX package's on the same inputs.

``int8_matmul`` is the MLP's dynamic W8A8 product (per-row activation
scales, per-column weight scales, int32 accumulation, fp32 rescale) with
a straight-through backward: exact fp products for both gradients.
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


def _int8_matmul_impl(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xq, xs = _quantize(x, dim=-1)                # xs: [..., 1]
    wq, ws = _quantize(w, dim=0)                 # ws: [1, N]
    K, N = w.shape
    out = torch._int_mm(xq.reshape(-1, K), wq)   # int32 accumulation
    out = out.reshape(*x.shape[:-1], N).float() * xs * ws.reshape(N)
    return out.to(x.dtype)


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_matmul_impl(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.float()
        dx = gf @ w.float().t()                   # g . w^T
        dw = x.float().reshape(-1, x.shape[-1]).t() @ gf.reshape(
            -1, g.shape[-1])                      # x^T . g over every row
        return dx.to(x.dtype), dw.to(w.dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with both operands dynamically quantized to
    int8 (per-row scales for x, per-column for w, over K), int32
    accumulation, fp32 rescale; returns x's dtype. Differentiable through
    a straight-through backward (exact fp32 transpose products)."""
    return _Int8Matmul.apply(x, w)
