"""Llama-family decoder-only transformer — the PyTorch port of
``ray_tpu/models/llama.py``.

The same parameter tree (a dict of tensors, layers stacked on axis 0, the
same names and shapes), the same ``forward(params, tokens, cfg)`` with
``attention="full"``, and the same numerics: fp32 rmsnorm statistics,
fp32 half-split rope, causal softmax in fp32, tied-embedding head that
accumulates and returns fp32 logits. Not in this port yet: remat,
pipeline/ring/ulysses/flash attention, the int8 MLP.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, object]


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; asking for CUDA on a machine without a
    card raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions")
    return dev


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config."""
        base = dict(vocab_size=256, dim=64, n_layers=4, n_heads=8,
                    n_kv_heads=4, ffn_dim=128, rope_theta=10000.0)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, ffn_dim=14336)
        base.update(kw)
        return LlamaConfig(**base)


def init_params(cfg: LlamaConfig, seed: int = 0,
                device="cuda") -> Params:
    """Random parameters with ``init_params``' tree, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed`` (drawing 8B values on
    the host would take minutes). Each stacked leaf is drawn one layer
    at a time, so the fp32 scratch stays one layer's size. The values
    differ from the JAX package's for the same seed; tests carry
    parameters across with ``ray_tpu_torch.convert``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.dim, cfg.n_layers
    hq, hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim
    pd = cfg.param_dtype

    def norm_init(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    def dense(*shape, fan_in=None):
        scale = (fan_in if fan_in is not None else shape[-2]) ** -0.5
        out = torch.empty(shape, dtype=pd, device=dev)
        for part in (out if out.dim() == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=g, device=dev)
                       * scale)
        return out

    return {
        "embed": dense(cfg.vocab_size, d, fan_in=d),
        "layers": {
            "attn_norm": norm_init(L, d),
            "wq": dense(L, d, hq * hd),
            "wk": dense(L, d, hkv * hd),
            "wv": dense(L, d, hkv * hd),
            "wo": dense(L, hq * hd, d),
            "mlp_norm": norm_init(L, d),
            "w_gate": dense(L, d, f),
            "w_up": dense(L, d, f),
            "w_down": dense(L, f, d),
        },
        "final_norm": norm_init(d),
    }


def _rmsnorm(x, w, eps):
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * w.to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding; x: [B, L, H, D_even], positions: [L] or [B, L]."""
    d2 = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, d2, dtype=torch.float32,
                                    device=x.device) / d2)
    ang = positions[..., None].float() * freqs          # [..., L, d2]
    if ang.dim() == 2:  # [L, d2] -> broadcast over batch
        ang = ang[None]
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _full_attention(q, k, v):
    """Causal attention, q/k/v [B, L, H, D] -> [B, L, H, D] in q's dtype.

    As ``ray_tpu.parallel.attention``: q is scaled IN ITS OWN DTYPE (the
    scale itself rounded to that dtype) before the product; products
    accumulate in fp32 (bf16 operands widened exactly to fp32), softmax
    in fp32, probabilities rounded to v's dtype before the PV product."""
    sm_scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype,
                            device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", (q * sm_scale).float(), k.float())
    Lq, Lk = q.shape[1], k.shape[1]
    mask = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def head_logits(x, embed):
    """Tied-embedding head: x [..., d] · embedᵀ -> fp32 logits [..., V].

    Operands in x's dtype, fp32 accumulation AND fp32 output: a
    bf16-output product would round the logits before the argmax and
    flip greedy near-ties. On the card a bf16 embedding is read once as
    bf16 (``out_dtype``); on the CPU bf16 operands widen exactly to fp32.
    """
    w = embed.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w.t()
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, w.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return x.float() @ w.float().t()


def _layer(lp: Params, x, cfg: LlamaConfig, positions):
    """One transformer block; lp leaves have the layer axis removed."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, L, _ = x.shape
    cd = cfg.dtype

    h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = h @ lp["wq"].to(cd)
    k = h @ lp["wk"].to(cd)
    v = h @ lp["wv"].to(cd)
    q = _rope(q.reshape(B, L, hq, hd), positions, cfg.rope_theta)
    k = _rope(k.reshape(B, L, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, L, hkv, hd)
    if hkv != hq:  # GQA: repeat KV groups to full head count
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    o = _full_attention(q, k, v).reshape(B, L, hq * hd)
    x = x + o @ lp["wo"].to(cd)

    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(h @ lp["w_gate"].to(cd))
    up = h @ lp["w_up"].to(cd)
    return x + (gate * up) @ lp["w_down"].to(cd)


def layer_params(params: Params, i: int) -> Params:
    """Layer i's leaves (views into the stacked tensors)."""
    return {name: leaf[i] for name, leaf in params["layers"].items()}


@torch.inference_mode()
def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """tokens [B, L] int -> logits [B, L, vocab] (fp32)."""
    B, L = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(L, device=tokens.device)
    for i in range(cfg.n_layers):
        x = _layer(layer_params(params, i), x, cfg, positions)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return head_logits(x, params["embed"])


def num_params(cfg: LlamaConfig) -> int:
    d, L, f = cfg.dim, cfg.n_layers, cfg.ffn_dim
    hd = cfg.head_dim
    per_layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + cfg.n_heads * hd * d + 3 * d * f + 2 * d)
    return cfg.vocab_size * d + L * per_layer + d
