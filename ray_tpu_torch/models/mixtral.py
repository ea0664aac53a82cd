"""Mixtral-family sparse-MoE decoder transformer — the PyTorch port of
``ray_tpu/models/mixtral.py``.

The same parameter tree (layers stacked on axis 0, the expert leaves
[L, E, ...]), the same ``forward(params, tokens, cfg)`` and ``loss_fn``
(next-token NLL + ``aux_loss_coef`` x the Switch load-balance term), and
the same numerics: Llama's attention block (``models/llama.py``, plain
full attention, as the JAX Mixtral has no other) and the top-k routed
SwiGLU experts of ``parallel/moe.py``, computed on the routed tokens
only. The JAX layer routes twice, once inside ``moe_ffn`` and once for
the aux term; this one routes once and uses the same numbers for both.

Not in this port yet: ``param_specs`` and the fsdp-overlap loss, and the
expert-parallel dispatch (they need a device mesh).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import (_attention, _full_attention,
                                        _nll_mean, _rmsnorm,
                                        checkpoint_name, dense_init,
                                        head_logits, remat_layer,
                                        resolve_device, unstack_layers)
from ray_tpu_torch.parallel.moe import _router_probs, _routed_sum, _top_k

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    n_experts: int = 8
    top_k: int = 2
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    aux_loss_coef: float = 0.01
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights
    remat: bool = True
    remat_policy: str = "full"     # full | dots | dots_no_batch | selective
    fsdp_overlap: bool = False     # needs a device mesh: True raises

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**kw) -> "MixtralConfig":
        """Test-scale config."""
        base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=8,
                    n_kv_heads=4, ffn_dim=96, n_experts=4, top_k=2,
                    rope_theta=10000.0)
        base.update(kw)
        return MixtralConfig(**base)

    @staticmethod
    def mixtral_8x7b(**kw) -> "MixtralConfig":
        base = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, ffn_dim=14336, n_experts=8, top_k=2)
        base.update(kw)
        return MixtralConfig(**base)


def init_params(cfg: MixtralConfig, seed: int = 0,
                device="cuda") -> Params:
    """Random parameters with ``init_params``' tree, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``, one layer's (or one
    expert's) matrix at a time. The values differ from the JAX package's
    for the same seed; tests carry parameters across with
    ``ray_tpu_torch.convert``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, L, E, f = cfg.dim, cfg.n_layers, cfg.n_experts, cfg.ffn_dim
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.param_dtype

    def dense(*shape, fan_in):
        return dense_init(g, shape, pd, fan_in)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    return {
        "embed": dense(cfg.vocab_size, d, fan_in=d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": dense(L, d, hq * hd, fan_in=d),
            "wk": dense(L, d, hkv * hd, fan_in=d),
            "wv": dense(L, d, hkv * hd, fan_in=d),
            "wo": dense(L, hq * hd, d, fan_in=hq * hd),
            "moe_norm": ones(L, d),
            "router": dense(L, d, E, fan_in=d),
            "w_gate": dense(L, E, d, f, fan_in=d),
            "w_in": dense(L, E, d, f, fan_in=d),
            "w_out": dense(L, E, f, d, fan_in=f),
        },
        "final_norm": ones(d),
    }


def _aux_loss(router_probs: torch.Tensor, topk_idx: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-transformer load-balance term: E · Σ_e f_e · P_e, f_e the
    fraction of routed assignments to expert e (no gradient) and P_e the
    mean router probability."""
    f = F.one_hot(topk_idx, n_experts).float().mean(dim=(0, 1))
    p = router_probs.mean(dim=0)
    return n_experts * (f * p).sum()


def _layer(lp: Params, x, cfg: MixtralConfig, positions):
    """One block; lp leaves have the layer axis removed. Returns the new
    x and the layer's aux term."""
    B, L, d = x.shape
    x = _attention(lp, x, cfg, positions, _full_attention)
    h = _rmsnorm(x, lp["moe_norm"], cfg.norm_eps).reshape(B * L, d)
    probs = _router_probs(lp["router"], h)
    topk_idx, topk_w = _top_k(probs, cfg.top_k)
    acc = _routed_sum(lp, h, topk_idx, topk_w)
    # the cast (a copy in fp32) is the op that "selective" saves as
    # "moe_out"; the dispatch is recomputed in the backward, as in JAX
    with checkpoint_name("moe_out"):
        y = acc.to(h.dtype, copy=True)
    return x + y.view(B, L, d), _aux_loss(probs, topk_idx, cfg.n_experts)


def _check_no_mesh(cfg: MixtralConfig, mesh) -> None:
    if mesh is not None or cfg.fsdp_overlap:
        raise ValueError("a mesh argument and fsdp_overlap=True need a "
                         "device mesh, which this port does not have yet")


def forward(params: Params, tokens: torch.Tensor, cfg: MixtralConfig,
            mesh=None, return_aux: bool = False):
    """tokens [B, L] int -> logits [B, L, vocab] fp32 (and the mean aux
    loss over layers with ``return_aux``). Differentiable; inference
    callers disable grad themselves."""
    _check_no_mesh(cfg, mesh)
    B, L = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(L, device=tokens.device)
    body = remat_layer(functools.partial(_layer, cfg=cfg,
                                         positions=positions), cfg)
    aux = []
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x, a = body(lp, x)
        aux.append(a)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(x, params["embed"])
    if return_aux:
        return logits, torch.stack(aux).mean()
    return logits


def loss_fn(params: Params, tokens: torch.Tensor, cfg: MixtralConfig,
            mesh=None) -> torch.Tensor:
    """Next-token cross-entropy + aux load-balance term (Mixtral's
    training objective), fp32."""
    logits, aux = forward(params, tokens, cfg, mesh, return_aux=True)
    return _nll_mean(logits, tokens) + cfg.aux_loss_coef * aux


def num_params(cfg: MixtralConfig) -> int:
    d, L, E, f = cfg.dim, cfg.n_layers, cfg.n_experts, cfg.ffn_dim
    hd = cfg.head_dim
    per_layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + cfg.n_heads * hd * d          # attention
                 + d * E                          # router
                 + 3 * E * d * f                  # gated SwiGLU experts
                 + 2 * d)                         # norms
    return cfg.vocab_size * d + L * per_layer + d


def active_params(cfg: MixtralConfig) -> int:
    """Params touched per token (top-k experts only)."""
    d, L, f = cfg.dim, cfg.n_layers, cfg.ffn_dim
    hd = cfg.head_dim
    per_layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + cfg.n_heads * hd * d + d * cfg.n_experts
                 + 3 * cfg.top_k * d * f + 2 * d)
    return cfg.vocab_size * d + L * per_layer + d


def flops_per_token(cfg: MixtralConfig, seq_len: int) -> float:
    """6·N_active + the attention score term (llama's convention)."""
    attn = 12 * cfg.n_layers * cfg.dim * seq_len
    return 6.0 * active_params(cfg) + attn
