"""Top-k routed mixture-of-experts FFN — the PyTorch port of
``ray_tpu/parallel/moe.py``'s single-device path.

The routing is the JAX package's: router logits in the compute dtype,
softmax in fp32, top-k, combine weights renormalized over the top-k
(Mixtral's convention). The JAX ``moe_ffn`` runs every expert on every
token and multiplies the unrouted ones by 0; this one computes the same
function on the routed tokens only: the (token, slot) assignments sorted
by expert (stably), each expert's contiguous segment gathered and put
through its products, and ``weight * y`` added into an fp32 [T, d] sum
expert by expert in index order, which is the JAX sum order, since the
zeros it adds change nothing. A token appears at most once per expert, so
each ``index_add_`` writes distinct rows and stays deterministic on the
card. The segment sizes are read on the host: one device-to-host read per
call, counted in ``sync_counts``.

``moe_param_specs``, ``_moe_shard`` and ``moe_ffn_sharded`` (capacity
buckets and ``all_to_all`` over the ``ep`` axis) wait for the device mesh.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import dense_init, resolve_device

Params = Dict[str, torch.Tensor]

#: device-to-host reads of the segment sizes (one per routed FFN call,
#: the remat recompute's included)
sync_counts = {"segment_sizes": 0}


def init_moe_params(dim: int, ffn_dim: int, num_experts: int,
                    seed: int = 0, device="cuda",
                    dtype=torch.float32) -> Params:
    """Router and ungated expert weights with ``init_moe_params``' tree,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return {
        "router": dense_init(g, (dim, num_experts), dtype, dim),
        "w_in": dense_init(g, (num_experts, dim, ffn_dim), dtype, dim),
        "w_out": dense_init(g, (num_experts, ffn_dim, dim), dtype, ffn_dim),
    }


def _router_probs(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [T, d] -> fp32 router probabilities [T, E] (logits in x's
    dtype)."""
    return torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)


def _top_k(probs: torch.Tensor, top_k: int):
    """probs [T, E] -> (topk_idx [T, k], topk_w [T, k] renormalized). The
    gradient reaches the router through the top-k values."""
    topk_w, topk_idx = torch.topk(probs, top_k, dim=-1)
    topk_w = topk_w / topk_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return topk_idx, topk_w


def _routing(params: Params, x: torch.Tensor, top_k: int):
    """x [T, d] -> (topk_idx [T, k], topk_w [T, k] renormalized)."""
    return _top_k(_router_probs(params["router"], x), top_k)


def _expert_ffn(w_in, w_out, h, w_gate=None):
    """h [n, d] through one expert: silu MLP, or gated SwiGLU when the
    params carry a w_gate (Mixtral's 3-matrix expert). 2-D products."""
    if w_gate is None:
        return F.silu(h @ w_in) @ w_out
    return (F.silu(h @ w_gate) * (h @ w_in)) @ w_out


def _routed_sum(params: Params, x: torch.Tensor, topk_idx: torch.Tensor,
                topk_w: torch.Tensor) -> torch.Tensor:
    """Σ over each token's top-k experts of weight · expert(x), fp32
    [T, d], computed on the routed tokens only (module docstring)."""
    T, d = x.shape
    E, k = params["w_in"].shape[0], topk_idx.shape[1]
    flat = topk_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sizes = torch.bincount(flat, minlength=E).tolist()
    sync_counts["segment_sizes"] += 1
    tokens = (order // k).split(sizes)
    weights = topk_w.reshape(-1)[order].split(sizes)
    w_in, w_out = params["w_in"].unbind(0), params["w_out"].unbind(0)
    w_gate = params["w_gate"].unbind(0) if "w_gate" in params else None
    out = torch.zeros(T, d, dtype=torch.float32, device=x.device)
    for e in range(E):
        if not sizes[e]:
            continue
        y = _expert_ffn(w_in[e].to(x.dtype), w_out[e].to(x.dtype),
                        x.index_select(0, tokens[e]),
                        None if w_gate is None else w_gate[e].to(x.dtype))
        out.index_add_(0, tokens[e], weights[e][:, None] * y.float())
    return out


def moe_ffn(params: Params, x: torch.Tensor, *, top_k: int = 2
            ) -> torch.Tensor:
    """x [T, d] -> [T, d] in x's dtype: every token through its top-k
    experts, no capacity (the JAX ``moe_ffn``'s function)."""
    topk_idx, topk_w = _routing(params, x, top_k)
    return _routed_sum(params, x, topk_idx, topk_w).to(x.dtype)
