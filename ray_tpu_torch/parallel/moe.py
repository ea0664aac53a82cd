"""Top-k routed mixture-of-experts FFN — the PyTorch port of
``ray_tpu/parallel/moe.py``.

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

Expert parallelism (``moe_ffn_sharded``, GShard/Switch routing as in the
JAX package): experts split E/ep per rank of the ``ep`` axis, static
capacity buckets per (rank, expert), tokens beyond a bucket dropped
(weighted 0), dispatch and return through two ``all_to_all`` over ``ep``.
Each rank passes its own tokens and its experts; ``ep == 1`` is the
routed single-device path.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import dense_init, resolve_device
from ray_tpu_torch.parallel.mesh import P

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


def moe_param_specs() -> Params:
    """Spec of each leaf: the experts split over ep."""
    return {"router": P(None, None),
            "w_in": P("ep", None, None),
            "w_out": P("ep", None, None)}


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


def _moe_shard(params: Params, x: torch.Tensor, *, top_k: int,
               capacity: int, mesh, axis_name: str) -> torch.Tensor:
    """This rank's tokens x [t, d] through the experts of every rank:
    params hold this rank's E/ep experts (the router whole)."""
    from ray_tpu_torch.parallel.collectives import alltoall
    from ray_tpu_torch.parallel.mesh import axis_size
    t, d = x.shape
    ep = axis_size(mesh, axis_name)
    e_local = params["w_in"].shape[0]
    E = e_local * ep
    topk_idx, topk_w = _routing(params, x, top_k)
    # each (token, k)'s slot in its expert's bucket, in token order
    flat_e = topk_idx.reshape(-1)                          # [t*k]
    onehot = F.one_hot(flat_e, E)
    slot = ((onehot.cumsum(0) - 1) * onehot).sum(-1)       # [t*k]
    keep = slot < capacity
    w_flat = topk_w.reshape(-1) * keep                     # dropped -> 0
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    disp = torch.zeros(E, capacity, d, dtype=x.dtype, device=x.device)
    disp = disp.index_put(
        (flat_e, torch.where(keep, slot, capacity - 1)),
        torch.where(keep[:, None], x[tok_idx], torch.zeros_like(x[tok_idx])),
        accumulate=True)
    # [E, c, d] = [ep, e_local, c, d]: each rank's buckets for the
    # experts of rank j go to rank j -> [ep (source), e_local, c, d]
    disp = alltoall(disp.reshape(ep, e_local, capacity, d), mesh,
                    axis_name, split_axis=0, concat_axis=0)
    disp = disp.transpose(0, 1).reshape(e_local, ep * capacity, d)
    gated = "w_gate" in params
    out = torch.stack([_expert_ffn(
        params["w_in"][e].to(x.dtype), params["w_out"][e].to(x.dtype),
        disp[e], params["w_gate"][e].to(x.dtype) if gated else None)
        for e in range(e_local)])
    # the return trip
    out = out.reshape(e_local, ep, capacity, d).transpose(0, 1)
    out = alltoall(out.contiguous(), mesh, axis_name, split_axis=0,
                   concat_axis=0).reshape(E, capacity, d)
    # combine: each (token, k)'s slot output, weighted, summed over k (a
    # token's k entries are adjacent: one sum per token, in k order)
    gathered = out[flat_e, slot.clamp(max=capacity - 1)]
    contrib = gathered.float() * w_flat[:, None]
    return contrib.view(t, top_k, d).sum(1).to(x.dtype)


def moe_ffn_sharded(params: Params, x: torch.Tensor, mesh, *,
                    top_k: int = 2, capacity_factor: float = 1.25,
                    axis_name: str = "ep") -> torch.Tensor:
    """This rank's tokens x [t, d] -> [t, d], the experts split over
    ``axis_name`` (``params``: the router whole, this rank's E/ep experts).

    Capacity per expert per rank: ceil(t * k / E * capacity_factor), t
    this rank's tokens (the JAX package's T/ep); a (token, k) past its
    bucket is dropped. Equal to ``moe_ffn`` when the capacity holds every
    assignment. ``ep == 1`` runs ``moe_ffn``."""
    from ray_tpu_torch.parallel.mesh import axis_size
    ep = axis_size(mesh, axis_name)
    if ep == 1:
        return moe_ffn(params, x, top_k=top_k)
    E = params["router"].shape[1]
    if E % ep:
        raise ValueError(f"num_experts {E} not divisible by ep={ep}")
    if params["w_in"].shape[0] != E // ep:
        raise ValueError(f"{params['w_in'].shape[0]} experts held: a rank "
                         f"of ep={ep} holds E/ep = {E // ep}")
    capacity = max(1, math.ceil(x.shape[0] * top_k / E * capacity_factor))
    return _moe_shard(params, x, top_k=top_k, capacity=capacity, mesh=mesh,
                      axis_name=axis_name)
