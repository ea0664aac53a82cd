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

On a device mesh (``forward``/``loss_fn`` with ``mesh=``, the leaves this
rank's shards of ``param_specs``): the batch over (dp, fsdp), fsdp dims
gathered layer by layer, heads over tp (Llama's attention block), and at
ep > 1 the experts split over ep (``parallel.moe.moe_ffn_sharded``: each
ep rank routes its 1/ep of the tokens, which are then gathered back).
The ep axis lives on a mesh made by hand, as the JAX tests make theirs
(``Mesh(devices, ("dp", "ep"))``; here ``init_device_mesh(...,
mesh_dim_names=("dp", "ep"))``). The aux term's routed fractions and
mean probabilities are taken over every rank's tokens, as the JAX
package's single GSPMD program takes them; ``fsdp_overlap`` runs the
JAX package's prefetching loss (``_loss_overlap``), whose aux term is
each shard's, averaged. pp > 1 and sp > 1 raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import (_attention, _full_attention,
                                        _local, _nll_mean, _rmsnorm,
                                        checkpoint_name, dense_init,
                                        head_logits, remat_layer,
                                        resolve_device, unstack_layers)
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import P, axis_index, axis_size
from ray_tpu_torch.parallel.moe import (_router_probs, _routed_sum, _top_k,
                                        moe_ffn_sharded)

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
    capacity_factor: float = 1.25  # ep dispatch buckets (overflow drops)
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights
    remat: bool = True
    remat_policy: str = "full"     # full | dots | dots_no_batch | selective
    fsdp_overlap: bool = False     # prefetch-scheduled fsdp loss

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


def param_specs(cfg: MixtralConfig) -> Params:
    """The stacked layer dim over pp; the attention products over fsdp/tp
    as Llama's; the EXPERT dim over ep."""
    return {
        "embed": P("tp", "fsdp"),
        "layers": {
            "attn_norm": P("pp", None),
            "wq": P("pp", "fsdp", "tp"),
            "wk": P("pp", "fsdp", "tp"),
            "wv": P("pp", "fsdp", "tp"),
            "wo": P("pp", "tp", "fsdp"),
            "moe_norm": P("pp", None),
            "router": P("pp", None, None),
            "w_gate": P("pp", "ep", "fsdp", None),
            "w_in": P("pp", "ep", "fsdp", None),
            "w_out": P("pp", "ep", None, "fsdp"),
        },
        "final_norm": P(None),
    }


def _aux_loss(router_probs: torch.Tensor, topk_idx: torch.Tensor,
              n_experts: int, mesh=None) -> torch.Tensor:
    """Switch-transformer load-balance term: E · Σ_e f_e · P_e, f_e the
    fraction of routed assignments to expert e (no gradient) and P_e the
    mean router probability. With a ``mesh`` both means run over the
    tokens of every (dp, fsdp) rank."""
    f = F.one_hot(topk_idx, n_experts).float().mean(dim=(0, 1))
    p = router_probs.mean(dim=0)
    if mesh is not None:
        f = collectives.allreduce(f, mesh, ("dp", "fsdp"), op="mean")
        p = collectives.allreduce(p, mesh, ("dp", "fsdp"), op="mean")
    return n_experts * (f * p).sum()


def _moe(lp: Params, h, cfg: MixtralConfig, topk_idx, topk_w, mesh):
    """The routed experts of h [N, d] -> [N, d] in h's dtype. At ep > 1
    the ep rank r runs its block r of the N tokens through every rank's
    experts (``moe_ffn_sharded``) and the blocks are gathered back."""
    ep = axis_size(mesh, "ep")
    if ep == 1:
        acc = _routed_sum(lp, h, topk_idx, topk_w)
        # the cast (a copy in fp32) is the op that "selective" saves as
        # "moe_out"; the dispatch is recomputed in the backward, as in JAX
        with checkpoint_name("moe_out"):
            return acc.to(h.dtype, copy=True)
    N = h.shape[0]
    if N % ep:
        raise ValueError(f"{N} tokens do not split over ep={ep}")
    r = axis_index(mesh, "ep")
    moe_p = {k: lp[k] for k in ("router", "w_gate", "w_in", "w_out")}
    y = moe_ffn_sharded(moe_p, h[r * N // ep:(r + 1) * N // ep], mesh,
                        top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor)
    y = collectives.allgather(y, mesh, "ep", axis=0)
    with checkpoint_name("moe_out"):
        return y.clone()


def _layer(lp: Params, x, cfg: MixtralConfig, positions, mesh=None,
           tp_sum=None):
    """One block; lp leaves have the layer axis removed. Returns the new
    x and the layer's aux term. ``tp_sum`` sums the attention's
    row-split output product over tp."""
    B, L, d = x.shape
    x = _attention(lp, x, cfg, positions, _full_attention, tp_sum)
    h = _rmsnorm(x, lp["moe_norm"], cfg.norm_eps).reshape(B * L, d)
    probs = _router_probs(lp["router"], h)
    topk_idx, topk_w = _top_k(probs, cfg.top_k)
    y = _moe(lp, h, cfg, topk_idx, topk_w, mesh)
    return x + y.view(B, L, d), _aux_loss(probs, topk_idx, cfg.n_experts,
                                          mesh)


def _check_mesh(cfg: MixtralConfig, mesh) -> None:
    for ax in ("pp", "sp"):
        if axis_size(mesh, ax) > 1:
            raise ValueError(f"the Mixtral mesh path shards dp, fsdp, tp "
                             f"and ep; mesh axis {ax!r} has size "
                             f"{axis_size(mesh, ax)} > 1")
    if cfg.fsdp_overlap:
        for ax in ("tp", "ep"):
            if axis_size(mesh, ax) > 1:
                raise ValueError(
                    f"fsdp_overlap runs full-manual over (dp, fsdp); mesh "
                    f"axis {ax!r} has size {axis_size(mesh, ax)} > 1")


def forward(params: Params, tokens: torch.Tensor, cfg: MixtralConfig,
            mesh=None, return_aux: bool = False):
    """tokens [B, L] int -> logits [B, L, vocab] fp32 (and the mean aux
    loss over layers with ``return_aux``). Differentiable; inference
    callers disable grad themselves. With a ``mesh``: this rank's
    shards (``param_specs``; tokens over (dp, fsdp)), its logits
    [B / (dp·fsdp), L, vocab]."""
    if mesh is None and cfg.fsdp_overlap:
        raise ValueError("fsdp_overlap=True needs a mesh")
    embed = params["embed"]
    lspecs = tp_sum = None
    if mesh is not None:
        from ray_tpu_torch.parallel.fsdp_overlap import (drop_leading_dim,
                                                         gather_params,
                                                         tree_map)
        _check_mesh(cfg, mesh)
        params = tree_map(_local, params)
        tokens = _local(tokens)
        embed = params["embed"]
        for axis in ("tp", "fsdp"):
            embed = gather_params(embed, param_specs(cfg)["embed"], mesh,
                                  axis)
        lspecs = drop_leading_dim(param_specs(cfg)["layers"])
        tp_sum = functools.partial(collectives.allreduce, mesh=mesh,
                                   axis_name="tp")
    B, L = tokens.shape
    x = embed[tokens].to(cfg.dtype)
    positions = torch.arange(L, device=tokens.device)
    aux = []
    overlap = cfg.fsdp_overlap and axis_size(mesh, "fsdp") > 1
    # the prefetching loss runs each shard's layers as one device's
    # (the JAX _loss_overlap passes mesh=None into the layer)
    layer = functools.partial(_layer, cfg=cfg, positions=positions,
                              mesh=None if overlap else mesh,
                              tp_sum=tp_sum)
    if overlap:
        from ray_tpu_torch.parallel.fsdp_overlap import overlap_scan
        body = remat_layer(layer, cfg)

        def apply(w, x):
            x, a = body(w, x)
            aux.append(a)
            return x

        x = overlap_scan(params["layers"], lspecs, x, apply, cfg.n_layers,
                         mesh, axis_name="fsdp")
    else:
        def gathered(lp, x):
            if mesh is not None:
                lp = gather_params(lp, lspecs, mesh, "fsdp")
            return layer(lp, x)

        body = remat_layer(gathered, cfg)
        for lp in unstack_layers(params["layers"], cfg.n_layers):
            x, a = body(lp, x)
            aux.append(a)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(x, embed)
    if return_aux:
        return logits, torch.stack(aux).mean()
    return logits


def loss_fn(params: Params, tokens: torch.Tensor, cfg: MixtralConfig,
            mesh=None) -> torch.Tensor:
    """Next-token cross-entropy + aux load-balance term (Mixtral's
    training objective), fp32. With a ``mesh`` one loss held by every
    rank: the mean over (dp, fsdp) of each rank's (equal-shard) loss
    (``collectives.loss_mean``)."""
    logits, aux = forward(params, tokens, cfg, mesh, return_aux=True)
    local = _nll_mean(logits, _local(tokens)) + cfg.aux_loss_coef * aux
    return collectives.loss_mean(local, mesh, ("dp", "fsdp"))


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
