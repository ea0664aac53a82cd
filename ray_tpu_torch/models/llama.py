"""Llama-family decoder-only transformer — the PyTorch port of
``ray_tpu/models/llama.py``.

The same parameter tree (a dict of tensors, layers stacked on axis 0, the
same names and shapes), the same ``forward(params, tokens, cfg)`` and
``loss_fn``, and the same numerics: fp32 rmsnorm statistics, fp32
half-split rope, causal softmax in fp32, tied-embedding head that
accumulates and returns fp32 logits. Attention is "full" (plain torch) or
"flash" (``ops.flash_attention``: the CUDA kernels on the card). Remat is
``torch.utils.checkpoint`` per layer, its policies saving what the JAX
policies save ("selective": the tensors tagged by ``checkpoint_name``).
The attention block is shared with ``models/mixtral.py``. Not in this
port yet: the pipeline, ring and Ulysses paths and the fsdp-overlap loss
(they need a device mesh).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

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
    attention: str = "full"                    # full | flash
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights
    remat: bool = True
    remat_policy: str = "full"     # full | dots | dots_no_batch | selective
    int8_mlp: bool = False         # dynamic-W8A8 MLP matmuls (ops.int8)

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
        return dense_init(g, shape, pd,
                          fan_in if fan_in is not None else shape[-2])

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


def dense_init(g: torch.Generator, shape, dtype, fan_in) -> torch.Tensor:
    """N(0, 1/fan_in) values of ``shape`` on ``g``'s device, drawn one
    trailing matrix at a time (one layer's, or one expert's), so the fp32
    scratch stays one matrix's size."""
    out = torch.empty(shape, dtype=dtype, device=g.device)
    for part in out.view(-1, *shape[-2:]):
        part.copy_(torch.randn(part.shape, generator=g, device=g.device)
                   * fan_in ** -0.5)
    return out


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


class _TiedHead(torch.autograd.Function):
    """x [N, d] · wᵀ -> fp32 [N, V] for low-precision x and w on the card:
    ``torch.mm(..., out_dtype=float32)`` reads w once in its own dtype but
    has no derivative, so the backward is written out: the two transposed
    products in x's dtype with fp32 accumulation (the logits' gradient
    rounded to that dtype first), dx = g · w and dw = gᵀ · x."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.t() @ x if ctx.needs_input_grad[1] else None
        return dx, dw


def head_logits(x, embed):
    """Tied-embedding head: x [..., d] · embedᵀ -> fp32 logits [..., V].

    Operands in x's dtype, fp32 accumulation AND fp32 output: a
    bf16-output product would round the logits before the argmax and
    flip greedy near-ties. On the card a bf16 embedding is read once as
    bf16 (``out_dtype``, differentiable through ``_TiedHead``); on the CPU
    bf16 operands widen exactly to fp32.
    """
    w = embed.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w.t()
    if x.is_cuda:
        out = _TiedHead.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return x.float() @ w.float().t()


#: the names ``checkpoint_name`` gives the attention and MLP projections
#: and Mixtral's combined expert output: what remat_policy "selective"
#: saves (and nothing else), as in the JAX package
SELECTIVE_SAVE_NAMES = ("attn_q", "attn_k", "attn_v", "attn_o",
                        "mlp_gate", "mlp_up", "mlp_down",
                        "moe_out")

_tag = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """The port's ``jax.ad_checkpoint.checkpoint_name``: a block around the
    one op that produces the named tensor. Under remat policy "selective"
    the outputs of the ops run inside a block named in
    SELECTIVE_SAVE_NAMES are saved for the backward; everything else is
    recomputed. It is a block and not a call on the result because
    PyTorch's selective checkpoint decides for each op as it runs."""
    outer = getattr(_tag, "name", None)
    _tag.name = name
    try:
        yield
    finally:
        _tag.name = outer


def _projection(h, w, name):
    """h [..., K] @ w [K, N] as one 2-D product (``aten.mm``) tagged
    ``name``."""
    a = h.reshape(-1, h.shape[-1])
    with checkpoint_name(name):
        out = torch.mm(a, w)
    return out.view(*h.shape[:-1], w.shape[-1])


def _selective_policy(ctx, op, *args, **kwargs):
    """Save what runs inside a block named in SELECTIVE_SAVE_NAMES. The
    int8 MLP's products are untagged (``int8_matmul`` quantizes its
    operands around its one product) and are saved by op, as
    ``aten._int_mm`` outputs."""
    saved = (getattr(_tag, "name", None) in SELECTIVE_SAVE_NAMES
             or op is torch.ops.aten._int_mm.default)
    return (CheckpointPolicy.MUST_SAVE if saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


# aten ops whose outputs the "dots" policies save: every 2-D product
# (aten.mm; aten._int_mm with the int8 MLP), and for "dots" also the
# batched attention products (aten.bmm: the [B, H, L, L] scores of full
# attention), as JAX's checkpoint_dots does
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten._int_mm.default)
_SAVED_OPS = {
    "dots_no_batch": _PRODUCTS,
    "dots": _PRODUCTS + (torch.ops.aten.bmm.default,),
}


def _save_ops_policy(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy_fn(name: str):
    """Config string -> the ``context_fn`` of ``torch.utils.checkpoint``:
    for "full" the default (save only the layer's input, recompute the
    rest); for "selective" a selective-checkpoint context saving the
    tagged tensors (``_selective_policy``); for the "dots" policies one
    saving the outputs of the ops in ``_SAVED_OPS``. Raises on an unknown
    name."""
    if name == "full":
        return noop_context_fn
    if name == "selective":
        policy = _selective_policy
    elif name in _SAVED_OPS:
        policy = functools.partial(_save_ops_policy, _SAVED_OPS[name])
    else:
        raise ValueError(f"unknown remat_policy {name!r}")
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _attention(lp: Params, x, cfg, positions, attn_fn):
    """x + the attention block of rmsnorm(x): the half of a layer that
    Llama and Mixtral share (leaves attn_norm, wq, wk, wv, wo)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, L, _ = x.shape
    cd = cfg.dtype

    h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = _projection(h, lp["wq"].to(cd), "attn_q")
    k = _projection(h, lp["wk"].to(cd), "attn_k")
    v = _projection(h, lp["wv"].to(cd), "attn_v")
    q = _rope(q.reshape(B, L, hq, hd), positions, cfg.rope_theta)
    k = _rope(k.reshape(B, L, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, L, hkv, hd)
    if hkv != hq:  # GQA: repeat KV groups to full head count
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    o = attn_fn(q, k, v).reshape(B, L, hq * hd)
    return x + _projection(o, lp["wo"].to(cd), "attn_o")


def _layer(lp: Params, x, cfg: LlamaConfig, positions, attn_fn):
    """One transformer block; lp leaves have the layer axis removed."""
    cd = cfg.dtype

    if cfg.int8_mlp:
        from ray_tpu_torch.ops.int8 import int8_matmul

        def mlp_mm(a, w, name):
            return int8_matmul(a, w.to(cd))
    else:
        def mlp_mm(a, w, name):
            return _projection(a, w.to(cd), name)

    x = _attention(lp, x, cfg, positions, attn_fn)
    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(mlp_mm(h, lp["w_gate"], "mlp_gate"))
    up = mlp_mm(h, lp["w_up"], "mlp_up")
    return x + mlp_mm(gate * up, lp["w_down"], "mlp_down")


def _make_attn_fn(cfg: LlamaConfig):
    if cfg.attention == "full":
        return _full_attention
    if cfg.attention == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention
    if cfg.attention in ("ring", "ulysses"):
        raise ValueError(f"attention={cfg.attention!r} needs a device mesh, "
                         f"which this port does not have yet")
    raise ValueError(f"unknown attention {cfg.attention!r}")


def remat_layer(body, cfg):
    """body(lp, x) under ``torch.utils.checkpoint`` with the remat policy's
    context when ``cfg.remat`` is set and grad is enabled; the policy name
    is checked whenever ``cfg.remat`` is set."""
    if not cfg.remat:
        return body
    context_fn = remat_policy_fn(cfg.remat_policy)
    if not torch.is_grad_enabled():
        return body
    return functools.partial(checkpoint, body, use_reentrant=False,
                             context_fn=context_fn)


def unstack_layers(layers: Params, n_layers: int):
    """Each layer's leaves, from one unbind of each stacked leaf, so the
    backward stacks each leaf's layer gradients in one op."""
    per_layer = {name: leaf.unbind(0) for name, leaf in layers.items()}
    return [{name: leaves[i] for name, leaves in per_layer.items()}
            for i in range(n_layers)]


def _scan_layers(layers: Params, x, cfg: LlamaConfig, positions, attn_fn):
    """Apply the stacked layers in order, each under ``remat_layer``."""
    body = remat_layer(functools.partial(
        _layer, cfg=cfg, positions=positions, attn_fn=attn_fn), cfg)
    for lp in unstack_layers(layers, cfg.n_layers):
        x = body(lp, x)
    return x


def layer_params(params: Params, i: int) -> Params:
    """Layer i's leaves (views into the stacked tensors)."""
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """tokens [B, L] int -> logits [B, L, vocab] (fp32). Differentiable;
    inference callers disable grad themselves."""
    B, L = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(L, device=tokens.device)
    x = _scan_layers(params["layers"], x, cfg, positions, _make_attn_fn(cfg))
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return head_logits(x, params["embed"])


def _nll_mean(logits, tokens):
    """Shifted next-token NLL mean; logits [B, L, V] fp32, tokens [B, L]."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def loss_fn(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy (mean over B×(L-1) positions), fp32. The
    full sequence goes through forward; the shift happens on the
    logits."""
    return _nll_mean(forward(params, tokens, cfg), tokens)


def num_params(cfg: LlamaConfig) -> int:
    d, L, f = cfg.dim, cfg.n_layers, cfg.ffn_dim
    hd = cfg.head_dim
    per_layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + cfg.n_heads * hd * d + 3 * d * f + 2 * d)
    return cfg.vocab_size * d + L * per_layer + d


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approx training FLOPs/token: 6·N_params + the attention score term
    (the full, non-causal 12·L·d·s convention of PaLM appendix B; causal
    kernels do about half that score work). The tied embedding counts:
    it is also the head."""
    attn = 12 * cfg.n_layers * cfg.dim * seq_len
    return 6.0 * num_params(cfg) + attn
