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
The attention block is shared with ``models/mixtral.py``.

On a device mesh (``forward``/``loss_fn`` with ``mesh=``) each rank runs
the layers on its shards of the ``param_specs`` layout: fsdp dims
gathered layer by layer (or prefetched, ``fsdp_overlap``), heads and the
ffn hidden dim split over tp with one sum over tp after each row-split
product, the embedding gathered whole. With sp > 1 each rank runs the
layers on its block of the sequence (rope positions offset by its
block's start) and attention goes around the ring or through Ulysses'
all-to-all; with pp > 1 each rank holds n_layers / pp layers and the
microbatches go through ``parallel.pipeline.pipeline_apply``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ray_tpu_torch.parallel.mesh import P

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
    attention: str = "full"            # full | flash | ring | ulysses
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights
    remat: bool = True
    remat_policy: str = "full"     # full | dots | dots_no_batch | selective
    pp_microbatches: int = 4       # microbatch count when pp > 1
    int8_mlp: bool = False         # dynamic-W8A8 MLP matmuls (ops.int8)
    fsdp_overlap: bool = False     # prefetch-scheduled fsdp gathers

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
    tree: Params = {}
    for path, shape, parts in init_leaves(cfg, seed, dev):
        leaf = torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        for dst, part in zip(matrices(leaf), parts):
            dst.copy_(part)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def matrices(leaf: torch.Tensor) -> torch.Tensor:
    """``leaf`` as a stack of its trailing matrices (one layer's, or one
    expert's); a vector as a stack of one."""
    if leaf.dim() < 2:
        return leaf[None]
    return leaf.reshape(-1, *leaf.shape[-2:])


def init_leaves(cfg: LlamaConfig, seed: int = 0, device="cuda"):
    """``init_params``' leaves, drawn lazily: (path of keys, shape, an
    iterator of the leaf's ``matrices`` in ``cfg.param_dtype``), in the
    tree's order. The draws happen as the iterators are consumed, which
    must be in that order; a caller can then place each matrix where it
    goes (a tensor-parallel engine's shards) without the whole tree ever
    existing on the device."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.dim, cfg.n_layers
    hq, hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim
    pd = cfg.param_dtype

    def norm(*shape):
        for _ in range(math.prod(shape[:-2])):
            yield torch.ones(shape[-2:], dtype=pd, device=dev)

    def dense(*shape, fan_in=None):
        fan_in = fan_in if fan_in is not None else shape[-2]
        for _ in range(math.prod(shape[:-2])):
            yield (torch.randn(shape[-2:], generator=g, device=dev)
                   * fan_in ** -0.5).to(pd)

    leaves = [
        (("embed",), (cfg.vocab_size, d), dense, {"fan_in": d}),
        (("layers", "attn_norm"), (L, d), norm, {}),
        (("layers", "wq"), (L, d, hq * hd), dense, {}),
        (("layers", "wk"), (L, d, hkv * hd), dense, {}),
        (("layers", "wv"), (L, d, hkv * hd), dense, {}),
        (("layers", "wo"), (L, hq * hd, d), dense, {}),
        (("layers", "mlp_norm"), (L, d), norm, {}),
        (("layers", "w_gate"), (L, d, f), dense, {}),
        (("layers", "w_up"), (L, d, f), dense, {}),
        (("layers", "w_down"), (L, f, d), dense, {}),
        (("final_norm",), (d,), norm, {}),
    ]
    return [(path, shape, draw(*shape, **kw))
            for path, shape, draw, kw in leaves]


def tree_leaves(params: Params):
    """A parameter tree's leaves as ``init_leaves`` gives them: (path,
    shape, an iterator of the leaf's ``matrices``, views where the leaf
    is contiguous)."""
    out = []
    for key, value in params.items():
        if isinstance(value, dict):
            out += [((key, *path), shape, parts)
                    for path, shape, parts in tree_leaves(value)]
        else:
            out.append(((key,), tuple(value.shape), iter(matrices(value))))
    return out


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
    """Causal attention, q/k/v [B, L, H, D] -> [B, L, H, D] in q's dtype:
    ``parallel.attention.attention`` (q scaled in its own dtype, fp32
    products and softmax, probabilities rounded to v's dtype), as
    ``ray_tpu.parallel.attention``."""
    from ray_tpu_torch.parallel.attention import attention
    return attention(q, k, v).to(q.dtype)


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


def _attention(lp: Params, x, cfg, positions, attn_fn, tp_sum=None):
    """x + the attention block of rmsnorm(x): the half of a layer that
    Llama and Mixtral share (leaves attn_norm, wq, wk, wv, wo). The head
    counts come from the projections' widths, so a tensor-parallel shard
    (its heads' columns of wq/wk/wv and rows of wo) runs the same code;
    ``tp_sum`` then sums the row-split output product over tp."""
    hd = cfg.head_dim
    B, L, _ = x.shape
    cd = cfg.dtype

    h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = _projection(h, lp["wq"].to(cd), "attn_q")
    k = _projection(h, lp["wk"].to(cd), "attn_k")
    v = _projection(h, lp["wv"].to(cd), "attn_v")
    q = _rope(q.reshape(B, L, -1, hd), positions, cfg.rope_theta)
    k = _rope(k.reshape(B, L, -1, hd), positions, cfg.rope_theta)
    v = v.reshape(B, L, -1, hd)
    rep = q.shape[2] // k.shape[2]
    if rep != 1:  # GQA: repeat KV groups to full head count
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    o = attn_fn(q, k, v).reshape(B, L, -1)
    out = _projection(o, lp["wo"].to(cd), "attn_o")
    return x + (out if tp_sum is None else tp_sum(out))


def _layer(lp: Params, x, cfg: LlamaConfig, positions, attn_fn,
           tp_sum=None):
    """One transformer block; lp leaves have the layer axis removed.
    ``tp_sum`` (tensor parallelism) sums each row-split product (wo,
    w_down) over tp."""
    cd = cfg.dtype

    if cfg.int8_mlp:
        from ray_tpu_torch.ops.int8 import int8_matmul

        def mlp_mm(a, w, name):
            return int8_matmul(a, w.to(cd))
    else:
        def mlp_mm(a, w, name):
            return _projection(a, w.to(cd), name)

    x = _attention(lp, x, cfg, positions, attn_fn, tp_sum)
    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(mlp_mm(h, lp["w_gate"], "mlp_gate"))
    up = mlp_mm(h, lp["w_up"], "mlp_up")
    down = mlp_mm(gate * up, lp["w_down"], "mlp_down")
    return x + (down if tp_sum is None else tp_sum(down))


def _make_attn_fn(cfg: LlamaConfig, mesh=None):
    """The attention of ``cfg.attention`` on this rank's shards. At
    sp > 1 the ranks hold blocks of the sequence, so attention spans the
    sp ranks: "ring" and "ulysses" as named, "full" through the einsum
    ring (the plain full attention over every block) and "flash" through
    the fused ring (the flash kernels per block)."""
    from ray_tpu_torch.parallel.mesh import axis_size
    sp = axis_size(mesh, "sp")
    if cfg.attention in ("ring", "ulysses") and mesh is None:
        raise ValueError(f"attention={cfg.attention!r} needs a mesh")
    if cfg.attention == "ring" or (sp > 1 and cfg.attention in ("full",
                                                                "flash")):
        from ray_tpu_torch.parallel.ring_attention import (
            ring_attention_sharded)
        # "ring" follows the tensors' device, inside a pipeline too: the
        # JAX package forces the einsum ring at pp > 1 only because a
        # Pallas call cannot be auto-partitioned in the pipeline's
        # partial-manual shard_map, and here each stage is plain per-rank
        # code, so CUDA tensors run the fused ring's flash kernels
        use_kernel = {"full": False, "flash": True}.get(cfg.attention)
        return functools.partial(ring_attention_sharded, mesh=mesh,
                                 use_kernel=use_kernel)
    if cfg.attention == "ulysses":
        from ray_tpu_torch.parallel.ulysses import (
            ulysses_attention_sharded)
        return functools.partial(ulysses_attention_sharded, mesh=mesh)
    if cfg.attention == "full":
        return _full_attention
    if cfg.attention == "flash":
        from ray_tpu_torch.ops.flash_attention import (
            flash_attention, flash_attention_sharded)
        if mesh is not None:
            return functools.partial(flash_attention_sharded, mesh=mesh)
        # blk None: the tuned entry of this shape when one is cached
        # (autotune_blocks, run eagerly before the steps), else 256 and
        # the kernels' default tiles
        return functools.partial(flash_attention, blk_q=None, blk_k=None)
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


def _scan_layers(layers: Params, x, cfg: LlamaConfig, positions, attn_fn,
                 mesh=None):
    """Apply the stacked layers in order, each under ``remat_layer``. On
    a ``mesh`` the layers are this rank's shards: each layer's fsdp dims
    gathered inside the remat body (the backward's recompute gathers
    again; with ``cfg.fsdp_overlap`` and fsdp > 1, ``overlap_scan``
    prefetches them instead), heads and the ffn hidden dim local to the
    tp shard, each row-split product summed over tp. Without a mesh the
    gathers and sums are identities."""
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.fsdp_overlap import (drop_leading_dim,
                                                     gather_params,
                                                     overlap_scan)
    from ray_tpu_torch.parallel.mesh import axis_size
    lspecs = drop_leading_dim(param_specs(cfg)["layers"])
    tp_sum = functools.partial(collectives.allreduce, mesh=mesh,
                               axis_name="tp")
    layer = functools.partial(_layer, cfg=cfg, positions=positions,
                              attn_fn=attn_fn, tp_sum=tp_sum)
    # the layers held: all of them, or a pipeline stage's n_layers / pp
    n_layers = layers["wq"].shape[0]
    if cfg.fsdp_overlap and axis_size(mesh, "fsdp") > 1:
        return overlap_scan(layers, lspecs, x, remat_layer(layer, cfg),
                            n_layers, mesh, axis_name="fsdp")

    def body(lp, x):
        return layer(gather_params(lp, lspecs, mesh, "fsdp"), x)

    body = remat_layer(body, cfg)
    for lp in unstack_layers(layers, n_layers):
        x = body(lp, x)
    return x


def layer_params(params: Params, i: int) -> Params:
    """Layer i's leaves (views into the stacked tensors)."""
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def param_specs(cfg: LlamaConfig) -> Params:
    """The sharding of each leaf of ``init_params``' tree, as the JAX
    package's ``param_specs``: the stacked layer dim over pp, the matmul
    input dims over fsdp, heads and the ffn hidden dim over tp."""
    return {
        "embed": P("tp", "fsdp"),
        "layers": {
            "attn_norm": P("pp", None),
            "wq": P("pp", "fsdp", "tp"),
            "wk": P("pp", "fsdp", "tp"),
            "wv": P("pp", "fsdp", "tp"),
            "wo": P("pp", "tp", "fsdp"),
            "mlp_norm": P("pp", None),
            "w_gate": P("pp", "fsdp", "tp"),
            "w_up": P("pp", "fsdp", "tp"),
            "w_down": P("pp", "tp", "fsdp"),
        },
        "final_norm": P(None),
    }


def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """tokens [B, L] int -> logits [B, L, vocab] (fp32). Differentiable;
    inference callers disable grad themselves.

    With a ``mesh`` (``parallel.mesh.build_mesh``) this rank's shards:
    ``params`` sharded by ``param_specs`` and ``tokens`` over (dp, fsdp),
    as DTensors or their local tensors; returns this rank's logits
    [B / (dp * fsdp), L / sp, vocab], those of its block of the
    sequence (rank r of sp: positions [r·L/sp, (r+1)·L/sp)). The
    embedding is gathered whole (over tp and fsdp) for the lookup and
    the tied head. pp > 1 runs the layers as a pipeline
    (``_forward_pipelined``)."""
    from ray_tpu_torch.parallel.mesh import axis_size
    embed = params["embed"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if mesh is not None:
        from ray_tpu_torch.parallel.fsdp_overlap import (gather_params,
                                                         tree_map)
        _check_mesh(cfg, mesh)
        params = tree_map(_local, params)
        tokens, positions = _seq_block(_local(tokens), mesh)
        embed = params["embed"]
        for axis in ("tp", "fsdp"):
            embed = gather_params(embed, param_specs(cfg)["embed"], mesh,
                                  axis)
    x = embed[tokens].to(cfg.dtype)
    attn_fn = _make_attn_fn(cfg, mesh)
    if axis_size(mesh, "pp") > 1:
        x = _forward_pipelined(params["layers"], x, cfg, mesh, positions,
                               attn_fn)
    else:
        x = _scan_layers(params["layers"], x, cfg, positions, attn_fn,
                         mesh)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return head_logits(x, embed)


def _seq_block(tokens, mesh):
    """This rank's block of the sequence and its positions: the whole
    sequence at sp 1, else the r-th of sp equal blocks."""
    from ray_tpu_torch.parallel.mesh import axis_index, axis_size
    sp, L = axis_size(mesh, "sp"), tokens.shape[1]
    if L % sp:
        raise ValueError(f"sequence length {L} does not split into {sp} "
                         f"equal blocks over sp")
    n = L // sp
    start = axis_index(mesh, "sp") * n
    positions = start + torch.arange(n, device=tokens.device)
    return tokens[:, start:start + n], positions


def _forward_pipelined(layers: Params, x, cfg: LlamaConfig, mesh,
                       positions, attn_fn):
    """pp > 1: the batch split into ``cfg.pp_microbatches`` microbatches
    through ``pipeline_apply``, each rank's stage its n_layers / pp layers
    (the layer axis sharded over pp by ``param_specs``). The embedding
    and the head stay outside the pipeline, as in the JAX package."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply
    B, L, D = x.shape
    M = min(cfg.pp_microbatches, B)
    if B % M:
        raise ValueError(f"batch {B} not divisible by pp_microbatches {M}")

    def stage_fn(stage_layers, xb):
        return _scan_layers(stage_layers, xb, cfg, positions, attn_fn,
                            mesh)

    out = pipeline_apply(stage_fn, layers, x.reshape(M, B // M, L, D),
                         mesh, axis_name="pp")
    return out.reshape(B, L, D)


def _local(x):
    """A DTensor's local shard (differentiably), any other tensor as is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _check_mesh(cfg: LlamaConfig, mesh) -> None:
    from ray_tpu_torch.parallel.mesh import axis_size
    if axis_size(mesh, "pp") > 1 and cfg.attention not in ("full", "ring"):
        raise ValueError("pp>1 supports attention in {'full','ring'}")
    pp, tp, fsdp = (axis_size(mesh, a) for a in ("pp", "tp", "fsdp"))
    for name, n, by in (("n_heads", cfg.n_heads, tp),
                        ("n_kv_heads", cfg.n_kv_heads, tp),
                        ("ffn_dim", cfg.ffn_dim, tp),
                        ("vocab_size", cfg.vocab_size, tp),
                        ("dim", cfg.dim, fsdp),
                        ("n_layers", cfg.n_layers, pp)):
        if n % by:
            raise ValueError(f"{name} {n} does not split over {by} ranks")


def _nll_mean(logits, tokens):
    """Shifted next-token NLL mean; logits [B, L, V] fp32, tokens [B, L]."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def loss_fn(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy (mean over B×(L-1) positions), fp32. The
    full sequence goes through forward; the shift happens on the
    logits.

    With a ``mesh``: one loss, held by every rank
    (``collectives.loss_mean``): the sum of every rank's next-token terms
    over (dp, fsdp, sp) divided by the global count B×(L-1). At sp 1
    that is the mean of the ranks' shard means (equal shards), as
    ``_loss_overlap``'s ``pmean`` in the JAX package. At sp > 1 a
    block's last position is labelled by the next block's first token
    (each rank holds the whole sequence of tokens), and the last block
    has one term fewer per row. ``cfg.fsdp_overlap`` prefetches each
    layer's fsdp gather (``overlap_scan``) instead of gathering inside
    the layer."""
    from ray_tpu_torch.parallel.collectives import loss_mean
    from ray_tpu_torch.parallel.mesh import axis_index, axis_size
    logits = forward(params, tokens, cfg, mesh)
    if mesh is None:
        return _nll_mean(logits, tokens)
    tokens = _local(tokens)
    sp = axis_size(mesh, "sp")
    if sp == 1:    # the mean, as the single-device loss takes it
        return loss_mean(_nll_mean(logits, tokens), mesh, ("dp", "fsdp"))
    B, L = tokens.shape
    start = axis_index(mesh, "sp") * (L // sp)
    targets = tokens[:, start + 1:start + L // sp + 1].long()
    logp = torch.log_softmax(logits[:, :targets.shape[1]], dim=-1)
    total = -logp.gather(-1, targets[..., None]).sum()
    # loss_mean averages over its axes: scale each rank's sum so that the
    # average is the sum over (dp, fsdp, sp) over the global count
    axes = ("dp", "fsdp", "sp")
    count = B * axis_size(mesh, ("dp", "fsdp")) * (L - 1)
    return loss_mean(total * (axis_size(mesh, axes) / count), mesh, axes)


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
