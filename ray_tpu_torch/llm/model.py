"""Cache-aware Llama forward passes for inference — the PyTorch port of
``ray_tpu/llm/model.py``.

ONE step function for everything (``ragged_step``): the engine packs
decode tokens and prefill-chunk tokens into a single RAGGED batch
(``ops.paged_attention.ragged_paged_attention``). Per layer the step
writes every ragged token's K/V into the paged pool (``write_ragged_kv``,
quantizing when the pool is int8) and then attends; per row the argmax
of the last valid token's logits comes back, so a finishing prefill
chunk's first token and every decode row's next token come back in ONE
readback.

The KV pool is a dict {"k", "v"[, "k_scale", "v_scale"]} of tensors with
the layers stacked on the leading axis. Where the JAX functions take the
pool donated and return a new one, these update it IN PLACE and return
the same pools.

The step functions take LISTS of shards: each one device's parameters
and its pool. A single device is a list of one shard. Under tensor
parallelism (``reduce``, the counterpart of ``tp_axis``) a shard holds
wq/wk/wv/w_gate/w_up by columns, wo/w_down by rows (``llm/tp.py``) and
a pool of Hkv/tp heads. Head counts come from the shard's weight widths,
each shard attends over its own heads with no communication, and the two
row-split products per layer (after wo and after w_down) go through
``reduce``, which hands every shard the sum over shards (the JAX
package's two psums per layer); one shard is its own sum.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import (LlamaConfig, Params, _rmsnorm,
                                        _rope, head_logits, layer_params)
from ray_tpu_torch.ops.paged_attention import (ragged_paged_attention,
                                               write_ragged_kv)

KVCache = dict  # {"k", "v"[, "k_scale", "v_scale"]}, leading axis layers


def _project_qkv(lp, h, cfg: LlamaConfig):
    cd = cfg.dtype
    hd = cfg.head_dim
    B, L, _ = h.shape
    q = h @ lp["wq"].to(cd)
    k = h @ lp["wk"].to(cd)
    v = h @ lp["wv"].to(cd)
    return (q.reshape(B, L, -1, hd), k.reshape(B, L, -1, hd),
            v.reshape(B, L, -1, hd))


def _mlp_partial(lp, x, cfg: LlamaConfig):
    """The MLP's output product of rmsnorm(x), before the residual add:
    under tp a shard's partial product (its rows of w_down)."""
    cd = cfg.dtype
    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(h @ lp["w_gate"].to(cd))
    up = h @ lp["w_up"].to(cd)
    return (gate * up) @ lp["w_down"].to(cd)


def one_shard(parts):
    """``reduce`` for a single shard: its partial product is the sum."""
    return parts


@torch.no_grad()
def ragged_step(params: List[Params], tokens: torch.Tensor,
                token_pos: torch.Tensor, token_page: torch.Tensor,
                token_slot: torch.Tensor, page_table: torch.Tensor,
                q_start: torch.Tensor, q_len: torch.Tensor,
                kv_len: torch.Tensor, kv: List[KVCache], cfg: LlamaConfig,
                paged_impl: Optional[str] = None,
                max_q_len: Optional[int] = None,
                decode_rows: int = 0,
                reduce: Callable = one_shard
                ) -> Tuple[torch.Tensor, List[KVCache]]:
    """ONE forward over a ragged mixed prefill+decode batch.

    tokens/token_pos: [T] ragged token ids and absolute positions;
    token_page/token_slot: [T] each token's destination in the page pool
    (padding tokens -> the scratch page); page_table [R, max_pages] +
    q_start/q_len/kv_len [R]: the per-row ragged descriptors (int32).

    params, kv: the shards' parameters and pools, one each per shard;
    the descriptors are copied to each shard's device (a no-op where
    they are there already) and the argmax comes from the first shard's
    device.

    Returns (next_tok [R] int32, kv): per row, the argmax of the logits
    at its LAST valid token. ``kv`` is updated in place.
    """
    shards, pools = params, kv
    desc = (tokens, token_pos, token_page, token_slot, page_table,
            q_start, q_len, kv_len)
    descs = [tuple(t.to(p["embed"].device) for t in desc) for p in shards]
    T = tokens.shape[0]
    cd = cfg.dtype
    quantized = "k_scale" in pools[0]
    xs = [p["embed"][d[0].long()].to(cd)[None]              # [1, T, d]
          for p, d in zip(shards, descs)]
    for i in range(cfg.n_layers):
        parts = []
        for p, d, pool, x in zip(shards, descs, pools, xs):
            (_, pos, page, slot, ptab, qs, ql, kvl) = d
            lp = layer_params(p, i)
            h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
            q, k, v = _project_qkv(lp, h, cfg)              # [1, T, H, D]
            q = _rope(q, pos, cfg.rope_theta)
            k = _rope(k, pos, cfg.rope_theta)
            kc, vc = pool["k"][i], pool["v"][i]
            ksc = pool["k_scale"][i] if quantized else None
            vsc = pool["v_scale"][i] if quantized else None
            write_ragged_kv(kc, vc, k[0], v[0], page, slot, ksc, vsc)
            o = ragged_paged_attention(
                q[0], kc, vc, ptab, qs, ql, kvl,
                k_scale=ksc, v_scale=vsc, max_q_len=max_q_len,
                decode_rows=decode_rows, impl=paged_impl)
            parts.append(o.reshape(1, T, -1).to(cd) @ lp["wo"].to(cd))
        xs = [x + o for x, o in zip(xs, reduce(parts))]
        parts = [_mlp_partial(layer_params(p, i), x, cfg)
                 for p, x in zip(shards, xs)]
        xs = [x + o for x, o in zip(xs, reduce(parts))]
    x = _rmsnorm(xs[0], shards[0]["final_norm"], cfg.norm_eps)
    q_start, q_len = descs[0][5], descs[0][6]
    last = (q_start + q_len - 1).clamp(0, T - 1).long()     # [R]
    logits = head_logits(x[0][last], shards[0]["embed"])    # [R, V] fp32
    nxt = logits.argmax(dim=-1).to(torch.int32)
    return nxt.to(tokens.device), kv


@torch.no_grad()
def ragged_decode_loop(params: List[Params], tokens: torch.Tensor,
                       positions: torch.Tensor, kv: List[KVCache],
                       page_table: torch.Tensor, seq_lens: torch.Tensor,
                       num_steps: int, cfg: LlamaConfig,
                       paged_impl: Optional[str] = None,
                       reduce: Callable = one_shard):
    """``num_steps`` greedy decode steps with one readback for the caller.

    Every batch slot is one ragged decode row (q_start = slot index,
    q_len = 1), so each step is the ragged step with T == R == max_batch.
    Tokens, positions and lengths stay on the device between steps;
    inactive slots (page table all scratch, seq_lens 1) attend to the
    scratch page. Sequences that hit EOS mid-block keep decoding into
    their OWN pages; the host truncates. ``params``, ``kv`` and
    ``reduce``: as ``ragged_step``.

    Returns (tokens_out [num_steps, B], kv, final_positions,
    final_seq_lens).
    """
    R = tokens.shape[0]
    ps = kv[0]["k"].shape[3]
    max_pages = page_table.shape[1]
    ar = torch.arange(R, dtype=torch.int32, device=tokens.device)
    ones = torch.ones(R, dtype=torch.int32, device=tokens.device)
    tok, pos, lens = tokens, positions, seq_lens
    out = []
    for _ in range(num_steps):
        page_idx = (pos // ps).clamp(0, max_pages - 1)
        token_page = page_table[ar.long(), page_idx.long()]
        tok, kv = ragged_step(params, tok, pos, token_page, pos % ps,
                              page_table, ar, ones, lens, kv, cfg,
                              paged_impl, max_q_len=1, decode_rows=R,
                              reduce=reduce)
        out.append(tok)
        pos, lens = pos + 1, lens + 1
    return torch.stack(out), kv, pos, lens


@torch.no_grad()
def copy_page(kv: KVCache, src: int, dst: int) -> KVCache:
    """Copy-on-write: duplicate page ``src`` into ``dst`` across all
    layers, pages AND int8 scales, in place."""
    for leaf in kv.values():
        leaf[:, dst] = leaf[:, src]
    return kv
