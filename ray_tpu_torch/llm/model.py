"""Cache-aware Llama forward passes for inference — the PyTorch port of
``ray_tpu/llm/model.py`` (tensor parallelism not yet ported).

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
the same dict.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _mlp(lp, x, cfg: LlamaConfig):
    cd = cfg.dtype
    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(h @ lp["w_gate"].to(cd))
    up = h @ lp["w_up"].to(cd)
    return x + (gate * up) @ lp["w_down"].to(cd)


@torch.no_grad()
def ragged_step(params: Params, tokens: torch.Tensor,
                token_pos: torch.Tensor, token_page: torch.Tensor,
                token_slot: torch.Tensor, page_table: torch.Tensor,
                q_start: torch.Tensor, q_len: torch.Tensor,
                kv_len: torch.Tensor, kv: KVCache, cfg: LlamaConfig,
                paged_impl: Optional[str] = None,
                max_q_len: Optional[int] = None,
                decode_rows: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """ONE forward over a ragged mixed prefill+decode batch.

    tokens/token_pos: [T] ragged token ids and absolute positions;
    token_page/token_slot: [T] each token's destination in the page pool
    (padding tokens -> the scratch page); page_table [R, max_pages] +
    q_start/q_len/kv_len [R]: the per-row ragged descriptors (int32).

    Returns (next_tok [R] int32, kv): per row, the argmax of the logits
    at its LAST valid token. ``kv`` is updated in place.
    """
    T = tokens.shape[0]
    cd = cfg.dtype
    x = params["embed"][tokens.long()].to(cd)[None]        # [1, T, d]
    quantized = "k_scale" in kv
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(lp, h, cfg)                  # [1, T, H, D]
        q = _rope(q, token_pos, cfg.rope_theta)
        k = _rope(k, token_pos, cfg.rope_theta)
        kc, vc = kv["k"][i], kv["v"][i]
        ksc = kv["k_scale"][i] if quantized else None
        vsc = kv["v_scale"][i] if quantized else None
        write_ragged_kv(kc, vc, k[0], v[0], token_page, token_slot,
                        ksc, vsc)
        o = ragged_paged_attention(
            q[0], kc, vc, page_table, q_start, q_len, kv_len,
            k_scale=ksc, v_scale=vsc, max_q_len=max_q_len,
            decode_rows=decode_rows, impl=paged_impl)
        x = x + o.reshape(1, T, -1).to(cd) @ lp["wo"].to(cd)
        x = _mlp(lp, x, cfg)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    last = (q_start + q_len - 1).clamp(0, T - 1).long()     # [R]
    logits = head_logits(x[0][last], params["embed"])       # [R, V] fp32
    return logits.argmax(dim=-1).to(torch.int32), kv


@torch.no_grad()
def ragged_decode_loop(params: Params, tokens: torch.Tensor,
                       positions: torch.Tensor, kv: KVCache,
                       page_table: torch.Tensor, seq_lens: torch.Tensor,
                       num_steps: int, cfg: LlamaConfig,
                       paged_impl: Optional[str] = None):
    """``num_steps`` greedy decode steps with one readback for the caller.

    Every batch slot is one ragged decode row (q_start = slot index,
    q_len = 1), so each step is the ragged step with T == R == max_batch.
    Tokens, positions and lengths stay on the device between steps;
    inactive slots (page table all scratch, seq_lens 1) attend to the
    scratch page. Sequences that hit EOS mid-block keep decoding into
    their OWN pages; the host truncates.

    Returns (tokens_out [num_steps, B], kv, final_positions,
    final_seq_lens).
    """
    R = tokens.shape[0]
    ps = kv["k"].shape[3]
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
                              paged_impl, max_q_len=1, decode_rows=R)
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
