"""The bf16 ragged kernel's order of arithmetic and its grid, on the CPU.

The CUDA kernel runs only on the card. What it computes in another order
than the plain version is emulated here in plain PyTorch: decode rows walk
splits of pages and merge them in split order (the decode op's
``_paged_decode_reference``); prefill rows run q blocks of BM tokens x the
query heads of one kv head over 64-slot key tiles with an online softmax,
p rounded to bf16 before p.v, and int8 scales applied where the kernel
applies them (k_scale on the score column after q.k^T, v_scale folded into
p before the rounding). The emulation is held to the card's per-(token,
head) limit against the port's plain version and against the JAX
package's Pallas kernel in interpret mode. The grid plan is checked to
give every owned token to exactly one block and no padding token to any.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops.int8 import quantize_kv

torch.set_num_threads(1)

# chip_smoke.py's and the card tests' limit for the ragged kernel, per
# (token, head): 2^-7 of the row's largest output, plus 1e-5
CARD_RTOL, CARD_FLOOR = 2.0 ** -7, 1e-5
KEYS = 64   # slots of the kernel's key tiles

# the engine's geometry, cut down: 5 decode slots (one inactive), two
# prefill rows of up to 40 tokens: a chunk of 40 after a 50-token prefix
# (it straddles pages and crosses q-block and key-tile edges) and a first
# chunk of 21; the token capacity 5 + 2 * 40 leaves 19 tokens of padding
DECODE_LENS = (1, 17, 130, 0, 300)
CHUNKS = ((40, 50), (21, 0))
CAPACITY = 5 + 2 * 40


def _batch(seed, Hq=8, Hkv=2, D=128, ps=16, max_pages=20, P=48):
    rng = np.random.default_rng(seed)
    rows = [(i, 0 if n == 0 else 1, n) for i, n in enumerate(DECODE_LENS)]
    t0 = len(DECODE_LENS)
    for c, pre in CHUNKS:
        rows.append((t0, c, c + pre))
        t0 += c
    pt = np.zeros((len(rows), max_pages), np.int32)
    perm = rng.permutation(P - 1) + 1
    used = 0
    for r, (_, _, L) in enumerate(rows):
        npg = -(-L // ps)
        pt[r, :npg] = perm[used:used + npg]
        used += npg
    q = rng.standard_normal((CAPACITY, Hq, D), np.float32)
    kp = rng.standard_normal((P, Hkv, ps, D), np.float32)
    vp = rng.standard_normal((P, Hkv, ps, D), np.float32)
    qs, ql, kl = (np.array(x, np.int32) for x in zip(*rows))
    return q, kp, vp, pt, qs, ql, kl


def _pools(kp, vp, pools):
    """bf16 pools, or int8 pools with their bf16 scales (the port's
    quantize_kv, whose values equal the JAX package's)."""
    k, v = torch.from_numpy(kp), torch.from_numpy(vp)
    if pools == "int8":
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        return k8, v8, ks, vs
    return k.bfloat16(), v.bfloat16(), None, None


def _emulate(q, k, v, ks, vs, pt, qs, ql, kl, plan, scale):
    """The kernel's order of arithmetic in plain PyTorch (fp32 products of
    bf16 values; the kernel's exponentials are 2^x of log2-scaled scores,
    the same values up to fp32 rounding)."""
    T, Hq, D = q.shape
    _, Hkv, ps, _ = k.shape
    qpk, bm = Hq // Hkv, plan.block_tokens
    max_kv = pt.shape[1] * ps
    int8 = ks is not None
    out = torch.zeros(T, Hq, D)
    # decode rows: the decode op's split walk and merge; int8 V meets p in
    # fp32, so the walk gets pools dequantized to fp32 (p is not rounded)
    for r in range(plan.decode_rows):
        if ql[r] <= 0:
            continue
        t = int(qs[r])
        if int8:
            kd = k.float() * ks.float()[..., None]
            vd = v.float() * vs.float()[..., None]
            o = tpa._paged_decode_reference(
                q[t:t + 1].float(), kd, vd, pt[r:r + 1], kl[r:r + 1], scale,
                tpa.RAGGED_PAGES_PER_SPLIT)
        else:
            o = tpa._paged_decode_reference(
                q[t:t + 1], k, v, pt[r:r + 1], kl[r:r + 1], scale,
                tpa.RAGGED_PAGES_PER_SPLIT)
        out[t] = o[0].bfloat16().float()
    # prefill rows: q blocks of bm tokens x qpk heads (token-major rows),
    # every kv head at once, over 64-slot key tiles
    for r in range(plan.decode_rows, len(ql)):
        n_q, L = int(ql[r]), int(kl[r])
        for j0 in range(0, n_q, bm):
            n_tok = min(bm, n_q - j0)
            vis = torch.tensor([min(max(L - n_q + j0 + j + 1, 0), max_kv)
                                for j in range(n_tok)])
            t0 = int(qs[r]) + j0
            qb = q[t0:t0 + n_tok].float().reshape(n_tok, Hkv, qpk, D)
            qb = qb.permute(1, 0, 2, 3).reshape(Hkv, n_tok * qpk, D)
            row_vis = vis.repeat_interleave(qpk)             # [rows]
            m = torch.full((Hkv, n_tok * qpk), float("-inf"))
            l = torch.zeros(Hkv, n_tok * qpk)
            acc = torch.zeros(Hkv, n_tok * qpk, D)
            for s0 in range(0, int(vis.max()), KEYS):
                pos = torch.arange(s0, s0 + KEYS)
                ok = pos < int(vis.max())
                page = pt[r, (pos // ps).clamp(max=pt.shape[1] - 1)].long()
                kt = k[page, :, pos % ps].float().permute(1, 0, 2)
                vt = v[page, :, pos % ps].float().permute(1, 0, 2)
                kt, vt = kt * ok[:, None], vt * ok[:, None]  # zero-filled
                s = torch.einsum("hrd,hcd->hrc", qb, kt) * scale
                if int8:   # the column's k scale, after q.k^T
                    s = s * (ks[page, :, pos % ps].float().T * ok)[:, None]
                s = s.masked_fill(pos[None, None, :]
                                  >= row_vis[None, :, None], float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                base = torch.where(torch.isinf(m_new), 0.0, m_new)
                corr = torch.exp(m - base)
                p = torch.exp(s - base[..., None])
                l = l * corr + p.sum(-1)                     # unrounded p
                if int8:   # v scale folded into p before the rounding
                    p = p * (vs[page, :, pos % ps].float().T * ok)[:, None]
                acc = acc * corr[..., None] + torch.einsum(
                    "hrc,hcd->hrd", p.bfloat16().float(), vt)
                m = m_new
            o = acc / l.clamp_min(1e-30)[..., None]
            o = o.reshape(Hkv, n_tok, qpk, D).permute(1, 0, 2, 3)
            out[t0:t0 + n_tok] = o.reshape(n_tok, Hq, D).bfloat16().float()
    return out.bfloat16()


def _ratio(got, want):
    """Worst |got - want| / (CARD_RTOL * max|want| + CARD_FLOOR) over the
    (token, head) rows; at most 1 passes."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max(-1)
    return float((err / (CARD_RTOL * np.abs(want).max(-1)
                         + CARD_FLOOR)).max())


def _owned(qs, ql, T):
    owned = np.zeros(T, bool)
    for s, n in zip(qs, ql):
        owned[int(s):int(s) + int(n)] = True
    return owned


def _check_kernel_order(pools, **geometry):
    q, kp, vp, pt, qs, ql, kl = _batch(5, **geometry)
    k, v, ks, vs = _pools(kp, vp, pools)
    tq = torch.from_numpy(q).bfloat16()
    tpt, tqs, tql, tkl = (torch.from_numpy(a) for a in (pt, qs, ql, kl))
    D = q.shape[-1]
    scale = D ** -0.5
    plan = tpa.ragged_plan(CAPACITY, len(ql), q.shape[1], kp.shape[1],
                           pt.shape[1], decode_rows=len(DECODE_LENS),
                           max_q_len=40)
    got = _emulate(tq, k, v, ks, vs, tpt, tqs, tql, tkl, plan, scale)
    sc = dict(k_scale=ks, v_scale=vs) if ks is not None else {}
    plain = tpa.ragged_paged_attention_reference(
        tq, k, v, tpt, tqs, tql, tkl, **sc, max_q_len=40,
        decode_rows=len(DECODE_LENS))
    assert _ratio(got.float(), plain.float()) <= 1

    def jx(x):
        return None if x is None else jnp.asarray(x.float().numpy(),
                                                  jnp.bfloat16)
    jk, jv = (jnp.asarray(x.numpy()) if x.dtype == torch.int8 else jx(x)
              for x in (k, v))
    pallas = jpa._ragged_attention_pallas(
        jx(tq), jk, jv, *(jnp.asarray(a) for a in (pt, qs, ql, kl)),
        jx(ks), jx(vs), scale, interpret=True)
    pallas = np.asarray(pallas.astype(jnp.float32))
    assert _ratio(got.float(), pallas) <= 1
    owned = _owned(qs, ql, CAPACITY)
    assert bool((got[torch.from_numpy(~owned)] == 0).all())


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_kernel_order_holds_the_card_limit(pools):
    _check_kernel_order(pools)


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_kernel_order_at_the_serving_benchmark_geometry(pools):
    # bench_llm.py's widths: head dim 64 (one 128-byte box a row, 4 k steps
    # of q.k^T, p.v on m64n64), pages of 32, 2 query heads per kv head
    # (32-token q blocks)
    _check_kernel_order(pools, Hq=16, Hkv=8, D=64, ps=32)


@pytest.mark.parametrize("decode_rows", [0, len(DECODE_LENS)])
@pytest.mark.parametrize("max_q_len", [None, 40, 7])
@pytest.mark.parametrize("Hq", [8, 16, 2])
def test_grid_plan_gives_every_owned_token_to_one_block(decode_rows,
                                                        max_q_len, Hq):
    # 7 is below the longest chunk: a wrong hint that costs time only
    _, _, _, pt, qs, ql, _ = _batch(0)
    R, Hkv = len(ql), 2
    plan = tpa.ragged_plan(CAPACITY, R, Hq, Hkv, pt.shape[1], decode_rows,
                           max_q_len)
    bm = plan.block_tokens
    assert bm == tpa.RAGGED_TILE_ROWS // (Hq // Hkv)
    C = CAPACITY if max_q_len is None else max_q_len
    assert plan.prefill_blocks == (R - decode_rows) * -(-C // bm) * Hkv
    assert plan.decode_blocks == decode_rows * Hkv * plan.splits
    writes = np.zeros((CAPACITY, Hkv), int)   # blocks writing (token, head)
    for i in range(plan.prefill_blocks):
        r, b, h = tpa.ragged_prefill_block(plan, R, Hkv, i)
        assert plan.decode_rows <= r < R and 0 <= b < plan.q_blocks
        while b * bm < ql[r]:
            j = np.arange(b * bm, min(b * bm + bm, ql[r]))
            writes[qs[r] + j, h] += 1
            b += plan.q_blocks
    for r in range(plan.decode_rows):      # the splits' merge writes
        if ql[r] > 0:
            writes[qs[r]] += 1
    owned = _owned(qs, ql, CAPACITY)
    assert (writes[owned] == 1).all() and (writes[~owned] == 0).all()
