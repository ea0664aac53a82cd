#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (an uncaught error exits non-zero before the
result line is printed):
  1. require CUDA; print the card's name and power limit;
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per source, all started together) and print the build time;
  3. hold each kernel against its plain PyTorch version at the main
     path's shapes (Llama-3-8B attention: Hq 32, Hkv 8, D 128, page 16),
     bf16 and int8 pools, and time kernel, plain version and the PyTorch
     library call that computes the same function (a yardstick only);
  4. the main path: ``LLMServer`` at Llama-3-8B widths, all 32 layers,
     bf16, random weights from a seed, answering concurrent requests
     through ``__call__`` and ``stream`` (one prompt prefilled in chunks,
     one prefix-cache hit); every launch counter is set to 0 just before
     and read just after, and must match the engine's step counts;
  5. the engine against the model's full forward pass on the card: 8B
     widths, 2 layers, fp32, greedy tokens compared where the oracle's
     top-2 margin exceeds fp32 summation noise.
The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel vs plain, held per (token, head) against that row's own scale
# (a token that sees n slots has outputs of about sqrt(e / n)):
# |got - ref| <= KERNEL_RTOL * max|ref| + KERNEL_FLOOR. Both sides round
# fp32 values that differ by summation order to bf16, so they differ by
# at most one bf16 step of the row's largest value, 2^-7 of it.
KERNEL_RTOL = 2.0 ** -7
KERNEL_FLOOR = 1e-5
# the library yardstick works in bf16 inside (probabilities included), so
# it is held only to being the same function, not to the kernel's bound
LIBRARY_ATOL = 5e-2
# fp32 engine vs fp32 full forward: logits differ by summation order only
FP32_LOGIT_NOISE = 1e-3


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------ measurement


def tolerance_ratios(got, ref):
    """|got - ref| / (KERNEL_RTOL * max|ref| + KERNEL_FLOOR), worst over
    the head dim, per (token, head): [T, H]. At most 1 passes."""
    err = (got.float() - ref.float()).abs().amax(-1)
    return err / (KERNEL_RTOL * ref.float().abs().amax(-1) + KERNEL_FLOOR)


def time_ms(fn, iters=10, flush=None):
    """Mean device time of fn() over iters calls, CUDA events around each
    call only; ``flush`` (a large tensor) is rewritten before each call
    so the 50 MB L2 holds none of the inputs, as in the engine, where
    every layer reads another slice of the pool."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def attention_bound_ms(q, k_pages, q_len, kv_len, token_vis, scales):
    """Least time for ragged attention on these inputs: each active row's
    visible K/V (and int8 scales) read once, q read and o written once,
    over HBM bandwidth; or 4 * vis * Hq * D FLOP per token at the bf16
    tensor-core peak. Returns (ms, "bytes" | "operations")."""
    T, Hq, D = q.shape
    _, Hkv, _, _ = k_pages.shape
    kv_slots = int(kv_len[q_len > 0].sum())
    nbytes = 2 * kv_slots * Hkv * D * k_pages.element_size()
    if scales:
        nbytes += 2 * kv_slots * Hkv * 2
    nbytes += 2 * q.numel() * q.element_size()
    flops = 4 * int(token_vis.long().sum()) * Hq * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------- phase 3: the kernel


def mixed_batch(device, Hq=32, Hkv=8, D=128, ps=16, P=512, max_pages=128,
                decode_lens=(1, 17, 100, 333, 512, 700, 1000, 1500),
                chunks=((512, 188), (300, 0)), capacity=8 + 2 * 512,
                seed=0):
    """A ragged batch with the main path's geometry (8 decode slots, two
    prefill rows of up to 512 tokens, 1032 tokens): one decode row per
    slot (slot 6 inactive, q_len 0), then prefill chunks of (tokens,
    prefix tokens) — the first straddles pages after its prefix, the
    second leaves the end of the token capacity to padding."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = [(i, 0 if i == 6 else 1, n) for i, n in enumerate(decode_lens)]
    t0 = len(decode_lens)
    for c, pre in chunks:
        rows.append((t0, c, c + pre))
        t0 += c
    assert t0 <= capacity
    perm = torch.randperm(P - 1, generator=g, device=device) + 1
    pt = torch.zeros(len(rows), max_pages, dtype=torch.int32, device=device)
    used = 0
    for r, (_, _, L) in enumerate(rows):
        npg = -(-L // ps)
        pt[r, :npg] = perm[used:used + npg]
        used += npg
    desc = [torch.tensor(x, dtype=torch.int32, device=device)
            for x in zip(*rows)]
    q = torch.randn(capacity, Hq, D, generator=g, device=device).bfloat16()
    kp = torch.randn(P, Hkv, ps, D, generator=g, device=device).bfloat16()
    vp = torch.randn(P, Hkv, ps, D, generator=g, device=device).bfloat16()
    return q, kp, vp, pt, *desc


def sdpa_inputs(q, kp, vp, pt, q_start, q_len, kv_len, k_scale, v_scale):
    """K/V gathered into contiguous padded rows, q padded per row, and the
    ragged causal mask, for one ``scaled_dot_product_attention`` call
    computing the same function (built once, not timed)."""
    from ray_tpu_torch.ops.paged_attention import _token_descriptors
    Hq, D = q.shape[1], q.shape[2]
    Hkv, ps = kp.shape[1], kp.shape[2]
    rows = [r for r in range(len(q_len)) if int(q_len[r]) > 0]
    C = max(int(q_len[r]) for r in rows)
    Lk = max(int(kv_len[r]) for r in rows)
    qpad = torch.zeros(len(rows), Hq, C, D, dtype=q.dtype, device=q.device)
    ks = torch.zeros(len(rows), Hkv, Lk, D, dtype=q.dtype, device=q.device)
    vs = torch.zeros_like(ks)
    mask = torch.zeros(len(rows), 1, C, Lk, dtype=torch.bool,
                       device=q.device)
    for i, r in enumerate(rows):
        s0, n, L = int(q_start[r]), int(q_len[r]), int(kv_len[r])
        qpad[i, :, :n] = q[s0:s0 + n].transpose(0, 1)
        pages = pt[r, :-(-L // ps)].long()
        for dst, pool, sc in ((ks, kp, k_scale), (vs, vp, v_scale)):
            x = pool[pages].float()
            if sc is not None:
                x = x * sc[pages].float()[..., None]
            x = x.permute(1, 0, 2, 3).reshape(Hkv, -1, D)[:, :L]
            dst[i, :, :L] = x.to(q.dtype)
        j = torch.arange(n, device=q.device)[:, None]
        mask[i, 0, :n, :L] = torch.arange(L, device=q.device)[None, :] \
            < (L - n + j + 1)
    _, token_vis = _token_descriptors(q_start, q_len, kv_len, q.shape[0])
    return qpad, ks, vs, mask, rows, token_vis


def phase_kernel(device):
    import torch.nn.functional as F
    from ray_tpu_torch.ops import paged_attention as tpa
    from ray_tpu_torch.ops.int8 import quantize_kv

    q, kp, vp, pt, qs, ql, kl = mixed_batch(device)
    T = q.shape[0]
    owned = torch.zeros(T, dtype=torch.bool, device=device)
    for s, n in zip(qs.tolist(), ql.tolist()):
        owned[s:s + n] = True
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    ksc8, vsc8 = None, None
    out = {}
    for pools in ("bf16", "int8"):
        if pools == "int8":
            k, ksc8 = quantize_kv(kp)
            v, vsc8 = quantize_kv(vp)
        else:
            k, v = kp, vp
        sc = dict(k_scale=ksc8, v_scale=vsc8) if pools == "int8" else {}
        got = tpa.ragged_paged_attention(q, k, v, pt, qs, ql, kl, **sc)
        ref = tpa.ragged_paged_attention_reference(q, k, v, pt, qs, ql, kl,
                                                   **sc)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ratio = tolerance_ratios(got, ref).max().item()
        assert torch.isfinite(got).all(), f"{pools}: non-finite output"
        assert ratio <= 1, f"{pools}: kernel vs plain at {ratio} x the limit"
        assert bool((got[~owned] == 0).all()), f"{pools}: padding not 0"
        kern_ms = time_ms(lambda: tpa.ragged_paged_attention(
            q, k, v, pt, qs, ql, kl, **sc), flush=flush)
        plain_ms = time_ms(lambda: tpa.ragged_paged_attention_reference(
            q, k, v, pt, qs, ql, kl, **sc), iters=3, flush=flush)
        sq, sk, sv, mask, rows, token_vis = sdpa_inputs(
            q, k, v, pt, qs, ql, kl, ksc8, vsc8)
        lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                                 enable_gqa=True)
        for i, r in enumerate(rows):
            s0, n = int(qs[r]), int(ql[r])
            lib_err = (lib_out[i, :, :n].transpose(0, 1).float()
                       - ref[s0:s0 + n].float()).abs().max().item()
            assert lib_err <= LIBRARY_ATOL, \
                f"SDPA yardstick differs {lib_err}"
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask, enable_gqa=True), flush=flush)
        bound_ms, bound_by = attention_bound_ms(q, k, ql, kl, token_vis,
                                                pools == "int8")
        log(f"ragged_paged_attention {pools} pools T={T} rows={len(kl)}: "
            f"max_abs_err {err:.3e}, worst {ratio:.3f} x the tolerance, "
            f"kernel {kern_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f}"
            f" ms ({bound_by})")
        out[pools] = dict(max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    # the decode loop's shape: 8 decode rows, T == R == 8
    dq, dk, dv, dpt, dqs, dql, dkl = mixed_batch(device, chunks=(),
                                                 capacity=8)
    dgot = tpa.ragged_paged_attention(dq, dk, dv, dpt, dqs, dql, dkl)
    dref = tpa.ragged_paged_attention_reference(dq, dk, dv, dpt, dqs, dql,
                                                dkl)
    derr = (dgot.float() - dref.float()).abs().max().item()
    dratio = tolerance_ratios(dgot, dref).max().item()
    assert dratio <= 1, f"decode shape: kernel vs plain at {dratio} x"
    # the tolerance's margin against a planted fault: each decode row
    # loses its last visible slot (an off-by-one); every row must then
    # fail the check, the 1500-slot row included
    fault = tpa.ragged_paged_attention_reference(dq, dk, dv, dpt, dqs, dql,
                                                 dkl - 1)
    rows = ((dql > 0) & (dkl > 1)).nonzero().flatten()
    caught = tolerance_ratios(fault, dref).amax(-1)[rows]
    assert bool((caught > 1).all()), f"planted fault not caught: {caught}"
    log(f"planted fault (each decode row drops its last slot): rows of kv "
        f"{dkl[rows].tolist()} fail at "
        f"{[round(x, 1) for x in caught.tolist()]} x the tolerance")
    _, dvis = tpa._token_descriptors(dqs, dql, dkl, 8)
    dms = time_ms(lambda: tpa.ragged_paged_attention(
        dq, dk, dv, dpt, dqs, dql, dkl), flush=flush)
    dplain = time_ms(lambda: tpa.ragged_paged_attention_reference(
        dq, dk, dv, dpt, dqs, dql, dkl), iters=3, flush=flush)
    dbound, dby = attention_bound_ms(dq, dk, dql, dkl, dvis, False)
    log(f"ragged_paged_attention bf16 pools decode T=8: max_abs_err "
        f"{derr:.3e}, worst {dratio:.3f} x the tolerance, kernel {dms:.4f} ms, plain {dplain:.4f} ms, bound "
        f"{dbound:.4f} ms ({dby})")
    del flush
    return out


# -------------------------------------------------- phase 4: main path


MAIN_MODEL = {"preset": "llama3_8b", "param_dtype": "bfloat16"}
MAIN_ENGINE = {"page_size": 16, "total_pages": 512, "max_batch": 8,
               "max_seq_len": 2048, "decode_chunk": 8, "seed": 0,
               "device": "cuda"}


def _prompt(seed, n, vocab):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=g).tolist()


def phase_main_path(model_config=None, engine_config=None):
    """LLMServer end to end; returns the engine's stats and launches."""
    from ray_tpu_torch.llm.serve_llm import LLMServer
    from ray_tpu_torch.ops import paged_attention as tpa

    t0 = time.monotonic()
    srv = LLMServer(model_config or MAIN_MODEL, engine_config or MAIN_ENGINE)
    eng = srv.engine
    cfg = eng.cfg
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    kv_bytes = sum(t.numel() * t.element_size() for t in eng.kv.values())
    w_bytes = sum(t.numel() * t.element_size()
                  for t in [eng.params["embed"], eng.params["final_norm"],
                            *eng.params["layers"].values()])
    log(f"main path: {cfg.n_layers} layers dim {cfg.dim} vocab "
        f"{cfg.vocab_size} {cfg.dtype}, weights {w_bytes} bytes, KV pool "
        f"{kv_bytes} bytes, set-up {time.monotonic() - t0:.1f} s")
    V = cfg.vocab_size
    chunk = eng.prefill_chunk
    prefix = _prompt(1, 256, V)
    reqs = [("stream", _prompt(2, chunk + 188, V), 24),     # chunked
            ("call", prefix + _prompt(3, 40, V), 16),        # publishes
            ("call", _prompt(4, 20, V), 32),
            ("stream", _prompt(5, 9, V), 32)]
    results = [None] * len(reqs)
    ttft = {}

    def run(i, kind, prompt, max_tokens):
        t_sub = time.monotonic()
        if kind == "call":
            results[i] = srv({"prompt_ids": prompt,
                              "max_tokens": max_tokens})["token_ids"]
            return
        toks, stamps = [], []
        for item in srv.stream({"prompt_ids": prompt,
                                "max_tokens": max_tokens}):
            if item.get("done"):
                assert item["token_ids"] == toks
                break
            toks += item["token_ids"]
            stamps.append(time.monotonic())
        ttft[i] = (stamps[0] - t_sub, len(toks), stamps[-1] - stamps[0])
        results[i] = toks

    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    try:
        t_wave = time.monotonic()
        threads = [threading.Thread(target=run, args=(i, *r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive(), "request thread hung"
        wave_s = time.monotonic() - t_wave
        # after the first wave published the shared prefix: a hit, alone
        # (one ragged step, two decode dispatches), timed; then the same
        # request again under the profiler for the device's busy time
        hit_req = {"prompt_ids": prefix + _prompt(6, 30, V),
                   "max_tokens": 16}
        t_hit = time.monotonic()
        hit = srv(hit_req)["token_ids"]
        hit_ms = (time.monotonic() - t_hit) * 1e3
        _, busy = profile_device(lambda: srv(hit_req), eng.device, hit_ms)
        srv.check_health()
    finally:
        srv.shutdown()
    launches = dict(tpa.launch_counts)
    stats = srv.stats()
    for (kind, prompt, max_tokens), toks in zip(reqs, results):
        assert toks is not None and len(toks) == max_tokens, (kind, toks)
        assert all(0 <= t < V for t in toks)
    assert len(hit) == 16
    assert stats["prefix_cache"]["hit_tokens"] >= 256, stats
    assert stats["ragged_dispatches"] >= 3, stats     # chunked prefill
    expected = cfg.n_layers * (stats["ragged_dispatches"]
                               + eng.decode_chunk
                               * stats["decode_dispatches"])
    n_tok = sum(len(t) for t in results)
    log(f"main path: {len(reqs) + 2} requests, {n_tok} tokens in the "
        f"first wave in {wave_s:.2f} s ({n_tok / wave_s:.1f} tokens/s), "
        f"stats {json.dumps(stats)}")
    for i, (t_first, n, span) in sorted(ttft.items()):
        rate = (n - 1) / span if span > 0 else float("nan")
        log(f"main path: stream request {i} ({len(reqs[i][1])} prompt "
            f"tokens): TTFT {t_first * 1e3:.1f} ms, decode "
            f"{rate:.1f} tokens/s over {n} tokens")
    log(f"main path: prefix-hit request alone: {hit_ms:.1f} ms; the same "
        f"request under the profiler: {busy}")
    log(f"main path: launches {launches}, expected ragged_paged_attention "
        f"{expected}")
    return stats, launches, expected


def profile_device(fn, device, unprofiled_ms):
    """Run fn() under torch.profiler; returns (result, summary): the
    device's busy time (kernel time, one stream), its share of
    ``unprofiled_ms`` (the same work timed without the profiler, whose
    host cost would otherwise inflate the idle share), and the kernels
    taking most of it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    top = "; ".join(f"{k[:60]} x{n} {ms:.2f} ms" for ms, n, k in rows[:6])
    return out, (f"device busy {busy_ms:.1f} ms = {busy_ms / unprofiled_ms:.1%}"
                 f" of the unprofiled wall time, top: {top}")


# --------------------------------------------- phase 5: engine vs oracle


def phase_oracle(device, cfg=None):
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.models.llama import (LlamaConfig, forward,
                                            init_params)

    cfg = cfg or LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device=device)
    eng = InferenceEngine(cfg, params, page_size=16, total_pages=64,
                          max_batch=4, max_seq_len=256, prefill_chunk=16,
                          decode_chunk=4, device=device)
    prompts = [_prompt(7, 37, cfg.vocab_size), _prompt(8, 9, cfg.vocab_size)]
    rids = [eng.add_request(p, 8) for p in prompts]
    done = {}
    for _ in range(100):
        done.update(eng.step())
        if all(r in done for r in rids):
            break
    compared = 0
    for rid, prompt in zip(rids, prompts):
        toks = list(prompt)
        for got in done[rid]:
            logits = forward(params, torch.tensor([toks], device=device),
                             cfg)[0, -1]
            top2 = logits.topk(2)
            want = int(top2.indices[0])
            margin = float(top2.values[0] - top2.values[1])
            if got != want:
                assert margin < FP32_LOGIT_NOISE, \
                    f"engine {got} vs oracle {want} at margin {margin}"
                break
            compared += 1
            toks.append(want)
    assert compared >= 8, f"only {compared} tokens compared"
    log(f"engine vs full forward (dim {cfg.dim}, vocab {cfg.vocab_size}, "
        f"{cfg.n_layers} layers, fp32): {compared} of 16 greedy tokens "
        f"compared equal, stats {json.dumps(eng.stats)}")


# ------------------------------------------------------------------ main


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (REPO / "ray_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no ray_tpu_torch sources beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)

    from ray_tpu_torch.ops import _kernels
    t0 = time.monotonic()
    built = _kernels.build()
    log(f"kernels built in {time.monotonic() - t0:.1f} s: "
        f"{sorted(built) or 'all up to date'}")

    kern = phase_kernel(device)
    stats, launches, expected = phase_main_path()
    assert launches["ragged_paged_attention"] == expected, \
        (launches, expected)
    assert launches["ragged_paged_attention_reference_cuda"] == 0, \
        "the plain attention ran on CUDA tensors in the main path"
    phase_oracle(device)

    bf16 = kern["bf16"]
    record = {"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:340",
        "launches": launches["ragged_paged_attention"],
        "max_abs_err": max(k["max_abs_err"] for k in kern.values()),
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"]}]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
