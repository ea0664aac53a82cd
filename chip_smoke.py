#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (an uncaught error exits non-zero before the
result line is printed):
  1. require CUDA; print the card's name and power limit;
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per source, all started together), print the build time and what
     ``-Xptxas -v`` says of the bf16 kernels redesigned for Hopper (the
     flash forward, dq and dk/dv, the ragged kernel, the decode op's ring
     walk and its merge: registers, barriers, stack and spill bytes);
  3. hold each kernel against its plain PyTorch version at the main
     path's shapes (Llama-3-8B attention: Hq 32, Hkv 8, D 128, page 16),
     bf16 and int8 pools, and time kernel, plain version and the PyTorch
     library call that computes the same function (a yardstick only);
 3b. the decode op ``paged_attention`` at the same widths: a decode batch
     of 8 up to 2048 tokens (bf16 and fp32 pools), one of 8 x 8192 (bf16)
     and batch C at bench_llm.py's widths, split as ``decode_plan`` says,
     the kernel against both plain versions (the split one at the plan's
     split size), a planted fault that must fail on every row, a length-0
     row that must come back 0, two calls equal bit for bit, times beside
     the bound and SDPA, and the kernel at other split sizes;
  4. the main path: ``LLMServer`` at Llama-3-8B widths, all 32 layers,
     bf16, random weights from a seed, answering concurrent requests
     through ``__call__`` and ``stream`` (one prompt prefilled in chunks,
     one prefix-cache hit); every launch counter is set to 0 just before
     and read just after, and must match the engine's step counts. The
     flight recorder is on (the default): each request's TTFT, TPOT and
     end-to-end time from its record beside the external timer, held to
     bench_llm.py's rule (|record - timer| <= max(5 ms, 15%)), and the
     TTFT and end-to-end times also trailing the timer by 0 to 10 ms,
     where the same times stamped at each dispatch's launch must trail it
     by more (what a launch-time stamp would read); the engine
     gauges after a forced update; the step programs dispatched (the
     first engine of the process: at most 3); one request sent under an
     ambient trace, whose log records must carry its request id and that
     trace id, as its record does;
 3c. (run after phase 4, whose program count it would join) the decode op
     on the engine's own decode steps (Llama-3-8B widths, 2 layers, the
     main path's engine): on every decode-loop step it runs beside the
     ragged kernel on the same live pools and must agree with it; its
     launches, counted from 0, must be layers x decode steps;
  5. the engine against the model's full forward pass on the card: 8B
     widths, 2 layers, fp32, greedy tokens compared where the oracle's
     top-2 margin exceeds fp32 summation noise;
 5b. the JAX package's serving widths (bench_llm.py: dim 1024, 16 / 8
     heads, head dim 64, pages of 32): phase 3 on its batches, a server
     (2 layers, bf16) answering phase 4's requests with its launches
     counted and phase 4's recorder checks, and phase 5's oracle (fp32);
     phase 3b's batch C is the decode op at these widths; then
     bench_llm.py's recorder A/B (8 requests x 64 tokens of decode wall
     time, recorder off and on, printed), and ``LLMBatchPredictor`` over
     8 rows (fp32), whose tokens and finish reasons must equal the
     engine's ``generate`` on the same prompts;
  6. hold the three flash-attention kernels (forward, dq, dk/dv) against
     their plain versions at the training path's shape (B 8, H 24, L 2048,
     D 128, bf16; causal, non-causal, and causal with an lse cotangent),
     catch two planted faults on every 64-row query tile, check that the
     backward repeats bit for bit, and time kernels, plain versions and
     the PyTorch library call, each kernel with its achieved TFLOP/s and
     its share of the bound, and dq + dk/dv against the library's whole
     backward; then the same checks at lengths no kernel tile divides (L
     72, 200 and 1000, and Lq 72 against Lk 200), the planted causal fault
     included;
  7. the training main path: ``make_train_step`` over ``loss_fn`` at the
     JAX package's bench widths (vocab 32000, dim 3072, 8 layers, 24/12
     heads, ffn 12288: 1,230,818,304 parameters; flash attention, selective
     remat), fp32 master weights from seed 0, bf16 compute, ``Adafactor``
     (bench.py's optax.adafactor(1e-3)), B 8 x L 2048 tokens from seed 1:
     2 warm-up and 5 timed steps on one batch, the flash launch counters
     set to 0 just before and read just after; then the step profiler's
     phases and the gauges it sets, and the device's busy share of one
     step; then AdamW (optax.adamw's defaults, the earlier optimizer), 2
     warm-up and 3 timed steps on the same configuration, for comparison;
  8. training oracle on the card: bench widths, 2 layers, fp32, B 1 x L
     256: loss and every gradient with the flash kernels against plain
     full attention;
  9. the optimizer on the card: three Adafactor steps on a small fp32
     tree (factored and full second moments) against the same steps on
     the CPU;
 10. Mixtral training: ``make_train_step`` over the Mixtral ``loss_fn`` at
     Mixtral-8x7B's widths (vocab 32000, dim 4096, 32 q / 8 kv heads, ffn
     14336, 8 experts, top-2, rope theta 1e6) cut to 2 of 32 layers
     (3,033,616,384 parameters, 919,687,168 active), fp32 master weights
     from seed 0, bf16 compute, ``Adafactor(lr=1e-3)``, B 4 x L 2048 from
     seed 1: 2 warm-up and 3 timed steps with remat "full" (the JAX
     default), then 3 with "selective" (the first untimed), every port
     launch counter set to 0 just before and read just after (the JAX
     Mixtral runs no Pallas kernel, so all must stay 0); step time,
     tokens/s, MFU on active parameters, peak memory, the MoE's host
     reads, tokens per expert per layer, the step profiler's phases, and
     one step under torch.profiler split into expert products, dispatch,
     attention, router and the rest; then the same model's bf16 routing
     against its own fp32 forward (B 1 x L 512), which must agree on
     every token whose fp32 2nd/3rd probability gap exceeds
     ``ROUTING_MARGIN``, and a small fp32 Mixtral on the card against the
     CPU (loss, aux, routing, every gradient);
 11. RL on the card: the port's local-mode runtime
     (``ray_tpu_torch.init(local_mode=True, num_cpus=4)``), then PPO,
     IMPALA and DQN on CartPole and SAC on Pendulum at the JAX tests'
     settings (tests/test_rllib.py), each ``build(device="cuda")`` and
     ``train()``ed until the JAX test's gate on the best episode-return
     mean, every port launch counter set to 0 before and read after (all
     must stay 0: no Pallas kernel lies on this path); per algorithm the
     iteration ms split into sampling and the learner update, the update
     alone, one profiled update's device busy share, the check that a
     runner's weights do not move with the learner's, and one update of
     a fresh learner on the card against the CPU (fp32, each leaf within
     1e-5 of its largest value);
 12. data, batch inference and BC on the card, in the port's local mode:
     12a. ``batch_inference`` at the main path's widths (phase 4's model
     and engine: Llama-3-8B, all 32 layers, bf16, random weights from the
     engine's seed) over 16 rows made with ``data.from_items`` (prompts
     of 5 to 1,000 tokens) in 4 blocks through ``ActorPoolStrategy(1)``,
     32 new tokens each: the ragged launches, counted from 0, must equal
     the pool's engine's count as phase 4 computes it, the plain version
     must never run on CUDA tensors, every row must come back with its id
     and prompt and with 32 tokens or a stop, and equal
     ``LLMBatchPredictor`` called directly on the same blocks with the
     same weights (built once the pool's engine is gone); rows/s,
     generated tokens/s, the stage's ExecStats and both peaks printed;
     12b. the same at the bench widths in fp32 through
     ``ActorPoolStrategy(2)``: every row's tokens and finish reason equal
     ``generate`` on that prompt alone, both engines' launches counted;
     12c. BC: a PPO teacher (phase 11's PPO) to its gate,
     ``record_dataset`` of 8192 rows (obs fp32, action int32), then
     ``BCConfig(dataset, lr 1e-3, batch 512, seed 11).build(device=
     "cuda")`` to a best mean of 100 within 15 iterations
     (tests/test_rllib.py:239), every port launch counter at 0, the
     epoch's time split into batch iteration and learner updates, and one
     BC update on the card against the CPU (each leaf within 1e-5);
 13. Tune's Population Based Training over the train step:
     ``make_train_step`` over ``loss_fn`` at phase 7's widths cut to 2 of
     its 8 layers, fp32 master weights from seed 0, bf16 compute,
     ``Adafactor(lr=cfg["lr"])``, B 2 x L 2048 from seed 1; 4 trials with
     lr 1e-3, 1e-3, 3e-1, 3e-1, 2 at once, 4 reports of 2 steps each, a
     checkpoint (params and Adafactor state) at every 2nd report; PBT
     (perturbation interval 2, quantile 0.5, lr resampled from
     loguniform(1e-4, 3e-3), seed 0) on the loss; the flash launches,
     counted from 0, must equal the count for the steps the trials ran
     (re-runs after a restore included), trial 0's first two losses a
     standalone run's, each exploited trial's first loss its donor's at
     that iteration (1e-6 of itself), and both lr-3e-1 trials must end
     lower than their last loss before their exploit; checkpoint bytes,
     pickling and loading seconds, each trial's step ms against one
     alone, and the peak memory printed.
Each phase from 12 on prints its time, and the script its whole time.
The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import functools
import json
import math
import re
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
# decode op vs plain, per (sequence, head) against the row's own scale.
# bf16: the ragged kernel's limit. The kernel's splits round p to bf16
# against their own running maximum, the single walk against its own, and
# the gather version not at all; each of these moves an fp32 output by
# less than a bf16 step, so the outputs' roundings differ by at most one
# step, as for summation order. One step at the row's largest value m
# reads 2^-7 m / (2^-7 m + 1e-5): just under 1 where m is about 1, as on
# the engine's live pools; only fp32 outputs a whole step apart could
# pass 1. fp32: summation order and the merge's exponentials only.
DECODE_TOL = {torch.float32: (1e-5, 1e-6),
              torch.bfloat16: (KERNEL_RTOL, KERNEL_FLOOR)}
# fp32 engine vs fp32 full forward: logits differ by summation order only
FP32_LOGIT_NOISE = 1e-3
# flash kernels vs plain, bf16, per row against the row's own scale: one
# bf16 step for the outputs' rounding (2^-7 of the row's largest value),
# and one more because the forward's 128-key tiles and the plain
# version's 256-key blocks rescale p by different running maxima before
# rounding it to bf16 (the plain version at the kernels' tiles against its
# 256-row blocks is held to this limit on the CPU,
# tests/test_torch_flash_attention.py); the gradients' L-term sums in
# another order add fp32 noise far below that
FLASH_RTOL = 2.0 ** -6
# lse is fp32 from the same scores: a sum of L <= 2048 terms in another
# order moves l by at most L * 2^-24 ~ 1.2e-4 relative, lse by as much
LSE_ATOL = 2.0 ** -12
# training oracle, fp32 flash kernels vs plain full attention: gradients
# per leaf within 5e-5 of the leaf's largest value, loss within 1e-5 of
# itself (about 30x the 1.7e-6 and 1e-7 seen on the CPU at reduced width)
TRAIN_ORACLE_RTOL = 5e-5
TRAIN_ORACLE_LOSS_RTOL = 1e-5


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------ measurement


def tolerance_ratios(got, ref):
    """|got - ref| / (KERNEL_RTOL * max|ref| + KERNEL_FLOOR), worst over
    the head dim, per (token, head): [T, H]. At most 1 passes."""
    err = (got.float() - ref.float()).abs().amax(-1)
    return err / (KERNEL_RTOL * ref.float().abs().amax(-1) + KERNEL_FLOOR)


def flash_ratios(got, ref):
    """|got - ref| / (FLASH_RTOL * max|ref| + KERNEL_FLOOR) per row of
    [BH, L, D] tensors: [BH, L]. At most 1 passes."""
    err = (got.float() - ref.float()).abs().amax(-1)
    return err / (FLASH_RTOL * ref.float().abs().amax(-1) + KERNEL_FLOOR)


def decode_ratios(got, ref):
    """|got - ref| / (rtol * max|ref| + floor) per (sequence, head) of
    [B, Hq, D] outputs, the limits by ref's dtype (DECODE_TOL): [B, Hq].
    At most 1 passes."""
    rtol, floor = DECODE_TOL[ref.dtype]
    err = (got.float() - ref.float()).abs().amax(-1)
    return err / (rtol * ref.float().abs().amax(-1) + floor)


def time_ms(fn, iters=10, flush=None, clean=False):
    """Mean device time of fn() over iters calls, CUDA events around each
    call only; ``flush`` (a large tensor) is rewritten before each call
    so the 50 MB L2 holds none of the inputs, as in the engine, where
    every layer reads another slice of the pool. Rewriting it leaves the
    L2 full of dirty lines, whose write-back a call that reads much pays
    for; with ``clean`` the flush reads the tensor instead, leaving clean
    lines (the kernel times chip_smoke.py prints are taken without it).
    A spin kernel of about 1 ms then keeps the device busy while the host
    records the start event and enqueues the call, so a call whose host
    side (checks, allocations, ctypes: tens of microseconds per wrapper
    call) outlasts the flush is not charged for it: the time is the
    device's."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.sum() if clean else flush.zero_()
        torch.cuda._sleep(2_000_000)
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


def ptxas_report(build_log, kernel):
    """What ``-Xptxas -v`` says of one kernel (the entries whose mangled
    name holds ``kernel``): for one entry its lines joined (stack and
    spill bytes, registers and barriers); for a template built several
    times, the number of entries, the range of their registers and the
    largest spill and stack bytes."""
    entries, inside = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
            if inside:
                entries.append([])
        elif inside and ("spill" in line or "Used" in line):
            entries[-1].append(line.replace("ptxas info    :", "").strip())
    assert entries and all(entries), f"no ptxas report for {kernel}"
    if len(entries) == 1:
        return "; ".join(entries[0])

    lines = sum(entries, [])

    def most(pattern, lines):
        return max(int(m) for ln in lines for m in re.findall(pattern, ln))
    regs = [most(r"Used (\d+) registers", e) for e in entries]
    stack = most(r"(\d+) bytes stack", lines)
    stores = most(r"(\d+) bytes spill stores", lines)
    loads = most(r"(\d+) bytes spill loads", lines)
    return (f"{len(entries)} instantiations, {min(regs)}-{max(regs)} "
            f"registers, at most {stack} bytes stack, {stores} bytes spill "
            f"stores, {loads} bytes spill loads")


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


def ragged_profile(fn, device, ms, flush):
    """One call of fn under the profiler, the L2 flushed before it: the
    ragged kernels' CUDA launches and device time. A window that records
    no device activity (seen once in a run of several) is taken again."""
    for _ in range(3):
        flush.zero_()
        _, summary = profile_device(fn, device, ms, focus=("ragged",))
        if "ragged x0 " not in summary:
            break
    return summary


def phase_kernel(device, geometry=None):
    """The ragged kernel against its plain version on the mixed batch (bf16
    and int8 pools) and the decode batch, at the main path's geometry or
    at ``geometry`` (Hq, Hkv, D, ps), with planted faults, times, and (at
    the main path's geometry only) other split sizes and the profiler."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import paged_attention as tpa
    from ray_tpu_torch.ops.int8 import quantize_kv

    extras = geometry is None
    geometry = geometry or {}
    tag = "".join(f" {k}={v}" for k, v in geometry.items())
    q, kp, vp, pt, qs, ql, kl = mixed_batch(device, **geometry)
    T = q.shape[0]
    owned = torch.zeros(T, dtype=torch.bool, device=device)
    for s, n in zip(qs.tolist(), ql.tolist()):
        owned[s:s + n] = True
    # the engine's hints: its max_batch decode rows, chunks of up to 512
    hints = dict(decode_rows=MAIN_ENGINE["max_batch"], max_q_len=512)
    prefill_rows = torch.arange(len(ql), device=device) >= hints[
        "decode_rows"]
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
        got = tpa.ragged_paged_attention(q, k, v, pt, qs, ql, kl, **sc,
                                         **hints)
        ref = tpa.ragged_paged_attention_reference(q, k, v, pt, qs, ql, kl,
                                                   **sc, **hints)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ratio = tolerance_ratios(got, ref).max().item()
        assert torch.isfinite(got).all(), f"{pools}: non-finite output"
        assert ratio <= 1, f"{pools}: kernel vs plain at {ratio} x the limit"
        assert bool((got[~owned] == 0).all()), f"{pools}: padding not 0"
        # planted prefill fault: each prefill token drops its last visible
        # slot; every prefill token must then fail the check on some head.
        # Not every (token, head): a head whose dropped slot had a tiny
        # probability moves by less than the limit; their share is logged
        fault = tpa.ragged_paged_attention_reference(
            q, k, v, pt, qs, ql, kl - prefill_rows.int(), **sc, **hints)
        pre = torch.zeros_like(owned)
        for s, n in zip(qs[prefill_rows].tolist(), ql[prefill_rows].tolist()):
            pre[s:s + n] = True
        caught = tolerance_ratios(fault, ref)[pre]          # [tokens, Hq]
        assert bool((caught.amax(-1) > 1).all()), \
            f"{pools}: prefill fault not caught: {caught.amax(-1).min()}"
        log(f"planted fault ({pools}: each prefill token drops its last "
            f"slot): all {caught.shape[0]} prefill tokens fail, the weakest "
            f"at {caught.amax(-1).min().item():.1f} x the limit; "
            f"{(caught > 1).float().mean().item():.1%} of their (token, "
            f"head) pairs fail")
        kern_ms = time_ms(lambda: tpa.ragged_paged_attention(
            q, k, v, pt, qs, ql, kl, **sc, **hints), flush=flush)
        plain_ms = time_ms(lambda: tpa.ragged_paged_attention_reference(
            q, k, v, pt, qs, ql, kl, **sc, **hints), iters=3, flush=flush)
        launches = ragged_profile(lambda: tpa.ragged_paged_attention(
            q, k, v, pt, qs, ql, kl, **sc, **hints), device, kern_ms,
            flush) if extras else "not taken"
        sweep = {n: round(time_ms(lambda: tpa._ragged_attention_cuda(
            q, k, v, pt, qs, ql, kl, ksc8, vsc8, q.shape[-1] ** -0.5,
            pages_per_split=n, **hints), flush=flush), 4)
            for n in ((4, 16, 32) if extras else ())}
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
        log(f"ragged_paged_attention{tag} {pools} pools T={T} rows="
            f"{len(kl)}: "
            f"max_abs_err {err:.3e}, worst {ratio:.3f} x the tolerance, "
            f"kernel {kern_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f}"
            f" ms ({bound_by}); kernel ms with other pages_per_split: "
            f"{sweep}; one call under the profiler: {launches}")
        out[pools] = dict(max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    # the decode loop's shape: 8 decode rows, T == R == 8
    dq, dk, dv, dpt, dqs, dql, dkl = mixed_batch(device, chunks=(),
                                                 capacity=8, **geometry)
    dhints = dict(decode_rows=8, max_q_len=1)   # as ragged_decode_loop
    dgot = tpa.ragged_paged_attention(dq, dk, dv, dpt, dqs, dql, dkl,
                                      **dhints)
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
        dq, dk, dv, dpt, dqs, dql, dkl, **dhints), flush=flush)
    dlaunches = ragged_profile(lambda: tpa.ragged_paged_attention(
        dq, dk, dv, dpt, dqs, dql, dkl, **dhints), device, dms,
        flush) if extras else "not taken"
    dsweep = {n: round(time_ms(lambda: tpa._ragged_attention_cuda(
        dq, dk, dv, dpt, dqs, dql, dkl, None, None, dq.shape[-1] ** -0.5,
        pages_per_split=n, **dhints), flush=flush), 4)
        for n in ((4, 16, 32) if extras else ())}
    dplain = time_ms(lambda: tpa.ragged_paged_attention_reference(
        dq, dk, dv, dpt, dqs, dql, dkl), iters=3, flush=flush)
    dbound, dby = attention_bound_ms(dq, dk, dql, dkl, dvis, False)
    sq, sk, sv, mask, rows, _ = sdpa_inputs(dq, dk, dv, dpt, dqs, dql, dkl,
                                            None, None)
    lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                             enable_gqa=True)
    lib_err = (lib_out[:, :, 0].float()
               - dref[dqs[rows].long()].float()).abs().max().item()
    assert lib_err <= LIBRARY_ATOL, f"SDPA yardstick differs {lib_err}"
    dlib = time_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask, enable_gqa=True), flush=flush)
    log(f"ragged_paged_attention{tag} bf16 pools decode T=8: max_abs_err "
        f"{derr:.3e}, worst {dratio:.3f} x the tolerance, kernel "
        f"{dms:.4f} ms, plain {dplain:.4f} ms, sdpa {dlib:.4f} ms, bound "
        f"{dbound:.4f} ms ({dby}); kernel ms with other pages_per_split: "
        f"{dsweep}; one call under the profiler: {dlaunches}")
    del flush
    out["decode"] = dict(max_abs_err=derr, ms=dms, plain_ms=dplain,
                         library_ms=dlib, bound_ms=dbound, bound_by=dby)
    return out


# ------------------------------------------------- phase 3b: the decode op

# name: (seq_lens, max_pages, pool pages, pool dtypes, geometry). A: the
# serving config's decode batch (8 slots, max_seq_len 2048, a 512-page
# pool; 310 pages used). B: 8 sequences at Llama 3's 8192-token context.
# C: bench_llm.py's serving widths (Hq 16, Hkv 8, head dim 64, pages of
# 32; max_seq_len 512 and a 1024-page pool) at lengths around its edges.
BENCH_GEOMETRY = {"Hq": 16, "Hkv": 8, "D": 64, "ps": 32}
DECODE_BATCHES = {
    "A": ((1, 15, 16, 17, 300, 1024, 1500, 2048), 128, 512,
          (torch.bfloat16, torch.float32), {}),
    "B": ((8192,) * 8, 512, 4100, (torch.bfloat16,), {}),
    "C": ((1, 31, 32, 33, 128, 300, 500, 512), 16, 1024,
          (torch.bfloat16, torch.float32), BENCH_GEOMETRY),
}


def decode_batch(device, lens, max_pages, P, dtype, Hq=32, Hkv=8, D=128,
                 ps=16, seed=3):
    """One decode token per sequence at the main path's attention widths;
    each sequence's pages drawn without repeats from 1..P-1, the table's
    tail left at page 0 (the scratch page)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(len(lens), Hq, D, generator=g, device=device).to(dtype)
    kp = torch.randn(P, Hkv, ps, D, generator=g, device=device).to(dtype)
    vp = torch.randn(P, Hkv, ps, D, generator=g, device=device).to(dtype)
    perm = torch.randperm(P - 1, generator=g, device=device) + 1
    pt = torch.zeros(len(lens), max_pages, dtype=torch.int32, device=device)
    used = 0
    for b, n in enumerate(lens):
        npg = -(-n // ps)
        pt[b, :npg] = perm[used:used + npg]
        used += npg
    assert used < P
    return q, kp, vp, pt, torch.tensor(lens, dtype=torch.int32,
                                       device=device)


def decode_sdpa_inputs(q, kp, vp, pt, lens):
    """q as [B, Hq, 1, D], K/V gathered into contiguous [B, Hkv, L, D] (L
    the longest length) and the length mask [B, 1, 1, L]: one
    ``scaled_dot_product_attention`` call computing the decode op (built
    once, not timed)."""
    B, Hq, D = q.shape
    _, Hkv, ps, _ = kp.shape
    L = int(lens.max())
    pages = pt[:, :-(-L // ps)].long()
    ks, vs = (pool[pages].permute(0, 2, 1, 3, 4).reshape(B, Hkv, -1, D)
              [:, :, :L].contiguous() for pool in (kp, vp))
    mask = torch.arange(L, device=q.device)[None, :] < lens[:, None]
    return q[:, :, None], ks, vs, mask[:, None, None, :]


def phase_decode(device):
    """The decode op on batches A, B and C, split as ``decode_plan``
    says: the kernel against the split plain version (at the plan's split
    size) and the gather version, the planted fault, a length-0 row, two
    calls equal bit for bit, and the times of kernel, plain version and
    SDPA beside the bound, and of the kernel at other split sizes."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import paged_attention as tpa

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {}
    for name, (lens, max_pages, P, dtypes, geometry) in \
            DECODE_BATCHES.items():
        for dtype in dtypes:
            key = f"{name} {str(dtype).split('.')[-1]}"
            q, kp, vp, pt, sl = decode_batch(device, lens, max_pages, P,
                                             dtype, **geometry)
            scale = q.shape[-1] ** -0.5
            # the split size the wrapper takes: decode_plan's, from shapes
            plan = tpa.decode_plan(q.shape[0], q.shape[1], kp.shape[1],
                                   max_pages, kp.shape[2])
            pps = plan.pages_per_split
            got = tpa.paged_attention(q, kp, vp, pt, sl)
            again = tpa.paged_attention(q, kp, vp, pt, sl)
            split = tpa._paged_decode_reference(q, kp, vp, pt, sl, scale,
                                                pps)
            gather = tpa.paged_attention_reference(q, kp, vp, pt, sl)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), f"{key}: non-finite output"
            assert torch.equal(got, again), f"{key}: calls differ"
            r_split = decode_ratios(got, split).max().item()
            r_gather = decode_ratios(got, gather).max().item()
            assert r_split <= 1 and r_gather <= 1, \
                f"{key}: kernel at {r_split} / {r_gather} x the limit"
            err = max((got.float() - ref.float()).abs().max().item()
                      for ref in (split, gather))
            # planted fault: every sequence drops its last slot; every row
            # longer than 1 slot must then fail the check
            fault = tpa._paged_decode_reference(q, kp, vp, pt, sl - 1,
                                                scale, pps)
            caught = decode_ratios(fault, split).amax(-1)[sl > 1]
            assert bool((caught > 1).all()), \
                f"{key}: planted fault not caught: {caught}"
            # a length-0 row comes back exactly 0, the others as before
            sl0 = sl.clone()
            sl0[0] = 0
            got0 = tpa.paged_attention(q, kp, vp, pt, sl0)
            assert bool((got0[0] == 0).all()), f"{key}: length 0 not 0"
            assert torch.equal(got0[1:], got[1:]), f"{key}: rows moved"
            ms = time_ms(lambda: tpa.paged_attention(q, kp, vp, pt, sl),
                         flush=flush)
            plain_ms = time_ms(lambda: tpa._paged_decode_reference(
                q, kp, vp, pt, sl, scale, pps), iters=3, flush=flush)
            # for the record: other splits (the path takes the plan's),
            # and the split and merge launches' device times
            sweep = {n: round(time_ms(lambda: tpa._paged_attention_cuda(
                q, kp, vp, pt, sl, scale, n), flush=flush), 4)
                for n in sorted({max(1, pps // 2), 2 * pps, 4, 8, 16, 32}
                                - {pps}) if n <= max_pages}
            flush.zero_()
            _, busy = profile_device(lambda: tpa.paged_attention(
                q, kp, vp, pt, sl), device, ms)
            sq, sk, sv, mask = decode_sdpa_inputs(q, kp, vp, pt, sl)
            lib_out = F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True)
            lib_err = (lib_out[:, :, 0].float() - gather.float()).abs() \
                .max().item()
            assert lib_err <= LIBRARY_ATOL, \
                f"{key}: SDPA yardstick differs {lib_err}"
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True), flush=flush)
            del sq, sk, sv, mask
            vis = sl.clamp(0, max_pages * kp.shape[2])
            bound, by = attention_bound_ms(q, kp, torch.ones_like(sl), vis,
                                           vis, False)
            log(f"paged_attention {key} pools B={len(lens)} Hq "
                f"{q.shape[1]} Hkv {kp.shape[1]} D {q.shape[2]} page "
                f"{kp.shape[2]} max_pages {max_pages} lens {list(lens)}: "
                f"worst {r_split:.3f} x the "
                f"limit against the split plain version, {r_gather:.3f} "
                f"against the gather version, max_abs_err {err:.3e}; "
                f"planted fault (each row drops its last slot) fails on "
                f"every row longer than 1, the weakest at "
                f"{caught.min().item():.1f} x the limit; length 0 gives 0; "
                f"two calls give the same bits; plan {tuple(plan)}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); kernel "
                f"ms with other pages_per_split: {sweep}; one call under "
                f"the profiler: {busy}")
            out[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound, bound_by=by)
            del q, kp, vp, pt, sl, got, again, split, gather, fault, got0
    del flush
    return out


def phase_decode_engine(model_config=None, engine_config=None):
    """The decode op on the engine's own decode steps. Two requests, the
    second hitting the first's 256-token prefix in the page cache, are
    served through ``InferenceEngine`` (Llama-3-8B widths, 2 layers, the
    main path's engine otherwise). Each decode-loop attention call (every
    batch slot one row of one token: decode_rows == R == T) also runs
    ``paged_attention`` on the same live pools, page table and lengths,
    held against the ragged kernel's output. The launch counters are set
    to 0 just before and read just after, and the decode op's launches
    must equal layers x decode steps; returns them."""
    from ray_tpu_torch.llm import model as M
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.ops import paged_attention as tpa

    cfg = model_config_from_dict(model_config
                                 or {**MAIN_MODEL, "n_layers": 2})
    eng = InferenceEngine(cfg, **(engine_config or MAIN_ENGINE))
    ragged = M.ragged_paged_attention
    seen = {"calls": 0, "worst": 0.0}

    def ragged_and_decode(q, k_pages, v_pages, page_table, q_start, q_len,
                          kv_len, **kw):
        o = ragged(q, k_pages, v_pages, page_table, q_start, q_len, kv_len,
                   **kw)
        if kw.get("decode_rows") == page_table.shape[0] == q.shape[0]:
            d = tpa.paged_attention(q, k_pages, v_pages, page_table, kv_len)
            seen["worst"] = max(seen["worst"], decode_ratios(d, o).max()
                                .item())
            seen["calls"] += 1
        return o

    V = cfg.vocab_size
    prefix = _prompt(1, 256, V)
    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    M.ragged_paged_attention = ragged_and_decode
    try:
        for seed, n in ((9, 40), (10, 20)):
            rid = eng.add_request(prefix + _prompt(seed, n, V), 24)
            done = {}
            for _ in range(100):
                done.update(eng.step())
                if rid in done:
                    break
            assert len(done.get(rid, ())) == 24, done
    finally:
        M.ragged_paged_attention = ragged
    launches = dict(tpa.launch_counts)
    stats = dict(eng.stats)
    steps = cfg.n_layers * eng.decode_chunk * stats["decode_dispatches"]
    del eng
    log(f"paged_attention on the engine's decode steps ({cfg.n_layers} "
        f"layers, dim {cfg.dim}, {cfg.dtype}): {seen['calls']} calls beside "
        f"the ragged kernel, worst {seen['worst']:.3f} x the limit; "
        f"launches {launches}; stats {json.dumps(stats)}")
    assert stats["cached_tokens"] >= 256, stats     # the prefix's pages
    assert seen["worst"] <= 1, f"decode vs ragged at {seen['worst']} x"
    assert seen["calls"] == steps > 0, (seen, steps)
    assert launches["paged_attention"] == steps, (launches, steps)
    assert launches["paged_attention_reference_cuda"] == 0, launches
    assert launches["ragged_paged_attention_reference_cuda"] == 0, launches
    return launches["paged_attention"]


# flash kernel: (products, input rows, output rows) of one call
FLASH_WORK = {
    "flash_attention_fwd": (2, ("q", "k", "k"), ("q",)),        # q k v -> o
    "flash_attention_dq": (3, ("q", "k", "k", "q"), ("q",)),    # +do -> dq
    "flash_attention_dkv": (4, ("q", "k", "k", "q"), ("k", "k")),  # -> dk dv
}


def flash_flops(kernel, BH, Lq, Lk, D, causal):
    """The FLOP one flash kernel call needs: the (query, key) pairs the
    mask lets through times 2·D per product (fwd 2 products: q·kᵀ, p·v;
    dq 3: q·kᵀ, do·vᵀ, ds·k; dkv 4: q·kᵀ, do·vᵀ, pᵀ·do, dsᵀ·q)."""
    pairs = (sum(min(i + 1, Lk) for i in range(Lq)) if causal
             else Lq * Lk) * BH
    return FLASH_WORK[kernel][0] * 2 * D * pairs


def flash_bound_ms(kernel, BH, Lq, Lk, D, causal, itemsize):
    """Least time for one flash kernel call: its FLOP (``flash_flops``)
    at the bf16 tensor-core peak, or each input read and each output
    written once at the HBM rate. Returns (ms, "bytes" | "operations")."""
    _, rows_in, rows_out = FLASH_WORK[kernel]
    rows = sum(Lq if r == "q" else Lk for r in rows_in + rows_out)
    nbytes = BH * D * itemsize * rows
    nbytes += 4 * BH * Lq * (1 if kernel == "flash_attention_fwd" else 2)
    t_ops = flash_flops(kernel, BH, Lq, Lk, D, causal) / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------- phase 4: main path


MAIN_MODEL = {"preset": "llama3_8b", "param_dtype": "bfloat16"}
MAIN_ENGINE = {"page_size": 16, "total_pages": 512, "max_batch": 8,
               "max_seq_len": 2048, "decode_chunk": 8, "seed": 0,
               "device": "cuda"}
# the JAX package's serving benchmark (bench_llm.py:29-33): dim 1024, 16
# query / 8 kv heads (head dim 64), pages of 32, bf16; 2 of its 8 layers
BENCH_MODEL = {"preset": "tiny", "vocab_size": 32000, "dim": 1024,
               "n_layers": 2, "n_heads": 16, "n_kv_heads": 8,
               "ffn_dim": 2816, "rope_theta": 500000.0,
               "param_dtype": "bfloat16"}
BENCH_ENGINE = {"page_size": 32, "total_pages": 1024, "max_batch": 8,
                "max_seq_len": 512, "decode_chunk": 32, "prefill_chunk": 128,
                "seed": 0, "device": "cuda"}


def _prompt(seed, n, vocab):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=g).tolist()


def agrees(record_s, timer_s):
    """bench_llm.py's rule for a flight-recorder time against an external
    timer: |record - timer| <= max(5 ms, 15% of the timer)."""
    return abs(record_s - timer_s) <= max(0.005, 0.15 * timer_s)


#: how far a caller's timer may run past the record's first-token and
#: finish times: the record starts after the timer and stops where the
#: tokens reach the host, before the caller's thread takes them (the
#: largest lag seen was 2.2 ms; the interpreter's switch interval, 5 ms,
#: bounds a woken thread's wait for the GIL). A stamp taken at the
#: dispatch's launch would read short by the whole dispatch.
READBACK_LAG_S = 0.010


def _stamp_launches(fns, stamps):
    """Append the host clock to ``stamps`` as each step dispatch of the
    engine's step functions ``fns`` is launched."""
    for name in ("ragged_step", "decode_loop"):
        def stamped(*args, _inner=getattr(fns, name), **kwargs):
            stamps.append(time.monotonic())
            return _inner(*args, **kwargs)
        setattr(fns, name, stamped)


def phase_main_path(model_config=None, engine_config=None,
                    launch_stamp_fails=True):
    """LLMServer end to end; returns the engine's stats, the launches,
    the launches expected, and the step programs dispatched in this
    process before and after the phase. The recorder's first-token and
    finish times must trail the caller's timers by 0 to READBACK_LAG_S;
    with ``launch_stamp_fails`` the same times read at each dispatch's
    launch must trail them by more (where a dispatch outlasts the lag,
    so the check tells the two stamps apart)."""
    from ray_tpu_torch.llm.serve_llm import LLMServer
    from ray_tpu_torch.ops import paged_attention as tpa
    from ray_tpu_torch.util import log_plane, metrics, trace_context

    t0 = time.monotonic()
    srv = LLMServer(model_config or MAIN_MODEL, engine_config or MAIN_ENGINE)
    eng = srv.engine
    cfg = eng.cfg
    programs_before = eng.compiled_step_programs()
    assert eng.request_log is not None, "the recorder is on by default"
    launch_ts = []
    _stamp_launches(eng._fns, launch_ts)
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
    # request -> (rid, external TTFT, TPOT and end-to-end seconds; the
    # first two only where a stream shows when its tokens arrive)
    timers = {}
    trace_id = trace_context.new_trace_id()
    traced = 1                  # the request sent under an ambient trace

    def run(i, kind, prompt, max_tokens):
        ctx = trace_context.activate(trace_id, trace_context.new_span_id()) \
            if i == traced else None
        try:
            t_sub = time.monotonic()
            if kind == "call":
                out = srv({"prompt_ids": prompt, "max_tokens": max_tokens})
                results[i] = out["token_ids"]
                timers[i] = (out["request_id"], None, None,
                             time.monotonic() - t_sub)
                return
            toks, stamps = [], []
            for item in srv.stream({"prompt_ids": prompt,
                                    "max_tokens": max_tokens}):
                if item.get("done"):
                    assert item["token_ids"] == toks
                    break
                toks += item["token_ids"]
                stamps.append(time.monotonic())
            timers[i] = (item["request_id"], stamps[0] - t_sub,
                         (stamps[-1] - stamps[0]) / (len(toks) - 1),
                         time.monotonic() - t_sub)
            results[i] = toks
        finally:
            if ctx is not None:
                trace_context.deactivate(ctx)

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
        hit_out = srv(hit_req)
        hit = hit_out["token_ids"]
        hit_ms = (time.monotonic() - t_hit) * 1e3
        timers[len(reqs)] = (hit_out["request_id"], None, None,
                             hit_ms / 1e3)
        _, busy = profile_device(lambda: srv(hit_req), eng.device, hit_ms,
                                 focus=("ragged",))
        srv.check_health()
    finally:
        srv.shutdown()
    launches = dict(tpa.launch_counts)
    stats = srv.stats()
    programs = eng.compiled_step_programs()
    eng._update_metrics(force=True)
    gauges = {name: m["values"][()] for name, m in metrics.snapshot().items()
              if m["type"] == "gauge" and name.startswith("llm_")}
    records = {d["rid"]: d for d in srv.request_records()}
    logs = log_plane.get_global().export()["records"]
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
    for i, (_, t_first, tpot, _) in sorted(timers.items()):
        if t_first is not None:
            log(f"main path: stream request {i} ({len(reqs[i][1])} prompt "
                f"tokens): TTFT {t_first * 1e3:.1f} ms, decode "
                f"{1 / tpot:.1f} tokens/s over {len(results[i])} tokens")
    log(f"main path: prefix-hit request alone: {hit_ms:.1f} ms; the same "
        f"request under the profiler: {busy}")
    log(f"main path: launches {launches}, expected ragged_paged_attention "
        f"{expected}")
    # the flight recorder against the external timers (bench_llm.py's
    # agreement rule): TTFT and TPOT where a stream shows when its tokens
    # arrive, end to end for every request; TTFT and e2e also against the
    # readback lag, beside what a stamp at the dispatch's launch would read
    for i, (rid, t_first, tpot, e2e) in sorted(timers.items()):
        rec = records[rid]
        t0 = eng.request_log.get(rid).t0

        def at_launch(off):
            return max(s for s in launch_ts if s <= t0 + off) - t0

        pairs = [("TTFT", rec["ttft"], t_first), ("TPOT", rec["tpot"], tpot),
                 ("e2e", rec["e2e"], e2e)]
        n_prompt = len(reqs[i][1]) if i < len(reqs) else len(
            hit_req["prompt_ids"])
        log(f"main path: request {i} ({n_prompt} prompt tokens, "
            f"{rec['n_generated']} generated, cached {rec['cached_tokens']}, "
            f"{len(rec['chunks'])} chunks): " + ", ".join(
                f"{name} record {r * 1e3:.2f} ms"
                + ("" if t is None else f" vs timer {t * 1e3:.2f} ms")
                + ("" if t is None or name == "TPOT" else
                   f" (stamped at launch {at_launch(r) * 1e3:.2f} ms)")
                for name, r, t in pairs if r is not None))
        for name, r, t in pairs:
            if t is None:
                continue
            assert agrees(r, t), \
                f"request {i}: {name} record {r} s vs timer {t} s"
            if name == "TPOT":
                continue
            assert 0 <= t - r <= READBACK_LAG_S, \
                f"request {i}: {name} timer {t} s - record {r} s"
            if launch_stamp_fails:
                assert t - at_launch(r) > READBACK_LAG_S, \
                    f"request {i}: {name} stamped at launch " \
                    f"{at_launch(r)} s vs timer {t} s: the lag check " \
                    f"cannot tell it from the readback"
    log(f"main path: gauges after _update_metrics(force=True): "
        f"{json.dumps(gauges)}")
    log(f"main path: step programs dispatched in this process: "
        f"{programs_before} before the phase, {programs} after it")
    assert programs - programs_before <= 3, (programs_before, programs)
    assert gauges["llm_compiled_step_programs"] == programs, gauges
    # the traced request's log records carry its request id and the
    # ambient trace id, as its flight-recorder record does
    rid = timers[traced][0]
    mine = [r for r in logs if r["request_id"] == rid]
    log(f"main path: log records of request {traced} ({rid}): "
        f"{[(r['level'], r['msg'], r['trace_id']) for r in mine]}")
    assert len(mine) == 2 and all(r["trace_id"] == trace_id for r in mine)
    assert records[rid]["trace_id"] == trace_id
    for j, (other, _, _, _) in timers.items():
        if j != traced:
            assert [r["trace_id"] for r in logs
                    if r["request_id"] == other] == ["", ""], j
    return stats, launches, expected, (programs_before, programs)


def profile_device(fn, device, unprofiled_ms, focus=()):
    """Run fn() under torch.profiler; returns (result, summary): the
    device's busy time (kernel time, one stream), its share of
    ``unprofiled_ms`` (the same work timed without the profiler, whose
    host cost would otherwise inflate the idle share), the kernels
    taking most of it, and for each name in ``focus`` the kernels whose
    name holds it: their time, launches and share of the busy time."""
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
    top = "; ".join(f"{k[:60]} x{n} {ms:.4f} ms" for ms, n, k in rows[:6])
    parts = []
    for name in focus:
        ms = sum(r[0] for r in rows if name in r[2])
        n = sum(r[1] for r in rows if name in r[2])
        share = ms / busy_ms if busy_ms else 0.0   # no device time on a CPU
        parts.append(f"{name} x{n} {ms:.4f} ms = {share:.1%}")
    picked = f"; of the busy time: {', '.join(parts)}" if parts else ""
    return out, (f"device busy {busy_ms:.4f} ms = "
                 f"{busy_ms / unprofiled_ms:.1%} of the unprofiled wall "
                 f"time, top: {top}{picked}")


# --------------------------------------------- phase 5: engine vs oracle


def phase_oracle(device, cfg=None, page_size=16):
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.models.llama import (LlamaConfig, forward,
                                            init_params)

    cfg = cfg or LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device=device)
    eng = InferenceEngine(cfg, params, page_size=page_size, total_pages=64,
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
            with torch.no_grad():
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
    log(f"engine vs full forward (dim {cfg.dim}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}, {cfg.n_layers} layers, "
        f"page {page_size}, fp32): {compared} of 16 greedy tokens "
        f"compared equal, stats {json.dumps(eng.stats)}")


# ------------------------------------------ phase 6: the flash kernels

FLASH_SHAPE = (8, 24, 2048, 128)    # B, H, L, D of the training path
# the planted faults must fail on every query tile of this many rows: the
# dk/dv kernel's bf16 q tiles (half of the forward's)
FLASH_TILE = 64
# the bf16 kernels redesigned for Hopper, whose ptxas report phase 2
# prints: (library, kernel)
SM90_KERNELS = (("flash_attention_fwd", "flash_fwd_sm90_kernel"),
                ("flash_attention_bwd", "flash_dq_sm90_kernel"),
                ("flash_attention_bwd", "flash_dkv_sm90_kernel"),
                ("ragged_paged_attention", "ragged_sm90_kernel"),
                ("paged_attention", "paged_decode_sm90_kernel"),
                ("paged_attention", "paged_decode_merge_sm90_kernel"))


def causal_off_by_one(q, k, v, scale):
    """A planted fault: the plain forward where query i sees keys 0..i+1,
    one more than the causal mask allows. Query i is moved to position
    i + 1 of a sequence padded by one tile (the key at position L, seen
    only by the last query, is a copy of key 0)."""
    from ray_tpu_torch.ops import flash_attention as tfa
    L = q.shape[1]
    qs = torch.cat([q[:, :1], q, q[:, :FLASH_TILE - 1]], 1)
    ks = torch.cat([k, k[:, :FLASH_TILE]], 1)
    vs = torch.cat([v, v[:, :FLASH_TILE]], 1)
    o, lse = tfa._fwd_reference(qs, ks, vs, True, scale, FLASH_TILE,
                                FLASH_TILE)
    return o[:, 1:L + 1], lse[:, 1:L + 1]


def tiles_caught(fault, ref):
    """Worst ratio to the limit within each query tile (over every bh
    and row of the tile; the last tile may be shorter):
    [ceil(L / FLASH_TILE)]."""
    r = flash_ratios(fault, ref).amax(0)
    return torch.stack([t.amax() for t in r.split(FLASH_TILE)])


def phase_flash(device):
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as tfa

    B, H, L, D = FLASH_SHAPE
    BH, scale = B * H, D ** -0.5
    g = torch.Generator(device=device).manual_seed(2)
    q, k, v, do = (torch.randn(BH, L, D, generator=g, device=device)
                   .bfloat16() for _ in range(4))
    dlse = torch.randn(BH, L, generator=g, device=device)
    names = ("flash_attention_fwd", "flash_attention_dq",
             "flash_attention_dkv")
    err = dict.fromkeys(names, 0.0)
    worst = dict.fromkeys(names, 0.0)
    for case, causal, cot in (("causal", True, None),
                              ("non-causal", False, None),
                              ("causal, lse cotangent", True, dlse)):
        o, lse = tfa._fwd_call(q, k, v, causal, scale)
        o_ref, lse_ref = tfa._fwd_reference(q, k, v, causal, scale)
        delta = (do.float() * o_ref.float()).sum(-1)
        if cot is not None:
            delta = delta - cot
        grads = tfa._bwd_call(q, k, v, o_ref, lse_ref, do, causal, scale,
                              dlse=cot)
        grads_ref = tfa._bwd_reference(q, k, v, lse_ref, do, delta, causal,
                                       scale)
        torch.cuda.synchronize()
        lse_err = (lse - lse_ref).abs().max().item()
        assert lse_err <= LSE_ATOL, f"{case}: lse off by {lse_err}"
        checks = [("flash_attention_fwd", "o", o, o_ref)] + [
            (kern, name, got, want) for kern, name, got, want in zip(
                names[1:] + names[2:], ("dq", "dk", "dv"), grads, grads_ref)]
        line = []
        for kern, name, got, want in checks:
            assert torch.isfinite(got).all(), f"{case}: {name} not finite"
            ratio = flash_ratios(got, want).max().item()
            assert ratio <= 1, f"{case}: {name} at {ratio} x the limit"
            err[kern] = max(err[kern], (got.float() - want.float()).abs()
                            .max().item())
            worst[kern] = max(worst[kern], ratio)
            line.append(f"{name} {ratio:.3f}")
        log(f"flash kernels vs plain, {case}: worst ratio to the limit "
            f"{', '.join(line)}; lse max diff {lse_err:.2e}")
    # planted faults, each must fail on every query tile
    o_ref, lse_ref = tfa._fwd_reference(q, k, v, True, scale)
    caught = tiles_caught(causal_off_by_one(q, k, v, scale)[0], o_ref)
    assert bool((caught > 1).all()), f"off-by-one not caught: {caught}"
    log(f"planted fault (causal off by one): all {caught.numel()} query "
        f"tiles fail, the weakest at {caught.min().item():.1f} x the limit")
    delta = (do.float() * o_ref.float()).sum(-1)
    right = tfa._bwd_reference(q, k, v, lse_ref, do, delta - dlse, True,
                               scale)[0]
    wrong = tfa._bwd_reference(q, k, v, lse_ref, do, delta, True, scale)[0]
    caught = tiles_caught(wrong, right)
    assert bool((caught > 1).all()), f"missing -dlse not caught: {caught}"
    log(f"planted fault (backward without - dlse): all {caught.numel()} "
        f"query tiles of dq fail, the weakest at "
        f"{caught.min().item():.1f} x the limit")

    # no atomics: the backward repeats bit for bit
    delta = (do.float() * o_ref.float()).sum(-1)
    runs = [tfa._bwd_cuda(q, k, v, lse_ref, do, delta - dlse, True, scale)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs)), "not repeatable"
    log("flash backward: two calls give the same bits (dq, dk, dv)")
    del runs

    # times at the training path's shape, causal
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    code = tfa._DTYPE_CODES[q.dtype]
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    kern_ms = {
        "flash_attention_fwd": time_ms(
            lambda: tfa._fwd_cuda(q, k, v, True, scale), flush=flush),
        "flash_attention_dq": time_ms(lambda: tfa._launch(
            "flash_attention_bwd", "flash_attention_dq", device, code, q, k,
            v, do, lse_ref, delta, dq, BH, L, L, D, 1, scale), flush=flush),
        "flash_attention_dkv": time_ms(lambda: tfa._launch(
            "flash_attention_bwd", "flash_attention_dkv", device, code, q,
            k, v, do, lse_ref, delta, dk, dv, BH, L, L, D, 1, scale),
            flush=flush)}
    fwd_plain = time_ms(lambda: tfa._fwd_reference(q, k, v, True, scale),
                        iters=3, flush=flush)
    bwd_plain = time_ms(lambda: tfa._bwd_reference(
        q, k, v, lse_ref, do, delta, True, scale), iters=3, flush=flush)
    q4, k4, v4 = (t.view(B, H, L, D).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    lib_err = (lib_out.reshape(BH, L, D).float() - o_ref.float()).abs() \
        .max().item()
    assert lib_err <= LIBRARY_ATOL, f"SDPA yardstick differs {lib_err}"
    do4 = do.view(B, H, L, D)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), flush=flush)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (q4, k4, v4), do4, retain_graph=True), flush=flush)
    plain = {"flash_attention_fwd": fwd_plain, "flash_attention_dq": bwd_plain,
             "flash_attention_dkv": bwd_plain}
    library = {"flash_attention_fwd": lib_fwd, "flash_attention_dq": lib_bwd,
               "flash_attention_dkv": lib_bwd}
    out = {}
    for kern in names:
        bound, by = flash_bound_ms(kern, BH, L, L, D, True, q.element_size())
        tflops = flash_flops(kern, BH, L, L, D, True) / kern_ms[kern] / 1e9
        out[kern] = dict(max_abs_err=err[kern], ms=kern_ms[kern],
                         plain_ms=plain[kern], library_ms=library[kern],
                         bound_ms=bound, bound_by=by)
        log(f"{kern} B {B} H {H} L {L} D {D} bf16 causal: kernel "
            f"{kern_ms[kern]:.4f} ms = {tflops:.1f} TFLOP/s, "
            f"{bound / kern_ms[kern]:.1%} of its bound; plain "
            f"{plain[kern]:.4f} ms, sdpa {library[kern]:.4f} ms, bound "
            f"{bound:.4f} ms ({by}); max_abs_err {err[kern]:.3e}, worst "
            f"{worst[kern]:.3f} x the tolerance")
    log("flash plain and sdpa times: the backward's (dq and dk/dv "
        "together) stand for both dq and dkv")
    bwd_ms = kern_ms["flash_attention_dq"] + kern_ms["flash_attention_dkv"]
    log(f"flash backward kernels, dq + dk/dv: {bwd_ms:.4f} ms = "
        f"{bwd_ms / lib_bwd:.2f} x SDPA's whole backward ({lib_bwd:.4f} ms)")
    del flush
    return out


# lengths the Pallas kernels take that no kernel tile divides (Lq, Lk):
# L <= 256 at their default blocks, L 1000 at blocks of 8, and Lq 72
# against Lk 200
FLASH_LENGTHS = ((72, 72), (200, 200), (1000, 1000), (72, 200))


def phase_flash_lengths(device):
    """The three flash kernels at FLASH_LENGTHS (B 2, H 24, D 128, bf16,
    causal and not, with an lse cotangent) against their plain versions at
    the default blocks, where the last q tile and key tile run past the
    end of every sequence; the planted causal fault must fail on every
    query tile (Lq = Lk)."""
    from ray_tpu_torch.ops import flash_attention as tfa

    B, H, D = 2, 24, 128
    BH, scale = B * H, D ** -0.5
    worst = 0.0
    for Lq, Lk in FLASH_LENGTHS:
        g = torch.Generator(device=device).manual_seed(Lq + Lk)
        q, do = (torch.randn(BH, Lq, D, generator=g, device=device)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(BH, Lk, D, generator=g, device=device)
                .bfloat16() for _ in range(2))
        dlse = torch.randn(BH, Lq, generator=g, device=device)
        line = []
        for causal in (True, False):
            o, lse = tfa._fwd_cuda(q, k, v, causal, scale)
            o_ref, lse_ref = tfa._fwd_reference(q, k, v, causal, scale)
            delta = (do.float() * o_ref.float()).sum(-1) - dlse
            grads = tfa._bwd_cuda(q, k, v, lse_ref, do, delta, causal, scale)
            grads_ref = tfa._bwd_reference(q, k, v, lse_ref, do, delta,
                                           causal, scale)
            torch.cuda.synchronize()
            lse_err = (lse - lse_ref).abs().max().item()
            assert lse_err <= LSE_ATOL, f"L {Lq}/{Lk}: lse off by {lse_err}"
            for name, got, want in zip(("o", "dq", "dk", "dv"),
                                       (o, *grads), (o_ref, *grads_ref)):
                assert got.shape == want.shape and \
                    torch.isfinite(got).all(), f"L {Lq}/{Lk}: {name}"
                ratio = flash_ratios(got, want).max().item()
                assert ratio <= 1, \
                    f"L {Lq}/{Lk} causal {causal}: {name} at {ratio} x"
                worst = max(worst, ratio)
                line.append(f"{'causal' if causal else 'full'} {name} "
                            f"{ratio:.3f}")
        fault = ""
        if Lq == Lk:
            o_ref, _ = tfa._fwd_reference(q, k, v, True, scale)
            caught = tiles_caught(causal_off_by_one(q, k, v, scale)[0],
                                  o_ref)
            assert bool((caught > 1).all()), \
                f"L {Lq}: off-by-one not caught: {caught}"
            fault = (f"; planted fault (causal off by one) fails on all "
                     f"{caught.numel()} query tiles, the weakest at "
                     f"{caught.min().item():.1f} x the limit")
        log(f"flash kernels at Lq {Lq} Lk {Lk} (BH {BH}, D {D}, bf16): "
            f"worst ratio to the limit {', '.join(line)}{fault}")
    return worst


# ------------------------------- phase 5b: recorder A/B, batch predictor


def bench_prompt(j, vocab, n=128):
    """bench_llm.py's mk_prompt: a distinct prompt per j."""
    return [(7 * i + 3 + 131 * j) % vocab for i in range(n)]


def phase_recorder_ab(model_config=None, engine_config=None):
    """bench_llm.py's recorder A/B: 8 requests x 64 new tokens of decode
    wall time on two fresh engines sharing one set of weights, recorder
    off then on, and the raw cost of one ``note_decode``. One noisy run
    of each, so printed, not asserted."""
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.llm.request_log import RequestRecord
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict

    cfg = model_config_from_dict(model_config or BENCH_MODEL)
    kw = dict(engine_config or BENCH_ENGINE)
    params = InferenceEngine(cfg, **kw).params
    uniq = iter(range(1, 10_000))

    def timed_run(recorder_on):
        e = InferenceEngine(cfg, params, request_log=recorder_on, **kw)
        for _ in range(8):
            e.add_request(bench_prompt(next(uniq), cfg.vocab_size), 64)
        e.step()                       # admit + first prefill rows
        t0 = time.perf_counter()
        while e.has_work():
            e.step()
        return time.perf_counter() - t0

    t_off = timed_run(False)
    t_on = timed_run(True)
    probe = RequestRecord("probe", 1, 1 << 20)
    t0 = time.perf_counter()
    for i in range(100_000):
        probe.note_decode(t0 + i * 1e-6, 1)
    event_ns = (time.perf_counter() - t0) / 100_000 * 1e9
    log(f"recorder A/B (bench widths, {cfg.n_layers} layers, 8 requests x "
        f"64 tokens): decode wall time off {t_off * 1e3:.1f} ms, on "
        f"{t_on * 1e3:.1f} ms, overhead {t_on / t_off - 1.0:+.2%} (one run "
        f"each); one note_decode {event_ns:.0f} ns on the host")


def phase_batch_predictor(model_config=None, engine_config=None):
    """``LLMBatchPredictor`` over 8 rows at the bench widths against the
    engine's ``generate`` on the same prompts, one at a time, on the same
    weights: tokens and finish reasons equal. fp32: a row's logits then
    differ between a batch of 8 and a request alone by summation order
    only (the ragged kernel splits a decode row by the batch's hints),
    far below the top-2 margins of greedy decoding."""
    from ray_tpu_torch.llm.batch import LLMBatchPredictor
    from ray_tpu_torch.llm.engine import InferenceEngine

    model_config = model_config or {**BENCH_MODEL, "dtype": "float32"}
    engine_config = engine_config or BENCH_ENGINE
    pred = LLMBatchPredictor(model_config, engine_config, max_new_tokens=32)
    cfg = pred.engine.cfg
    rows = [{"prompt": _prompt(20 + j, n, cfg.vocab_size), "id": j}
            for j, n in enumerate((5, 17, 40, 64, 100, 129, 200, 300))]
    t0 = time.monotonic()
    out = pred(rows)
    batch_s = time.monotonic() - t0
    alone = InferenceEngine(cfg, pred.engine.params, **engine_config)
    for row, got in zip(rows, out):
        want = alone.generate(row["prompt"], 32)
        reason = alone.request_log.snapshot()[-1]["finish_reason"]
        assert got["id"] == row["id"] and got["generated"] == want, \
            (row["id"], got["generated"], want)
        assert got["finish_reason"] == reason, (got["finish_reason"], reason)
        assert got["generated_text"] == pred.tokenizer.decode(want)
    log(f"LLMBatchPredictor (bench widths, {cfg.n_layers} layers, "
        f"{cfg.dtype}): 8 rows of 5-300 prompt tokens x 32 new in "
        f"{batch_s:.2f} s, {pred.engine.stats['ragged_dispatches']} ragged "
        f"steps; every row's tokens and finish reason "
        f"({sorted({r['finish_reason'] for r in out})}) equal generate's")


# ------------------------------------------- phase 7: training main path

TRAIN_CONFIG = dict(vocab_size=32000, dim=3072, n_layers=8, n_heads=24,
                    n_kv_heads=12, ffn_dim=12288, attention="flash",
                    remat_policy="selective")
TRAIN_BATCH = (8, 2048)             # B, L
TRAIN_WARMUP, TRAIN_STEPS = 2, 5


def make_optimizer(name):
    """bench.py trains with optax.adafactor(1e-3); "adamw" is
    optax.adamw(1e-3)'s defaults, which this phase trained with before
    Adafactor was ported."""
    from ray_tpu_torch.train import Adafactor
    return {"adafactor": functools.partial(Adafactor, lr=1e-3),
            "adamw": functools.partial(torch.optim.AdamW, lr=1e-3,
                                       weight_decay=1e-4)}[name]


def phase_train(device, config=None, batch=TRAIN_BATCH,
                optimizer="adafactor", steps=TRAIN_STEPS, profile=True):
    """make_train_step at the bench widths; returns the flash launches
    counted over the warm-up and timed steps, the steps run, and the
    layers. With ``profile``, then the step profiler (its gauges printed)
    and one step under torch.profiler."""
    from ray_tpu_torch.models.llama import (LlamaConfig, flops_per_token,
                                            init_params, loss_fn,
                                            num_params)
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.train import make_train_step, profile_train_step
    from ray_tpu_torch.util import metrics as metrics_mod

    cfg = LlamaConfig(**(config or TRAIN_CONFIG))
    B, L = batch
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=g,
                           device=device)
    loss = functools.partial(loss_fn, cfg=cfg)
    opt_name, optimizer = optimizer, make_optimizer(optimizer)
    init_fn, step_fn = make_train_step(loss, optimizer)
    opt = init_fn(params)
    cuda = device.type == "cuda"
    log(f"training: {num_params(cfg)} parameters, {cfg.n_layers} layers "
        f"dim {cfg.dim}, attention {cfg.attention}, remat "
        f"{cfg.remat_policy}, B {B} L {L}, {opt_name} "
        f"{optimizer.keywords}, set-up {time.monotonic() - t0:.1f} s")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    metrics, times = [], []
    for i in range(TRAIN_WARMUP + steps):
        t_step = time.monotonic()
        params, opt, m = step_fn(params, opt, tokens)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))  # syncs
        times.append(time.monotonic() - t_step)
    launches = dict(tfa.launch_counts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = [x for x, _ in metrics]
    assert all(math.isfinite(x) and math.isfinite(n)
               for x, n in metrics), metrics
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    step_s = sum(times[TRAIN_WARMUP:]) / steps
    tok_s = B * L / step_s
    mfu = tok_s * flops_per_token(cfg, L) / BF16_FLOPS
    state_bytes = sum(t.numel() * t.element_size()
                      for s in opt.state.values() for t in s.values()
                      if isinstance(t, torch.Tensor)
                      and t.device.type == device.type)
    log(f"training ({opt_name}): losses {[round(x, 4) for x in losses]}, "
        f"grad norms {[round(n, 4) for _, n in metrics]}")
    log(f"training: step {step_s * 1e3:.1f} ms (mean of {steps} after "
        f"{TRAIN_WARMUP} warm-up, {opt_name}), {tok_s:.0f} tokens/s, MFU "
        f"{mfu:.1%} of 989 TFLOP/s (H100 SXM dense bf16 peak), peak memory "
        f"{peak} bytes (torch.cuda.max_memory_allocated), optimizer state "
        f"{state_bytes} bytes on the card")
    log(f"training: launches {launches} over {TRAIN_WARMUP + steps} steps")
    if profile:
        bd = profile_train_step(loss, optimizer, params, opt, tokens,
                                steps=3, warmup=1, emit=True)
        log(f"training: profile_train_step step "
            f"{bd.step_time_s * 1e3:.1f} ms, first-step excess "
            f"{bd.compile_time_s * 1e3:.1f} ms, phases ms "
            f"{json.dumps({k: round(x, 2) for k, x in bd.phase_ms().items()})}")
        snap = metrics_mod.snapshot()
        gauges = {f"{name}{dict(zip(snap[name]['tag_keys'], key))}": v
                  for name in ("train_step_time_s", "train_phase_time_s")
                  for key, v in snap[name]["values"].items()}
        log(f"training: gauges set by profile_train_step(emit=True): "
            f"{json.dumps(gauges)}")
        assert gauges["train_step_time_s{}"] == bd.step_time_s, gauges
        _, busy = profile_device(lambda: step_fn(params, opt, tokens),
                                 device, step_s * 1e3,
                                 focus=("flash_fwd", "flash_dq",
                                        "flash_dkv"))
        log(f"training: one step under the profiler: {busy}")
    return launches, TRAIN_WARMUP + steps, cfg.n_layers


def expected_flash_launches(n_layers, steps):
    """Per layer per step: the forward twice (with the remat recompute),
    dq and dk/dv once; the plain versions never on CUDA tensors."""
    return {"flash_attention_fwd": 2 * n_layers * steps,
            "flash_attention_dq": n_layers * steps,
            "flash_attention_dkv": n_layers * steps,
            "flash_attention_fwd_reference_cuda": 0,
            "flash_attention_bwd_reference_cuda": 0}


# --------------------------------------------- phase 8: training oracle


def phase_train_oracle(device, config=None, batch=(1, 256)):
    """Loss and every gradient, fp32, flash kernels vs full attention."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.train import param_leaves

    cfg = LlamaConfig(**{**(config or TRAIN_CONFIG), "n_layers": 2,
                         "dtype": torch.float32})
    params = init_params(cfg, seed=3, device=device)
    g = torch.Generator(device=device).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, batch, generator=g,
                           device=device)
    results = {}
    before = dict(tfa.launch_counts)
    for attention in ("flash", "full"):
        p = {k: v.clone().requires_grad_() if isinstance(v, torch.Tensor)
             else {n: t.clone().requires_grad_() for n, t in v.items()}
             for k, v in params.items()}
        loss = loss_fn(p, tokens, dataclasses.replace(cfg,
                                                      attention=attention))
        loss.backward()
        results[attention] = (loss.item(), param_leaves(p))
    for name in ("flash_attention_fwd_reference_cuda",
                 "flash_attention_bwd_reference_cuda"):
        assert tfa.launch_counts[name] == before[name], name
    (lf, pf), (lr, pr) = results["flash"], results["full"]
    assert abs(lf - lr) <= TRAIN_ORACLE_LOSS_RTOL * abs(lr), (lf, lr)
    worst = 0.0
    for a, b in zip(pf, pr):
        rel = ((a.grad - b.grad).abs().max() / b.grad.abs().max()).item()
        assert rel <= TRAIN_ORACLE_RTOL, f"grad of {tuple(a.shape)}: {rel}"
        worst = max(worst, rel)
    log(f"training oracle (dim {cfg.dim}, vocab {cfg.vocab_size}, "
        f"{cfg.n_layers} layers, fp32, B {batch[0]} L {batch[1]}): loss "
        f"flash {lf:.6f} vs full {lr:.6f}; {len(pf)} gradients, worst "
        f"{worst:.2e} of the leaf's largest value")


# ------------------------------------------- phase 9: optimizer on the card

# leaves whose second-largest dim is at least 128 factor their second
# moments (stacked, transposed, square), the others keep a full one; one
# parameter's RMS sits under the 1e-3 floor of its scale
ADAFACTOR_TREE = {"stacked": ((4, 256, 512), 0.05),
                  "transposed": ((512, 128), 0.05),
                  "square": ((2, 256, 256), 0.05),
                  "below_128": ((127, 300), 0.05),
                  "norms": ((4, 256), 1.0),
                  "tiny_scale": ((128, 160), 1e-5)}
# fp32 on both devices, the same gradients: the means of g^2 and the RMS
# of the update and of the parameter differ in summation order only
# (tests/test_torch_adafactor.py holds the CPU against optax to the same)
ADAFACTOR_PARAM_RTOL = 1e-6
ADAFACTOR_STATE_RTOL = 1e-5


def phase_optimizer(device, steps=3):
    """Adafactor steps on the card against the same steps on the CPU, on
    a small fp32 tree from a seed, compared after each step: parameters
    within ADAFACTOR_PARAM_RTOL of each leaf's largest value, second
    moments within ADAFACTOR_STATE_RTOL of theirs."""
    from ray_tpu_torch.train import Adafactor
    from ray_tpu_torch.train.optim import factored_dims

    g = torch.Generator().manual_seed(5)
    names = sorted(ADAFACTOR_TREE)
    init = {k: scale * torch.randn(shape, generator=g)
            for k, (shape, scale) in ADAFACTOR_TREE.items()}
    grads = [{k: torch.randn(ADAFACTOR_TREE[k][0], generator=g)
              for k in names} for _ in range(steps)]
    runs = []                   # (parameters, optimizer): CPU, card
    for dev in (torch.device("cpu"), device):
        params = [init[k].to(dev, copy=True) for k in names]
        runs.append((params, Adafactor(params, lr=1e-3)))
    (cpu_p, cpu_opt), (dev_p, dev_opt) = runs
    worst = {"param": 0.0, "state": 0.0}
    for step in range(steps):
        for params, opt in runs:
            for p, k in zip(params, names):
                p.grad = grads[step][k].to(p.device)
            opt.step()
        for a, b in zip(dev_p, cpu_p):
            r = float((a.cpu() - b).abs().max() / b.abs().max())
            worst["param"] = max(worst["param"], r / ADAFACTOR_PARAM_RTOL)
            for key, sb in cpu_opt.state[b].items():
                if key == "step":
                    assert float(dev_opt.state[a][key]) == float(sb) \
                        == step + 1
                    continue
                sa = dev_opt.state[a][key].cpu()
                r = float((sa - sb).abs().max() / sb.abs().max())
                worst["state"] = max(worst["state"],
                                     r / ADAFACTOR_STATE_RTOL)
    kinds = {k: "factored" if factored_dims(ADAFACTOR_TREE[k][0])
             else "full" for k in names}
    log(f"Adafactor on the card vs the CPU ({steps} steps, fp32, leaves "
        f"{json.dumps(kinds)}): worst parameter {worst['param']:.3f} x its "
        f"limit ({ADAFACTOR_PARAM_RTOL:g} of the leaf's largest), worst "
        f"second moment {worst['state']:.3f} x its limit "
        f"({ADAFACTOR_STATE_RTOL:g})")
    assert worst["param"] <= 1 and worst["state"] <= 1, worst


# --------------------------------------------- phase 10: Mixtral training

MIXTRAL_CONFIG = {"n_layers": 2}    # mixtral_8x7b widths, 2 of 32 layers
MIXTRAL_BATCH = (4, 2048)           # B, L
MIXTRAL_WARMUP, MIXTRAL_STEPS = 2, 3
MIXTRAL_SELECTIVE_STEPS = 3         # the first one untimed
# the card-against-CPU oracle: Mixtral's vocab, heads and experts at a
# width the CPU runs in seconds
MIXTRAL_ORACLE = {"dim": 512, "n_heads": 8, "n_kv_heads": 2,
                  "ffn_dim": 1024, "n_layers": 2}
MIXTRAL_ORACLE_BATCH = (2, 256)
# fp32 on both devices, TF32 off: loss and aux within 1e-5 of themselves,
# each gradient within 1e-5 of its leaf's largest value (summation order
# only; tests/test_torch_mixtral.py holds the CPU against JAX to the same)
MIXTRAL_ORACLE_RTOL = 1e-5
ROUTING_BATCH = (1, 512)
# bf16 against fp32 routing of one model: a token whose fp32 gap between
# its 2nd and 3rd router probability exceeds this keeps its experts
ROUTING_MARGIN = 2.0 ** -5
MIXTRAL_GROUPS = ("expert products", "dispatch", "attention", "router",
                  "rest")
# ops of the MoE dispatch: the sort, the segment sizes, the gathers and
# the scatter-adds (and their backward); aten::index on 1-D inputs (the
# sorted weights; on 2-D it is the embedding's gather)
DISPATCH_OPS = ("aten::sort", "aten::argsort", "aten::bincount",
                "aten::index_select", "aten::index_add_",
                "aten::floor_divide")


@contextlib.contextmanager
def recording(module, name, keep):
    """While open, each call of ``module.name`` appends its result to
    ``keep``."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        keep.append(out)
        return out

    setattr(module, name, wrapper)
    try:
        yield keep
    finally:
        setattr(module, name, orig)


def port_launch_counts():
    """Every launch counter of the port's kernels."""
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.ops import paged_attention as tpa
    return {**tfa.launch_counts, **tpa.launch_counts}


def reset_port_launch_counts():
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.ops import paged_attention as tpa
    for counts in (tfa.launch_counts, tpa.launch_counts):
        for name in counts:
            counts[name] = 0


def mixtral_group(name, shapes, cfg, seq_len):
    """The group of MIXTRAL_GROUPS an op's device time belongs to, from
    its name and input shapes: the 2-D products with the expert width are
    the experts' (forward and backward), those with the expert count the
    router's; the batched products and the [.., L, L] score passes are
    attention's."""
    dims = {d for shape in shapes if isinstance(shape, (list, tuple))
            for d in shape if isinstance(d, int)}
    if name == "aten::mm":
        if cfg.ffn_dim in dims:
            return "expert products"
        return "router" if cfg.n_experts in dims else "rest"
    first = shapes[0] if shapes and isinstance(shapes[0], list) else []
    if name in DISPATCH_OPS or (name in ("aten::index", "aten::index_put_")
                                and len(first) == 1):
        return "dispatch"
    if name == "aten::bmm" or first[-2:] == [seq_len, seq_len]:
        return "attention"
    if len(first) == 2 and first[-1] == cfg.n_experts:
        return "router"
    return "rest"


def profile_mixtral_step(step, device, cfg, seq_len):
    """One train step under torch.profiler (ops with their input shapes,
    and the kernels): the device time of each of MIXTRAL_GROUPS (each op's
    own kernels; kernels linked to no op go to the rest), the busy time
    and its share of the profiled step's wall time, and the largest parts
    of the rest (ops by name, unlinked kernels by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.monotonic()
        step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    groups = dict.fromkeys(MIXTRAL_GROUPS, 0.0)
    rest, unlinked = {}, {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue        # a record_function range, on either side
        if e.device_type != DeviceType.CPU:         # a kernel
            unlinked[e.name] = unlinked.get(e.name, 0.0) + \
                e.device_time_total / 1e3
            continue
        for k in e.kernels:
            unlinked[k.name] = unlinked.get(k.name, 0.0) - k.duration / 1e3
        ms = sum(k.duration for k in e.kernels) / 1e3
        if ms > 0:
            group = mixtral_group(e.name, e.input_shapes, cfg, seq_len)
            groups[group] += ms
            if group == "rest":
                rest[e.name] = rest.get(e.name, 0.0) + ms
    for name, ms in unlinked.items():
        if ms > 1e-6:
            groups["rest"] += ms
            rest[f"kernel {name[:60]}"] = ms
    busy = sum(groups.values())
    top_rest = sorted(rest.items(), key=lambda kv: -kv[1])[:6]
    return groups, busy, busy / wall_ms, top_rest


def phase_mixtral(device, config=None, batch=MIXTRAL_BATCH, profile=True,
                  card="the CPU"):
    """make_train_step over the Mixtral loss at Mixtral-8x7B widths (cut in
    depth), remat "full" then "selective", on ``card`` (the nvidia-smi
    name and power limit, printed beside the times); returns the trained
    parameters and the configuration for the routing check."""
    from ray_tpu_torch.models import mixtral as tm
    from ray_tpu_torch.parallel import moe
    from ray_tpu_torch.train import make_train_step, profile_train_step

    cfg = tm.MixtralConfig.mixtral_8x7b(**(config or MIXTRAL_CONFIG))
    B, L = batch
    cuda = device.type == "cuda"
    t0 = time.monotonic()
    params = tm.init_params(cfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=g,
                           device=device)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in [params["embed"], params["final_norm"],
                                *params["layers"].values()])
    optimizer = make_optimizer("adafactor")
    train = {policy: make_train_step(functools.partial(
        tm.loss_fn, cfg=dataclasses.replace(cfg, remat_policy=policy)),
        optimizer) for policy in ("full", "selective")}
    opt = train["full"][0](params)
    log(f"Mixtral training: {tm.num_params(cfg)} parameters "
        f"({tm.active_params(cfg)} active), {cfg.n_layers} of 32 layers, "
        f"dim {cfg.dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads, ffn "
        f"{cfg.ffn_dim}, {cfg.n_experts} experts top-{cfg.top_k}, B {B} L "
        f"{L}, adafactor {optimizer.keywords}; parameters {param_bytes} "
        f"bytes (fp32), gradients {param_bytes} bytes (fp32, between the "
        f"backward and the update), set-up {time.monotonic() - t0:.1f} s")
    reset_port_launch_counts()
    moe.sync_counts["segment_sizes"] = 0
    losses, runs, routed = [], {}, []
    for policy, warmup, steps in (
            ("full", MIXTRAL_WARMUP, MIXTRAL_STEPS),
            ("selective", 1, MIXTRAL_SELECTIVE_STEPS - 1)):
        step_fn = train[policy][1]
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(warmup + steps):
            last = policy == "full" and i == warmup + steps - 1
            t_step = time.monotonic()
            with (recording(tm, "_top_k", routed) if last
                  else contextlib.nullcontext()):
                params, opt, m = step_fn(params, opt, tokens)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
            times.append(time.monotonic() - t_step)
        step_s = sum(times[warmup:]) / steps
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            total = torch.cuda.get_device_properties(device).total_memory
            assert peak < total, (policy, peak, total)
        runs[policy] = (step_s, peak, steps)
    syncs = moe.sync_counts["segment_sizes"]
    launches = port_launch_counts()
    assert all(math.isfinite(x) and math.isfinite(n)
               for x, n in losses), losses
    assert losses[-1][0] < losses[0][0], f"loss did not fall: {losses}"
    n_steps = MIXTRAL_WARMUP + MIXTRAL_STEPS + MIXTRAL_SELECTIVE_STEPS
    # the forward and the remat recompute each read the sizes once a layer
    assert syncs == 2 * cfg.n_layers * n_steps, syncs
    assert not any(launches.values()), launches
    state_bytes = sum(t.numel() * t.element_size()
                      for s in opt.state.values() for t in s.values()
                      if isinstance(t, torch.Tensor)
                      and t.device.type == device.type)
    per_expert = [torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
                  .tolist() for idx, _ in routed[:cfg.n_layers]]
    log(f"Mixtral training: losses {[round(x, 4) for x, _ in losses]}, "
        f"grad norms {[round(n, 4) for _, n in losses]}")
    for policy, (step_s, peak, steps) in runs.items():
        tok_s = B * L / step_s
        mfu = tok_s * tm.flops_per_token(cfg, L) / BF16_FLOPS
        log(f"Mixtral training (remat {policy}): step {step_s * 1e3:.1f} ms "
            f"(mean of {steps} timed), "
            f"{tok_s:.0f} tokens/s, MFU {mfu:.1%} of 989 TFLOP/s (H100 "
            f"SXM dense bf16 peak; flops_per_token on active parameters), "
            f"peak memory {peak} bytes (torch.cuda.max_memory_allocated); "
            f"{card}")
    log(f"Mixtral training: optimizer state {state_bytes} bytes on the "
        f"card; MoE segment-size reads {syncs} over {n_steps} steps "
        f"({syncs // n_steps} a step: forward + recompute per layer); port "
        f"kernel launches {sum(launches.values())}; tokens per expert per "
        f"layer at the last remat-full step {per_expert}")
    if profile:
        step_s = runs["full"][0]
        loss = functools.partial(tm.loss_fn, cfg=cfg)
        step_fn = train["full"][1]
        bd = profile_train_step(loss, optimizer, params, opt, tokens,
                                steps=2, warmup=1, emit=False)
        log(f"Mixtral training: profile_train_step step "
            f"{bd.step_time_s * 1e3:.1f} ms, phases ms "
            f"{json.dumps({k: round(x, 2) for k, x in bd.phase_ms().items()})}")
        groups, busy, share, top_rest = profile_mixtral_step(
            lambda: step_fn(params, opt, tokens), device, cfg, L)
        log(f"Mixtral training: one remat-full step under the profiler: "
            f"device busy {busy:.1f} ms = {share:.1%} of its wall time; "
            f"by group (ms, share of busy) " + json.dumps(
                {k: [round(v, 2), round(v / busy, 4) if busy else 0.0]
                 for k, v in groups.items()})
            + f"; largest in the rest (ms): "
            + json.dumps({k: round(v, 2) for k, v in top_rest}))
    assert not any(port_launch_counts().values())
    return params, cfg


def phase_mixtral_routing(device, params, cfg, batch=ROUTING_BATCH):
    """The bf16 model's top-k experts against its own fp32 forward, layer
    by layer, each run on its own activations, under no_grad. A token
    whose experts differ in one layer carries an O(1) difference into the
    next, so in each layer the tokens held to the margin are those whose
    experts agreed in every earlier layer."""
    from ray_tpu_torch.models import mixtral as tm

    g = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, batch, generator=g,
                           device=device)
    probs = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            with recording(tm, "_router_probs", probs.setdefault(dtype, [])):
                tm.forward(params, tokens,
                           dataclasses.replace(cfg, dtype=dtype))
    shares, worst, held = [], [], []
    agreed = torch.ones(batch[0] * batch[1], dtype=torch.bool,
                        device=device)
    for p16, p32 in zip(probs[torch.bfloat16], probs[torch.float32]):
        top16 = p16.topk(cfg.top_k, dim=-1).indices.sort(-1).values
        top32 = p32.topk(cfg.top_k + 1, dim=-1)
        gap = top32.values[:, -2] - top32.values[:, -1]
        same = (top16 == top32.indices[:, :-1].sort(-1).values).all(-1)
        shares.append(round(same.float().mean().item(), 4))
        differ = agreed & ~same
        worst.append(gap[differ].max().item() if differ.any() else 0.0)
        held.append(int((agreed & (gap > ROUTING_MARGIN)).sum()))
        agreed &= same
    log(f"Mixtral routing, bf16 vs fp32 at full width (B {batch[0]} L "
        f"{batch[1]}): tokens with the same top-{cfg.top_k}, per layer "
        f"{shares}; among tokens that agreed in every earlier layer, the "
        f"largest fp32 2nd/3rd gap of a token that differs, per layer "
        f"{[round(w, 5) for w in worst]}; margin {ROUTING_MARGIN:g}, "
        f"tokens held to it per layer {held}")
    assert max(worst) <= ROUTING_MARGIN, (worst, ROUTING_MARGIN)


def phase_mixtral_oracle(device, config=None, batch=MIXTRAL_ORACLE_BATCH):
    """A small fp32 Mixtral on ``device`` against the same parameters and
    tokens on the CPU: loss, aux, routing and every gradient."""
    from ray_tpu_torch.models import mixtral as tm
    from ray_tpu_torch.train import param_leaves

    cfg = tm.MixtralConfig.mixtral_8x7b(**(config or MIXTRAL_ORACLE),
                                        dtype=torch.float32)
    cpu = torch.device("cpu")
    init = tm.init_params(cfg, seed=3, device=cpu)
    tokens = torch.randint(0, cfg.vocab_size, batch,
                           generator=torch.Generator().manual_seed(4))
    results = {}
    for dev in (cpu, device):
        p = {k: v.to(dev, copy=True).requires_grad_()
             if isinstance(v, torch.Tensor) else
             {n: t.to(dev, copy=True).requires_grad_() for n, t in v.items()}
             for k, v in init.items()}
        routed, aux = [], []
        with recording(tm, "_top_k", routed), \
                recording(tm, "_aux_loss", aux):
            loss = tm.loss_fn(p, tokens.to(dev), cfg)
            loss.backward()
        results[dev.type] = (
            loss.item(), torch.stack(aux[:cfg.n_layers]).mean().item(),
            [i.cpu() for i, _ in routed[:cfg.n_layers]],
            [leaf.grad.cpu() for leaf in param_leaves(p)])
    (lc, ac, ic, gc), (ld, ad, idd, gd) = results["cpu"], \
        results[device.type]
    assert abs(ld - lc) <= MIXTRAL_ORACLE_RTOL * abs(lc), (ld, lc)
    assert abs(ad - ac) <= MIXTRAL_ORACLE_RTOL * abs(ac), (ad, ac)
    for a, b in zip(idd, ic):
        assert torch.equal(a.sort(-1).values, b.sort(-1).values)
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(gd, gc))
    log(f"Mixtral oracle (dim {cfg.dim}, {cfg.n_experts} experts top-"
        f"{cfg.top_k}, {cfg.n_layers} layers, fp32, B {batch[0]} L "
        f"{batch[1]}): loss {ld:.7f} on the card vs {lc:.7f} on the CPU, "
        f"aux {ad:.7f} vs {ac:.7f}, routing equal, {len(gd)} gradients, "
        f"worst {worst:.2e} of the leaf's largest value")
    assert worst <= MIXTRAL_ORACLE_RTOL, worst


# ------------------------------------------------- phase 11: RL on the card

def rl_cases():
    """tests/test_rllib.py's settings and gates for each algorithm:
    name -> (config, most iterations, gate on the best episode-return
    mean). The model is RLlib's default module: a tanh MLP, hidden (64,
    64), policy and value heads (SAC: actor and twin critics)."""
    from ray_tpu_torch.rllib import (DQNConfig, IMPALAConfig, PPOConfig,
                                     SACConfig)
    return {
        "PPO": (PPOConfig(num_env_runners=2, num_envs_per_runner=16,
                          rollout_length=64, lr=1e-3, entropy_coeff=0.01,
                          num_epochs=4, minibatches=4, seed=3), 40, 100.0),
        "IMPALA": (IMPALAConfig(num_env_runners=2, num_envs_per_runner=16,
                                rollout_length=32, batches_per_iteration=8,
                                lr=1e-3, entropy_coeff=0.01, seed=0),
                   30, 120.0),
        "DQN": (DQNConfig(num_env_runners=2, num_envs_per_runner=8,
                          rollout_length=32, lr=1e-3, learning_starts=500,
                          updates_per_iter=16, target_sync_every=100,
                          epsilon_decay_iters=25, seed=1), 60, 100.0),
        "SAC": (SACConfig(num_env_runners=2, num_envs_per_runner=8,
                          rollout_length=32, lr=1e-3, learning_starts=512,
                          updates_per_iter=256, train_batch_size=256,
                          seed=0), 60, -350.0),
    }


# card against CPU: each leaf within 1e-5 of its largest value, the loss
# metric within 1e-5 of itself (the Mixtral oracle's limits)
RL_ORACLE_RTOL = 1e-5
# SAC's oracle update: 8 stacked batches, so that on the card the steps
# after the learner's 3 eager warm-up steps run as replays of its graph
RL_ORACLE_SAC_STEPS = 8


def runner_params(handle):
    """The parameters an EnvRunner actor holds (local mode: the actor's
    instance lives in this process)."""
    from ray_tpu_torch.core.worker import global_worker
    return global_worker.backend.actors[handle.actor_id].instance.params


def learner_call(name, algo, batch):
    """A thunk running one update of ``algo``'s learner on ``batch`` (its
    own replay sample for DQN and SAC)."""
    if name == "DQN":
        return lambda: algo.learner.update(algo.params, algo.target_params,
                                           batch)
    if name in ("PPO", "SAC"):
        return lambda: algo.learner.update(algo.params, batch, algo._gen)
    return lambda: algo.learner.update(algo.params, batch)


def learner_batch(name, algo):
    """A batch in the shape the algorithm's learner takes, from its own
    runners (PPO, IMPALA) or replay buffer (DQN, SAC)."""
    import numpy as np
    import ray_tpu_torch
    cfg = algo.config
    if name == "DQN":
        return algo.buffer.sample(cfg.train_batch_size)
    if name == "SAC":
        stack = [algo.buffer.sample(cfg.train_batch_size)
                 for _ in range(cfg.updates_per_iter)]
        return {k: np.stack([s[k] for s in stack]) for k in stack[0]}
    if name == "IMPALA":
        ready, _ = ray_tpu_torch.wait(list(algo._inflight), num_returns=1,
                                      timeout=600)
        return ray_tpu_torch.get(ready[0])
    algo._broadcast_weights()
    batches = ray_tpu_torch.get([r.sample.remote() for r in algo.runners],
                                timeout=600)
    batch = {k: np.concatenate([b[k] for b in batches], axis=1)
             for k in ("obs", "actions", "logp", "values", "rewards",
                       "dones")}
    batch["last_value"] = np.concatenate([b["last_value"] for b in batches])
    return batch


def check_runner_snapshot(algo, batch_update):
    """The weights a runner holds share no storage with the learner's and
    do not change across the learner's next update."""
    from ray_tpu_torch.rllib.module import snapshot
    from ray_tpu_torch.train import param_leaves
    held = runner_params(algo.runners[0])
    before = snapshot(held)
    ptrs = {t.data_ptr() for t in param_leaves(algo.params)}
    assert not ptrs & {t.data_ptr() for t in param_leaves(held)}
    new, _ = batch_update()
    assert any(not torch.equal(a, b) for a, b in zip(
        param_leaves(new), param_leaves(algo.params)))
    for a, b in zip(param_leaves(held), param_leaves(before)):
        assert torch.equal(a, b), "a runner's weights moved with the learner"


def rl_oracle(name, params, batch, device, target=None):
    """One update of a fresh ``name`` learner on the card and on the CPU,
    from the same parameters and batch, with the same permutations (PPO)
    or noise (SAC): -> the worst leaf ratio and the loss metric's, each
    against RL_ORACLE_RTOL (at most 1 passes)."""
    import numpy as np
    from ray_tpu_torch.rllib import dqn, impala, learner, sac
    from ray_tpu_torch.rllib.env import PendulumVectorEnv
    from ray_tpu_torch.rllib.module import tree_map
    from ray_tpu_torch.train import param_leaves
    g = torch.Generator().manual_seed(11)
    if name == "PPO":
        n = batch["rewards"].size
        perms = torch.stack([torch.randperm(n, generator=g)
                             for _ in range(4)]).numpy()
    if name == "SAC":
        batch = {k: v[:RL_ORACLE_SAC_STEPS] for k, v in batch.items()}
        noise = {k: torch.randn(batch["actions"].shape, generator=g).numpy()
                 for k in ("next", "actor")}
    out = {}
    for dev in (torch.device("cpu"), device):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        if name == "PPO":
            new, m = learner.PPOLearner(lr=1e-3).update(p, batch,
                                                        perms=perms)
        elif name == "IMPALA":
            new, m = impala.IMPALALearner(lr=1e-3).update(p, batch)
        elif name == "DQN":
            t = tree_map(lambda t: t.to(dev, copy=True), target)
            new, m = dqn.DQNLearner(lr=1e-3).update(p, t, batch)
        else:
            new, m = sac.SACLearner(
                lr=1e-3, action_scale=PendulumVectorEnv.action_scale
            ).update(p, batch, noise=noise)
        out[dev.type] = ([t.cpu() for t in param_leaves(new)],
                         m["critic_loss" if name == "SAC" else "loss"])
    (want, lw), (got, lg) = out["cpu"], out[device.type]
    # a leaf that stays 0 on both (a head the loss does not reach) is 0
    leaf = max(((a - b).abs().max() / (RL_ORACLE_RTOL * b.abs().max()
                                       .clamp_min(1e-30))).item()
               for a, b in zip(got, want))
    assert np.isfinite(lg)
    return leaf, abs(lg - lw) / (RL_ORACLE_RTOL * abs(lw))


def phase_rl(device, card="the CPU", cases=None):
    """RLlib on ``device`` through the user's entry points: the port's
    local-mode runtime, then each algorithm's ``build(device=)`` and
    ``train()`` until its gate, with every port launch counter set to 0
    just before and read just after (no Pallas kernel lies on this path,
    so all must stay 0); per algorithm the iteration time split into
    sampling and the learner update, the update on its own, one profiled
    update's device busy share, the weight-snapshot check and the card
    against the CPU. Returns {name: (iterations, best mean)}."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib.module import snapshot
    cases = cases if cases is not None else rl_cases()
    t_phase = time.monotonic()
    reset_port_launch_counts()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    out = {}
    try:
        for name, (config, iterations, gate) in cases.items():
            algo = config.build(device=device)
            try:
                t0 = time.monotonic()
                best, results, it_ms = float("-inf"), [], []
                for _ in range(iterations):
                    t = time.monotonic()
                    results.append(algo.train())
                    it_ms.append((time.monotonic() - t) * 1e3)
                    mean = results[-1]["episode_return_mean"]
                    if mean == mean:
                        best = max(best, mean)
                    if best >= gate:
                        break
                train_s = time.monotonic() - t0
                sample_ms = [r["time_sample_s"] * 1e3 for r in results]
                learn_ms = [r["time_learn_s"] * 1e3 for r in results]
                batch = learner_batch(name, algo)
                update = learner_call(name, algo, batch)
                if name == "IMPALA":
                    ray_tpu_torch.wait(list(algo._inflight),
                                       num_returns=len(algo._inflight),
                                       timeout=600)
                update()
                alone = []
                for _ in range(3):
                    t = time.monotonic()
                    update()
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    alone.append((time.monotonic() - t) * 1e3)
                alone_ms = sum(alone) / len(alone)
                _, busy = profile_device(update, device, alone_ms)
                check_runner_snapshot(algo, update)
                leaf, loss = rl_oracle(
                    name, snapshot(algo.params), batch, device,
                    snapshot(algo.target_params) if name == "DQN" else None)
            finally:
                algo.stop()
            log(f"RL {name}: best episode-return mean {best:.2f} after "
                f"{len(results)} iterations (gate {gate}, at most "
                f"{iterations}), {train_s:.2f} s; iteration ms mean "
                f"{sum(it_ms) / len(it_ms):.2f} (sampling, the get on the "
                f"runners, {sum(sample_ms) / len(sample_ms):.2f}; learner "
                f"update {sum(learn_ms) / len(learn_ms):.2f}); learner "
                f"update alone {alone_ms:.2f} ms (mean of 3); one profiled "
                f"update: {busy}; card against CPU: worst leaf "
                f"{leaf * RL_ORACLE_RTOL:.2e} of its largest value, loss "
                f"{loss * RL_ORACLE_RTOL:.2e} of itself; runner snapshot "
                f"held; {card}")
            assert best >= gate, f"{name} failed to learn: best {best}"
            assert leaf <= 1 and loss <= 1, (name, leaf, loss)
            out[name] = (len(results), best)
    finally:
        ray_tpu_torch.shutdown()
    launches = port_launch_counts()
    assert not any(launches.values()), launches
    log(f"RL phase: {time.monotonic() - t_phase:.1f} s, port kernel "
        f"launches {sum(launches.values())}; {card}")
    return out


# ---------------------------- phase 12: data, batch inference and BC


#: (engine, seconds its predictor took to build) for each predictor the
#: pool built in this process (local mode: the pool's actors are threads
#: here), for the engines' step counts
PREDICTOR_ENGINES = []
DATA_ROWS, DATA_BLOCKS, DATA_NEW_TOKENS = 16, 4, 32
# 12a's prompts: 5 to 1,000 tokens at the 8B widths (max_seq_len 2048);
# 12b's: 5 to 400 at the bench widths (max_seq_len 512)
DATA_LENGTHS = (5, 1000)
DATA_BENCH_LENGTHS = (5, 400)
# BC on the card (tests/test_rllib.py:239): a PPO teacher (rl_cases'
# PPO) to its gate, 8192 recorded rows, then BC to 100 within 15
# iterations; one BC update on the card against the CPU as phase 11's
BC_ROWS, BC_ITERATIONS, BC_GATE = 8192, 15, 100.0
BC_CONFIG = dict(lr=1e-3, batch_size=512, seed=11)


def counting_predictor():
    """``LLMBatchPredictor`` that puts its engine and its build time in
    PREDICTOR_ENGINES, so that the phase reads the engine's step counts
    once the pool is gone.
    The data layer cloudpickles the class, by value for a class of the
    script run as ``__main__``, so the list is looked up through the
    class's module when the pool's actor constructs it."""
    from ray_tpu_torch.llm.batch import LLMBatchPredictor

    class CountingPredictor(LLMBatchPredictor):
        def __init__(self, *args, **kwargs):
            t0 = time.monotonic()
            super().__init__(*args, **kwargs)
            sys.modules[type(self).__module__].PREDICTOR_ENGINES.append(
                (self.engine, time.monotonic() - t0))

    return CountingPredictor


def data_rows(vocab, lengths):
    """DATA_ROWS rows ``{"prompt": token ids, "id": j}``, prompt lengths
    spread evenly over ``lengths`` (the smallest and largest)."""
    lo, hi = lengths
    return [{"prompt": _prompt(40 + j, lo + (hi - lo) * j // (DATA_ROWS - 1),
                               vocab), "id": j} for j in range(DATA_ROWS)]


def expected_ragged_launches(engines):
    """Phase 4's count, summed over ``engines``: per layer, one launch a
    ragged step and decode_chunk a decode dispatch."""
    return sum(e.cfg.n_layers * (e.stats["ragged_dispatches"]
                                 + e.decode_chunk
                                 * e.stats["decode_dispatches"])
               for e in engines)


def run_batch_inference(rows, model_config, engine_config, concurrency):
    """``batch_inference`` over ``rows`` in DATA_BLOCKS blocks through
    ActorPoolStrategy(concurrency), every launch counter set to 0 just
    before and read just after: -> the output rows, the stage's
    ExecStats, the pool's engines, the launches, the stage's wall seconds
    and the seconds its predictors took to build (inside the stage). The
    runtime must be up."""
    from unittest import mock

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.llm import batch as tbatch
    PREDICTOR_ENGINES.clear()
    ds = rd.from_items(rows, num_blocks=DATA_BLOCKS)
    with mock.patch.object(tbatch, "LLMBatchPredictor",
                           counting_predictor()):
        out_ds = tbatch.batch_inference(
            ds, model_config=model_config, engine_config=engine_config,
            max_new_tokens=DATA_NEW_TOKENS, concurrency=concurrency)
    reset_port_launch_counts()
    t0 = time.monotonic()
    out = out_ds.take_all()
    wall = time.monotonic() - t0
    launches = port_launch_counts()
    engines = [e for e, _ in PREDICTOR_ENGINES]
    build_s = [s for _, s in PREDICTOR_ENGINES]
    PREDICTOR_ENGINES.clear()
    assert [r["id"] for r in out] == [r["id"] for r in rows]
    for row, got in zip(rows, out):
        assert got["prompt"] == row["prompt"], row["id"]
        assert len(got["generated"]) == DATA_NEW_TOKENS \
            or got["finish_reason"] == "stop", got
    return out, out_ds.stats(), engines, launches, wall, build_s


def log_stage(name, out, stats, engines, wall, build_s):
    n_tok = sum(len(r["generated"]) for r in out)
    log(f"{name}: {len(out)} rows in {wall:.2f} s ({len(out) / wall:.2f} "
        f"rows/s, {n_tok / wall:.1f} generated tokens/s; the predictors' "
        f"builds inside the stage {[round(s, 2) for s in build_s]} s), the "
        f"stage's ExecStats {json.dumps(stats)}, {len(engines)} engines, "
        f"stats {[dict(e.stats) for e in engines]}")


def phase_batch_inference(model_config=None, engine_config=None,
                          lengths=DATA_LENGTHS):
    """12a: ``batch_inference`` at the main path's widths (phase 4's
    model and engine), DATA_ROWS rows in DATA_BLOCKS blocks through one
    pool actor; the ragged launches equal the pool's engine's count, the
    plain version never runs on CUDA tensors, and every row's tokens and
    finish reason equal ``LLMBatchPredictor`` called directly on the
    same blocks with the same weights (the engine's seed), built once
    the pool's engine is gone. Returns the launches and their count."""
    import gc

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.llm.batch import LLMBatchPredictor
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    model_config = model_config or MAIN_MODEL
    engine_config = engine_config or MAIN_ENGINE
    cuda = torch.device(engine_config.get("device", "cuda")).type == "cuda"
    t_phase = time.monotonic()
    cfg = model_config_from_dict(model_config)
    rows = data_rows(cfg.vocab_size, lengths)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        out, stats, engines, launches, wall, build_s = run_batch_inference(
            rows, model_config, engine_config, concurrency=1)
        expected = expected_ragged_launches(engines)
        log_stage(f"batch_inference ({cfg.n_layers} layers dim {cfg.dim} "
                  f"{cfg.dtype}, prompts of {lengths[0]}-{lengths[1]} "
                  f"tokens x {DATA_NEW_TOKENS} new, ActorPoolStrategy(1))",
                  out, stats, engines, wall, build_s)
        del engines
    finally:
        ray_tpu_torch.shutdown()        # the pool's actors and engine go
    gc.collect()
    peak_pool = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    pred = LLMBatchPredictor(model_config, engine_config,
                             max_new_tokens=DATA_NEW_TOKENS)
    direct_build_s = time.monotonic() - t0
    bounds = np.linspace(0, len(rows), DATA_BLOCKS + 1).astype(int)
    t0 = time.monotonic()
    direct = [r for lo, hi in zip(bounds[:-1], bounds[1:])
              for r in pred(rows[lo:hi])]
    direct_s = time.monotonic() - t0
    peak_direct = torch.cuda.max_memory_allocated() if cuda else 0
    del pred
    gc.collect()
    for got, want in zip(out, direct):
        assert got == want, (got["id"], got["generated"], want["generated"])
    log(f"batch_inference: launches {launches}, expected "
        f"ragged_paged_attention {expected}; every row equal to the "
        f"direct predictor's on the same blocks, which took "
        f"{direct_s:.2f} s after a {direct_build_s:.2f} s build, against "
        f"the stage's {wall:.2f} s, its build included (finish reasons "
        f"{sorted({r['finish_reason'] for r in out})}); peak memory "
        f"{peak_pool} bytes with the pool, {peak_direct} with the direct "
        f"predictor; phase 12a {time.monotonic() - t_phase:.1f} s")
    return launches, expected


def phase_batch_rows(model_config=None, engine_config=None,
                     lengths=DATA_BENCH_LENGTHS):
    """12b: ``batch_inference`` at the bench widths in fp32 through
    ActorPoolStrategy(2) (two engines at once, one per pool actor): every
    row's tokens and finish reason equal the engine's ``generate`` on
    that prompt alone (phase 5b's rule: fp32 rows differ by summation
    order only); the ragged launches equal both engines' counts. Returns
    the launches and their count."""
    import ray_tpu_torch
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    model_config = model_config or {**BENCH_MODEL, "dtype": "float32"}
    engine_config = engine_config or BENCH_ENGINE
    t_phase = time.monotonic()
    cfg = model_config_from_dict(model_config)
    rows = data_rows(cfg.vocab_size, lengths)
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        out, stats, engines, launches, wall, build_s = run_batch_inference(
            rows, model_config, engine_config, concurrency=2)
        expected = expected_ragged_launches(engines)
        log_stage(f"batch_inference at the bench widths ({cfg.n_layers} "
                  f"layers, {cfg.dtype}, ActorPoolStrategy(2))", out,
                  stats, engines, wall, build_s)
        assert len(engines) == 2, len(engines)
        alone = InferenceEngine(cfg, engines[0].params, **engine_config)
        del engines
    finally:
        ray_tpu_torch.shutdown()
    for row, got in zip(rows, out):
        want = alone.generate(row["prompt"], DATA_NEW_TOKENS)
        reason = alone.request_log.snapshot()[-1]["finish_reason"]
        assert got["generated"] == want, (row["id"], got["generated"], want)
        assert got["finish_reason"] == reason, (got["finish_reason"], reason)
    log(f"batch_inference at the bench widths: launches {launches}, "
        f"expected ragged_paged_attention {expected} (both engines); every "
        f"row equal to generate alone; phase 12b "
        f"{time.monotonic() - t_phase:.1f} s")
    return launches, expected


def phase_bc(device, teacher=None, iterations=BC_ITERATIONS, gate=BC_GATE,
             rows=BC_ROWS, card="the CPU"):
    """12c: BC through the user's entry points on ``device``: a PPO
    teacher (``teacher``: (config, most iterations, gate), rl_cases' PPO
    by default) trained to its gate, ``record_dataset`` of ``rows`` rows
    (obs fp32, action int32), then ``BCConfig(...).build(device=)``
    trained until its best mean reaches ``gate`` within ``iterations``;
    every port launch counter stays 0 (no Pallas kernel lies on this
    path); the epoch's time split into batch iteration and updates; one
    BC update on ``device`` against the CPU. Returns a summary."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.rllib import BCConfig, BCLearner, record_dataset
    from ray_tpu_torch.rllib.module import snapshot, tree_map
    from ray_tpu_torch.train import param_leaves
    config, teacher_iterations, teacher_gate = teacher or rl_cases()["PPO"]
    t_phase = time.monotonic()
    reset_port_launch_counts()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        ppo = config.build(device=device)
        try:
            teacher_best, n_teacher = float("-inf"), 0
            while n_teacher < teacher_iterations and \
                    teacher_best < teacher_gate:
                mean = ppo.train()["episode_return_mean"]
                n_teacher += 1
                if mean == mean:
                    teacher_best = max(teacher_best, mean)
            assert teacher_best >= teacher_gate, \
                f"teacher PPO failed to learn: best {teacher_best}"
            t_rec = time.monotonic()
            ds = record_dataset(ppo, num_samples=rows)
            record_s = time.monotonic() - t_rec
        finally:
            ppo.stop()
        assert ds.count() == rows
        first = next(ds.iter_batches(batch_size=BC_CONFIG["batch_size"],
                                     drop_last=True))
        assert first["obs"].dtype == np.float32 and \
            first["action"].dtype == np.int32, first
        bc = BCConfig(dataset=ds, **BC_CONFIG).build(device=device)
        try:
            best, results = float("-inf"), []
            for _ in range(iterations):
                results.append(bc.train())
                mean = results[-1]["episode_return_mean"]
                if mean == mean:
                    best = max(best, mean)
                if best >= gate:
                    break
            params = snapshot(bc.params)
        finally:
            bc.stop()
    finally:
        ray_tpu_torch.shutdown()
    launches = port_launch_counts()
    assert not any(launches.values()), launches
    out = {}
    for dev in (torch.device("cpu"), device):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        learner = BCLearner(lr=BC_CONFIG["lr"])
        learner.init(p)
        new, m = learner.update(p, first)
        out[dev.type] = ([t.cpu() for t in param_leaves(new)],
                         m["bc_loss"])
    (want, lw), (got, lg) = out["cpu"], out[device.type]
    # a leaf that stays 0 on both (a head the loss does not reach) is 0
    leaf = max(((a - b).abs().max() / (RL_ORACLE_RTOL * b.abs().max()
                                       .clamp_min(1e-30))).item()
               for a, b in zip(got, want))
    loss = abs(lg - lw) / (RL_ORACLE_RTOL * abs(lw))
    data_ms = [r["time_data_s"] * 1e3 for r in results]
    learn_ms = [r["time_learn_s"] * 1e3 for r in results]
    it_ms = [r["time_this_iter_s"] * 1e3 for r in results]
    log(f"BC: teacher PPO best {teacher_best:.2f} after {n_teacher} "
        f"iterations; record_dataset {rows} rows in {record_s:.2f} s; BC "
        f"best episode-return mean {best:.2f} after {len(results)} "
        f"iterations (gate {gate}, at most {iterations}); epoch of "
        f"{rows // BC_CONFIG['batch_size']} batches: iteration ms mean "
        f"{sum(it_ms) / len(it_ms):.2f} (batch iteration "
        f"{sum(data_ms) / len(data_ms):.2f}, learner updates "
        f"{sum(learn_ms) / len(learn_ms):.2f}, the rest greedy "
        f"evaluation); update card against CPU: worst leaf "
        f"{leaf * RL_ORACLE_RTOL:.2e} of its largest value, loss "
        f"{loss * RL_ORACLE_RTOL:.2e} of itself; port kernel launches "
        f"{sum(launches.values())}; phase 12c "
        f"{time.monotonic() - t_phase:.1f} s; {card}")
    assert best >= gate, f"BC failed to reach the gate: best {best}"
    assert leaf <= 1 and loss <= 1, (leaf, loss)
    return {"teacher_best": teacher_best, "bc_best": best,
            "bc_iterations": len(results), "leaf": leaf}


# ----------------------------- phase 13: Tune PBT over the train step

# phase 7's widths cut to 2 of its 8 layers; fp32 master weights from
# seed 0, bf16 compute, Adafactor(lr=cfg["lr"]), B 2 x L 2048 from seed 1
TUNE_CONFIG = dict(TRAIN_CONFIG, n_layers=2)
TUNE_BATCH = (2, 2048)
TUNE_LRS = (1e-3, 1e-3, 3e-1, 3e-1)
TUNE_ITERATIONS = 4             # reports per trial
TUNE_STEPS_PER_REPORT = 2
TUNE_INTERVAL = 2               # PBT's perturbation interval
# losses of the same forward pass on the same weights and batch: equal
# up to fp32 noise of the loss's own size
TUNE_LOSS_RTOL = 1e-6


def tune_trainable(device, config, batch, events):
    """A Tune trainable over ``make_train_step``: each report is
    TUNE_STEPS_PER_REPORT steps; ``loss`` is the first step's (the
    forward pass on the weights the report starts from). At every
    TUNE_INTERVAL-th iteration the report carries a checkpoint of the
    state that iteration started from (params and Adafactor state), so
    a trial restored from it runs that iteration again, from the same
    weights, with its new lr. ``events`` gets ("step", lr, ms),
    ("save", s) and ("load", s) as they happen (local mode passes the
    trainable by reference), so steps a stopped trial ran without
    reporting them count too."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.rllib.module import snapshot
    from ray_tpu_torch.train import Adafactor, make_train_step
    mcfg = LlamaConfig(**config)
    B, L = batch

    def trainable(cfg):
        import copy
        g = torch.Generator(device=device).manual_seed(1)
        tokens = torch.randint(0, mcfg.vocab_size, (B, L), generator=g,
                               device=device)
        init_fn, step_fn = make_train_step(
            functools.partial(loss_fn, cfg=mcfg),
            functools.partial(Adafactor, lr=cfg["lr"]))
        t = time.monotonic()
        state = tune.get_checkpoint()
        if state is None:
            params, done = init_params(mcfg, seed=0, device=device), 0
        else:
            events.append(("load", time.monotonic() - t))
            params, done = state["params"], state["iteration"]
        opt = init_fn(params)
        if state is not None:
            opt.load_state_dict(state["opt"])
            for group in opt.param_groups:
                group["lr"] = cfg["lr"]
        del state
        for it in range(done + 1, TUNE_ITERATIONS + 1):
            ckpt = None if it % TUNE_INTERVAL else {
                "params": snapshot(params),
                "opt": copy.deepcopy(opt.state_dict()), "iteration": it - 1}
            losses, ms = [], []
            for _ in range(TUNE_STEPS_PER_REPORT):
                t = time.monotonic()
                params, opt, m = step_fn(params, opt, tokens)
                losses.append(float(m["loss"]))            # syncs
                ms.append((time.monotonic() - t) * 1e3)
                events.append(("step", cfg["lr"], ms[-1]))
            t = time.monotonic()
            tune.report({"loss": losses[0], "losses": losses, "iter": it,
                         "step_ms": ms, "lr": cfg["lr"]}, checkpoint=ckpt)
            if ckpt is not None:
                events.append(("save", time.monotonic() - t))
            del ckpt

    return trainable


def recording_pbt(**kwargs):
    """``PopulationBasedTraining`` that records each exploit it decides:
    the trial, how many results it had, the donor and the donor's result
    that came with the checkpoint handed over (the newest of a
    checkpointing iteration)."""
    from ray_tpu_torch.tune import PopulationBasedTraining

    class RecordingPBT(PopulationBasedTraining):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.exploits = []

        def on_result(self, trial, result, all_trials):
            decision = super().on_result(trial, result, all_trials)
            directive = getattr(trial, "_pbt_exploit", None)
            if directive is not None:
                donor = next(t for t in all_trials
                             if t.trial_id == directive["source_id"])
                donor_result = [r for r in donor.results
                                if r["iter"] % TUNE_INTERVAL == 0][-1]
                self.exploits.append({
                    "trial": trial.trial_id, "at": len(trial.results),
                    "donor": donor.trial_id,
                    "donor_result": dict(donor_result),
                    "lr": directive["config"]["lr"]})
            return decision

    return RecordingPBT(**kwargs)


def phase_tune(device, config=None, batch=TUNE_BATCH, lrs=TUNE_LRS):
    """Tune's PBT over the train step on ``device``: len(lrs) trials, 2
    at once, TUNE_ITERATIONS reports each; the flash launch counters set
    to 0 before and read after must equal expected_flash_launches over
    the steps the trials ran (on a CUDA device; on the CPU the plain
    versions run and all stay 0); trial 0's first two losses equal a
    standalone run's; every exploited trial's first loss equals its
    donor's at that iteration; the trials that started at the largest lr
    end lower than their last loss before their exploit. Returns a
    summary."""
    import os
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.llama import (LlamaConfig, init_params,
                                            loss_fn, num_params)
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.train import Adafactor, make_train_step
    config = config or TUNE_CONFIG
    mcfg = LlamaConfig(**config)
    B, L = batch
    cuda = device.type == "cuda"
    t_phase = time.monotonic()
    # the standalone run: trial 0's configuration and lr outside Tune
    params = init_params(mcfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, mcfg.vocab_size, (B, L), generator=g,
                           device=device)
    init_fn, step_fn = make_train_step(functools.partial(loss_fn, cfg=mcfg),
                                       functools.partial(Adafactor,
                                                         lr=lrs[0]))
    opt = init_fn(params)
    alone, alone_ms = [], []
    for _ in range(2 * TUNE_STEPS_PER_REPORT):
        t = time.monotonic()
        params, opt, m = step_fn(params, opt, tokens)
        alone.append(float(m["loss"]))
        alone_ms.append((time.monotonic() - t) * 1e3)
    del params, opt, m
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    events = []
    scheduler = recording_pbt(
        perturbation_interval=TUNE_INTERVAL, quantile_fraction=0.5,
        hyperparam_mutations={"lr": tune.loguniform(1e-4, 3e-3)}, seed=0)
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    try:
        ray_tpu_torch.init(local_mode=True, num_cpus=4)
        try:
            t_fit = time.monotonic()
            grid = tune.Tuner(
                tune_trainable(device, config, batch, events),
                param_space={"lr": tune.grid_search(list(lrs))},
                tune_config=tune.TuneConfig(metric="loss", mode="min",
                                            scheduler=scheduler,
                                            max_concurrent_trials=2),
                run_config=tune.TuneRunConfig(
                    storage_path=storage,
                    resources_per_trial={"CPU": 1, "GPU": 1})).fit()
            fit_s = time.monotonic() - t_fit
        finally:
            # joins the trial actors, which wait for their functions'
            # threads
            ray_tpu_torch.shutdown()
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(storage) for f in files
                         if f.startswith("ckpt_"))
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    launches = dict(tfa.launch_counts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = [e for e in events if e[0] == "step"]
    saves = [e[1] for e in events if e[0] == "save"]
    loads = [e[1] for e in events if e[0] == "load"]
    assert not grid.errors, [t.error for t in grid.errors]
    log(f"tune: PBT over make_train_step, {num_params(mcfg)} parameters "
        f"({mcfg.n_layers} layers dim {mcfg.dim}, {mcfg.attention}, remat "
        f"{mcfg.remat_policy}), B {B} L {L}, {len(lrs)} trials lr {lrs}, "
        f"2 at once, {TUNE_ITERATIONS} reports of {TUNE_STEPS_PER_REPORT} "
        f"steps; fit {fit_s:.1f} s, {len(steps)} steps run")
    for trial in grid.trials:
        step_ms = [x for r in trial.results for x in r["step_ms"][1:]]
        log(f"tune: {trial.trial_id} lr {trial.results[0]['lr']} -> "
            f"{trial.config['lr']:.3g}: (iter, loss) "
            f"{[(r['iter'], round(r['loss'], 5)) for r in trial.results]}, "
            f"step ms (each after the first of a report) "
            f"{sum(step_ms) / len(step_ms):.1f}")
    log(f"tune: exploits {scheduler.exploits}")
    log(f"tune: checkpoints {len(saves)}, {ckpt_bytes} bytes written, "
        f"pickling {sum(saves):.2f} s ({[round(s, 2) for s in saves]}), "
        f"loading {sum(loads):.2f} s ({[round(s, 2) for s in loads]})")
    log(f"tune: step ms alone {sum(alone_ms[2:]) / 2:.1f} (steps 3-4 of "
        f"the standalone run); peak memory {peak} bytes with the trials "
        f"on the card; flash launches {launches}")
    # the steps the trials ran, and the kernels they launched
    if cuda:
        assert launches == expected_flash_launches(mcfg.n_layers,
                                                   len(steps)), launches
    else:
        assert not any(launches.values()), launches
    first = grid.trials[0].results[0]["losses"]
    for got, want in zip(first, alone[:2]):
        assert abs(got - want) <= TUNE_LOSS_RTOL * abs(want), (first, alone)
    by_id = {t.trial_id: t for t in grid.trials}
    for e in scheduler.exploits:
        after = by_id[e["trial"]].results[e["at"]]
        want = e["donor_result"]
        assert after["iter"] == want["iter"], (e, after)
        assert abs(after["loss"] - want["loss"]) <= \
            TUNE_LOSS_RTOL * abs(want["loss"]), (e, after)
    top = max(lrs)
    for trial in grid.trials:
        if trial.results[0]["lr"] != top:
            continue
        mine = [e for e in scheduler.exploits if e["trial"] ==
                trial.trial_id]
        assert mine, f"{trial.trial_id} (lr {top}) was never exploited"
        before = trial.results[mine[0]["at"] - 1]["loss"]
        assert trial.results[-1]["loss"] < before, \
            (trial.trial_id, before, trial.results[-1]["loss"])
    log(f"tune: trial 0's first losses {first} equal the standalone run's "
        f"{alone[:2]}; {len(scheduler.exploits)} exploits, each first "
        f"loss equal to its donor's; phase 13 "
        f"{time.monotonic() - t_phase:.1f} s")
    return {"steps": len(steps), "exploits": scheduler.exploits,
            "launches": launches}


# ------------------------------------------------------------------ main


def main():
    t_script = time.monotonic()
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
    for lib, kernel in SM90_KERNELS:
        log(f"ptxas, {kernel}: "
            f"{ptxas_report(built.get(lib) or _kernels.build_log(lib), kernel)}")

    kern = phase_kernel(device)
    decode = phase_decode(device)
    torch.cuda.empty_cache()
    # the main path is the first engine of the process, so the step
    # programs it dispatched are all the process holds
    stats, launches, expected, programs = phase_main_path()
    assert launches["ragged_paged_attention"] == expected, \
        (launches, expected)
    assert launches["ragged_paged_attention_reference_cuda"] == 0, \
        "the plain attention ran on CUDA tensors in the main path"
    assert programs[0] == 0 and programs[1] <= 3, programs
    torch.cuda.empty_cache()
    decode_launches = phase_decode_engine()
    phase_oracle(device)
    # bench_llm.py's widths: the kernels at head dim 64 and pages of 32,
    # then a server at those widths, its launches counted, and the fp32
    # engine against the full forward there
    kern_bench = phase_kernel(device, BENCH_GEOMETRY)
    _, bench_launches, bench_expected, _ = phase_main_path(
        BENCH_MODEL, BENCH_ENGINE, launch_stamp_fails=False)
    assert bench_launches["ragged_paged_attention"] == bench_expected, \
        (bench_launches, bench_expected)
    assert bench_launches["ragged_paged_attention_reference_cuda"] == 0, \
        "the plain attention ran on CUDA tensors at the bench widths"
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    phase_oracle(device, dataclasses.replace(
        model_config_from_dict(BENCH_MODEL), dtype=torch.float32),
        page_size=BENCH_ENGINE["page_size"])
    phase_recorder_ab()
    phase_batch_predictor()

    flash = phase_flash(device)
    phase_flash_lengths(device)
    flash_launches, steps, n_layers = phase_train(device)
    assert flash_launches == expected_flash_launches(n_layers, steps), \
        flash_launches
    torch.cuda.empty_cache()
    # the earlier optimizer on the same configuration, for comparison
    adamw_launches, adamw_steps, _ = phase_train(
        device, optimizer="adamw", steps=3, profile=False)
    assert adamw_launches == expected_flash_launches(n_layers, adamw_steps), \
        adamw_launches
    torch.cuda.empty_cache()
    phase_train_oracle(device)
    phase_optimizer(device)
    torch.cuda.empty_cache()
    mixtral_params, mixtral_cfg = phase_mixtral(device, card=card)
    phase_mixtral_routing(device, mixtral_params, mixtral_cfg)
    del mixtral_params
    torch.cuda.empty_cache()
    phase_mixtral_oracle(device)
    torch.cuda.empty_cache()
    phase_rl(device, card)
    torch.cuda.empty_cache()

    t_data = time.monotonic()
    data_launches, data_expected = phase_batch_inference()
    assert data_launches["ragged_paged_attention"] == data_expected, \
        (data_launches, data_expected)
    assert data_launches["ragged_paged_attention_reference_cuda"] == 0, \
        "the plain attention ran on CUDA tensors in batch_inference"
    torch.cuda.empty_cache()
    rows_launches, rows_expected = phase_batch_rows()
    assert rows_launches["ragged_paged_attention"] == rows_expected, \
        (rows_launches, rows_expected)
    assert rows_launches["ragged_paged_attention_reference_cuda"] == 0
    torch.cuda.empty_cache()
    phase_bc(device, card=card)
    log(f"phase 12: {time.monotonic() - t_data:.1f} s")
    torch.cuda.empty_cache()
    t_tune = time.monotonic()
    phase_tune(device)
    log(f"phase 13: {time.monotonic() - t_tune:.1f} s; the whole script "
        f"{time.monotonic() - t_script:.1f} s")

    bf16 = kern["bf16"]
    record = {"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:340",
        "launches": launches["ragged_paged_attention"],
        "max_abs_err": max(k["max_abs_err"] for k in [
            *kern.values(), *kern_bench.values()]),
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"]}, {
        "name": "paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:92",
        "launches": decode_launches,
        "max_abs_err": max(d["max_abs_err"] for d in decode.values()),
        **{k: decode["A bfloat16"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}] + [{
        "name": name, "route": "cuda",
        "source": f"ray_tpu_torch/ops/csrc/{src}",
        "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
        "launches": flash_launches[name], **flash[name]}
        for name, src, line in (
            ("flash_attention_fwd", "flash_attention_fwd.cu", 91),
            ("flash_attention_dq", "flash_attention_bwd.cu", 139),
            ("flash_attention_dkv", "flash_attention_bwd.cu", 175))]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
