#!/usr/bin/env python3
"""Comparisons on one NVIDIA GPU that ``chip_smoke.py`` does not make.

    python3 chip_compare.py train PARENT_DIR [OPTIMIZER]
        phase 7 of chip_smoke.py (the 1.23B training step, 2 warm-up and
        5 timed steps, then the step profiler and one step under
        torch.profiler) for the checkout in PARENT_DIR and for this one,
        in turns: parent, this, this, parent, each in its own process
        after both have built their kernels; this checkout's runs train
        with OPTIMIZER ("adafactor", the default, or "adamw"), the
        parent's with its own phase 7's optimizer. Make the parent's
        checkout with ``git archive <commit> | tar -x -C PARENT_DIR``.
    python3 chip_compare.py serve PARENT_DIR
        phase 4 of chip_smoke.py (LLMServer at Llama-3-8B widths: the
        first wave of four requests, then the prefix-hit request alone and
        under the profiler) for the checkout in PARENT_DIR and for this
        one, in turns (parent, this, this, parent), each in its own
        process after both have built their kernels; prints each run's
        wall times and device busy time.
    python3 chip_compare.py telemetry
        the serving telemetry's host cost at Llama-3-8B widths (phase 4's
        engine: all 32 layers, bf16), in one process on one engine:
        rounds of 8 requests (64 prompt tokens, 32 new tokens each) with
        the telemetry on (as shipped) and off (no flight recorder, no
        step-program signature, no gauge update), in turns (on, off, off,
        on) six times; then rounds with each telemetry function wrapped
        in a timer (calls and host time per dispatch), and one log record
        of the server.
    python3 chip_compare.py decode PARENT_DIR
        the decode op (``paged_attention``, bf16 pools) on chip_smoke.py's
        batches A, B and C for the checkout in PARENT_DIR and for this
        one, in turns (parent, this, this, parent), each in its own process
        after both have built their kernels, each batch timed over 50
        calls with the L2 flushed before each; this tree's outputs are
        checked against the plain version first.
    python3 chip_compare.py flash PARENT_DIR
        the three flash kernels (forward, dq, dk/dv) at the training path's
        shape (B 8, H 24, L 2048, D 128, bf16, causal) for the checkout in
        PARENT_DIR and for this one, in turns (parent, this, this,
        parent), each in its own process, each kernel timed over 20 calls
        with the L2 flushed before each.
    python3 chip_compare.py phase6 PARENT_DIR
        chip_smoke.py's phase 6 itself (the flash kernels against their
        plain versions, then timed at the training path's shape), twice
        in each process, for the checkout in PARENT_DIR and for this one,
        in turns (parent, this, this, parent).
    python3 chip_compare.py ring
        variants of the decode op's bf16 ring walk (paged_ring.cuh), each
        built from this checkout's ops/csrc sources with a few lines of
        the header replaced (ring stages; the pages stored unswizzled, as
        in the pool, whose ldmatrix and K loads then meet bank conflicts;
        a walk that only streams the pages, skipping the products, as a
        bound on what the loads allow; one consumer warp instead of two),
        checked against the plain version (all but the streaming one),
        then timed twice each, in turns, on chip_smoke.py's batches A, B
        and C (bf16); the design, the unswizzled walk and the streaming
        variant also with the L2 left clean before each call (a read
        flush), where chip_smoke.py's written flush leaves it dirty.
    python3 chip_compare.py dq
        variants of the bf16 dq kernel (flash_dq_sm90_kernel), each built
        from this checkout's ops/csrc/flash_attention_bwd.cu with a few
        lines replaced (ring slots; q read from shared memory instead of
        registers; ping-pong between the consumer warpgroups, as the
        forward kernel has), checked against the plain version, then
        timed twice each, in turns, at the training path's shape (B 8,
        H 24, L 2048, D 128, causal).

Both print the card's name and power limit first. Each exits non-zero
without a CUDA device.
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent

# ------------------------------------------------------------- training

TRAIN = """
import sys, torch
sys.path.insert(0, '.')
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.phase_train(torch.device('cuda'){args})
"""


def _build_both(parent: Path) -> None:
    """Build the parent's kernels and this checkout's, together."""
    build = ("import sys; sys.path.insert(0, '.'); "
             "from ray_tpu_torch.ops import _kernels; _kernels.build()")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d)
             for d in (parent, REPO)]
    assert all(p.wait() == 0 for p in procs), "a build failed"


def compare_train(parent: Path, optimizer: str) -> None:
    _build_both(parent)
    for tag, d in (("parent", parent), ("this", REPO), ("this", REPO),
                   ("parent", parent)):
        args = "" if d == parent else f", optimizer={optimizer!r}"
        out = subprocess.run([sys.executable, "-c",
                              TRAIN.format(args=args)], cwd=d,
                             capture_output=True, text=True, check=True)
        for line in out.stdout.splitlines():
            if line.startswith("training: step") or "profile_train" in line \
                    or "under the profiler" in line:
                print(f"{tag}: {line[:400]}", flush=True)


SERVE = """
import sys, torch
sys.path.insert(0, '.')
import chip_smoke
chip_smoke.phase_main_path()
"""


def compare_serve(parent: Path) -> None:
    _build_both(parent)
    for tag, d in (("parent", parent), ("this", REPO), ("this", REPO),
                   ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", SERVE], cwd=d,
                             capture_output=True, text=True, check=True)
        for line in out.stdout.splitlines():
            if "first wave" in line or "stream request" in line \
                    or "prefix-hit request alone" in line:
                print(f"{tag}: {line[:300]}", flush=True)


# ------------------------------------------------------------ telemetry


def compare_telemetry(cycles: int = 6) -> None:
    import collections

    import chip_smoke as cs
    from ray_tpu_torch.llm import engine as E
    from ray_tpu_torch.llm.request_log import FlightRecorder, RequestRecord
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util import log_plane

    _kernels.build()
    cfg = model_config_from_dict(cs.MAIN_MODEL)
    eng = E.InferenceEngine(cfg, **cs.MAIN_ENGINE)
    recorder = eng.request_log
    note_program = E._SingleChipFns.__dict__["_note_program"]
    uniq = iter(range(1, 1 << 20))

    def set_on(on):
        eng.request_log = recorder if on else None
        E._SingleChipFns._note_program = note_program if on else \
            staticmethod(lambda fn, static, args: None)
        if on:
            eng.__dict__.pop("_update_metrics", None)
        else:
            eng._update_metrics = lambda force=False: None

    def one_round():
        for _ in range(8):
            eng.add_request(cs.bench_prompt(next(uniq), cfg.vocab_size, 64),
                            32)
        d0 = eng.stats["ragged_dispatches"] + eng.stats["decode_dispatches"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.has_work():
            eng.step()
        wall = time.perf_counter() - t0
        return wall, (eng.stats["ragged_dispatches"]
                      + eng.stats["decode_dispatches"] - d0)

    for on in (True, False):                    # warm-up, one of each
        set_on(on)
        one_round()
    walls = {True: [], False: []}
    for c in range(cycles):
        for on in (True, False, False, True):
            set_on(on)
            wall, n = one_round()
            walls[on].append(wall)
            print(f"telemetry {'on ' if on else 'off'}: round {c}: "
                  f"{wall * 1e3:.3f} ms, {n} dispatches, "
                  f"{wall / n * 1e3:.3f} ms per dispatch", flush=True)
    pairs = [a - b for a, b in zip(walls[True], walls[False])]
    mean = sum(pairs) / len(pairs)
    sd = (sum((x - mean) ** 2 for x in pairs) / (len(pairs) - 1)) ** 0.5
    base = sum(walls[False]) / len(walls[False])
    print(f"telemetry: on - off per round {mean * 1e3:+.3f} ms "
          f"({mean / base:+.3%} of {base * 1e3:.3f} ms), sd of the "
          f"{len(pairs)} paired differences {sd * 1e3:.3f} ms", flush=True)

    # each telemetry function timed on its own, telemetry on
    set_on(True)
    acc = collections.defaultdict(lambda: [0, 0.0])

    def timed(owner, name):
        orig = owner.__dict__[name]
        fn = orig.__func__ if isinstance(orig, staticmethod) else orig

        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                a = acc[name]
                a[0] += 1
                a[1] += time.perf_counter() - t
        setattr(owner, name, staticmethod(wrapper)
                if isinstance(orig, staticmethod) else wrapper)

    timed(E._SingleChipFns, "_note_program")
    timed(E.InferenceEngine, "_update_metrics")
    for name in ("start", "finish"):
        timed(FlightRecorder, name)
    for name in ("note_admit", "note_chunk", "note_stall", "note_preempt",
                 "note_first", "note_decode"):
        timed(RequestRecord, name)
    n_disp = 0
    for _ in range(4):
        n_disp += one_round()[1]
    total = sum(t for _, t in acc.values())
    for name, (n, t) in sorted(acc.items()):
        print(f"telemetry timed: {name}: {n} calls, "
              f"{t / n * 1e6:.3f} us each, {t / n_disp * 1e6:.3f} us per "
              f"dispatch", flush=True)
    print(f"telemetry timed: all hooks {total / n_disp * 1e6:.3f} us per "
          f"dispatch over {n_disp} dispatches", flush=True)
    logger = log_plane.ensure_started(role="llm")
    with log_plane.request_context("probe"):
        t = time.perf_counter()
        for i in range(10_000):
            logger.info("llm request finished", tokens=i)
        rec_us = (time.perf_counter() - t) / 10_000 * 1e6
    print(f"telemetry timed: one server log record {rec_us:.3f} us",
          flush=True)


# ------------------------------------------------------------- decode op

DECODE = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from ray_tpu_torch.ops import paged_attention as tpa
CHECK = sys.argv[1:] == ['check']
dev = torch.device('cuda')
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
out = {}
for name, (lens, max_pages, P, _, geometry) in cs.DECODE_BATCHES.items():
    q, kp, vp, pt, sl = cs.decode_batch(dev, lens, max_pages, P,
                                        torch.bfloat16, **geometry)
    if CHECK:
        got = tpa.paged_attention(q, kp, vp, pt, sl)
        ref = tpa.paged_attention_reference(q, kp, vp, pt, sl)
        assert cs.decode_ratios(got, ref).max().item() <= 1, name
    out[name] = cs.time_ms(lambda: tpa.paged_attention(q, kp, vp, pt, sl),
                           iters=50, flush=flush)
    del q, kp, vp, pt, sl
print('TIMES ' + json.dumps(out))
"""


FLASH = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from ray_tpu_torch.ops import flash_attention as tfa
dev = torch.device('cuda')
B, H, L, D = cs.FLASH_SHAPE
BH, scale = B * H, D ** -0.5
g = torch.Generator(device=dev).manual_seed(2)
q, k, v, do = (torch.randn(BH, L, D, generator=g, device=dev).bfloat16()
               for _ in range(4))
o, lse = tfa._fwd_cuda(q, k, v, True, scale)
delta = (do.float() * o.float()).sum(-1)
dq, dk, dv = (torch.empty_like(q) for _ in range(3))
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
out = {
    'fwd': cs.time_ms(lambda: tfa._fwd_cuda(q, k, v, True, scale),
                      iters=20, flush=flush),
    'dq': cs.time_ms(lambda: tfa._launch(
        'flash_attention_bwd', 'flash_attention_dq', dev, 1, q, k, v, do,
        lse, delta, dq, BH, L, L, D, 1, scale), iters=20, flush=flush),
    'dkv': cs.time_ms(lambda: tfa._launch(
        'flash_attention_bwd', 'flash_attention_dkv', dev, 1, q, k, v, do,
        lse, delta, dk, dv, BH, L, L, D, 1, scale), iters=20, flush=flush)}
print('TIMES ' + json.dumps(out))
"""


def _in_turns(parent: Path, code: str, what: str) -> None:
    """Run code (which prints one line "TIMES {json}") in the parent's
    checkout and this one, P C C P, each in its own process after both
    have built their kernels; print each run and each key's times."""
    _build_both(parent)
    times = {}
    for tag, d in (("parent", parent), ("this", REPO), ("this", REPO),
                   ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", code], cwd=d,
                             capture_output=True, text=True, check=True)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("TIMES ")][-1]
        print(f"{tag}: {what} ms {line[6:]}", flush=True)
        for name, ms in json.loads(line[6:]).items():
            times.setdefault(name, {}).setdefault(tag, []).append(ms)
    for name, by in times.items():
        print(f"{what} {name}: parent "
              f"{' / '.join(f'{t:.4f}' for t in by['parent'])} ms, this "
              f"{' / '.join(f'{t:.4f}' for t in by['this'])} ms", flush=True)


PHASE6 = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
runs = [cs.phase_flash(torch.device('cuda')) for _ in range(2)]
print('TIMES ' + json.dumps({f'{kern} (run {i + 1})': r[kern]['ms']
                             for i, r in enumerate(runs) for kern in r}))
"""


def compare_decode(parent: Path) -> None:
    # this tree's outputs held against the plain version first
    subprocess.run([sys.executable, "-c", DECODE, "check"], cwd=REPO,
                   check=True)
    _in_turns(parent, DECODE, "decode op")


# ------------------------------------------------------------- dq variants

SRC = REPO / "ray_tpu_torch" / "ops" / "csrc" / "flash_attention_bwd.cu"

# (old, new) replacements, each of exactly one occurrence
Q_IN_SHARED_MEMORY = [(
    "    mma_rs_n64<0>(s, qf + 4 * kk, desc_k(k_tile, kBoxK, kk), kk > 0);",
    "    mma_ss_n64(s, desc_k(doa - kDo + kQ, kBoxQ, kk),\n"
    "               desc_k(k_tile, kBoxK, kk), kk > 0);")]
PING_PONG = [
    ("  auto edge = [&](int kt) {",
     "  auto my_turn = [&] { named_sync(3 + w, 256); };\n"
     "  auto your_turn = [&] { named_arrive(3 + (1 - w), 256); };\n"
     "  if (w == 1) your_turn();\n"
     "  auto edge = [&](int kt) {"),
    ("    bar_wait(v_full(0), 0);\n    wgmma_fence();",
     "    bar_wait(v_full(0), 0);\n    my_turn();\n    wgmma_fence();"),
    ("    wgmma_commit();\n    wgmma_wait<0>();\n    fence_regs(s);",
     "    wgmma_commit();\n    your_turn();\n    wgmma_wait<0>();\n"
     "    fence_regs(s);"),
    ("    bar_wait(v_full(r.slot), r.parity);\n    wgmma_fence();",
     "    bar_wait(v_full(r.slot), r.parity);\n    my_turn();\n"
     "    wgmma_fence();"),
    ("    wgmma_commit();\n    wgmma_wait<1>();",
     "    wgmma_commit();\n    your_turn();\n    wgmma_wait<1>();"),
    ("    const Ring<kStages> last(n - 1);\n    wgmma_fence();",
     "    const Ring<kStages> last(n - 1);\n    my_turn();\n"
     "    wgmma_fence();"),
    ("    dq_product(dq, dsa, k_tile(last.slot));\n    wgmma_commit();\n"
     "    wgmma_wait<0>();",
     "    dq_product(dq, dsa, k_tile(last.slot));\n    wgmma_commit();\n"
     "    your_turn();\n    wgmma_wait<0>();"),
    ("    bar_arrive(v_empty(r.slot));\n  }\n",
     "    bar_arrive(v_empty(r.slot));\n    my_turn();\n    your_turn();\n"
     "  }\n  if (w == 0) my_turn();\n"),
]


def slots(n):
    return [("constexpr int kStages = 4;", f"constexpr int kStages = {n};")]


# name: replacements; "design" is the source as it is
VARIANTS = {
    "design (4 slots, q in registers)": [],
    "2 slots, q in shared memory": slots(2) + Q_IN_SHARED_MEMORY,
    "3 slots, q in shared memory": slots(3) + Q_IN_SHARED_MEMORY,
    "4 slots, q in shared memory": Q_IN_SHARED_MEMORY,
    "2 slots, q in registers": slots(2),
    "3 slots, q in registers": slots(3),
    "4 slots, q in registers, ping-pong": PING_PONG,
}


def variant_source(replacements) -> str:
    src = SRC.read_text()
    for old, new in replacements:
        assert src.count(old) == 1, f"not exactly once in the source: {old}"
        src = src.replace(old, new)
    return src


def build_variants(out_dir: Path):
    """One nvcc per variant, all started together; returns {name: (CDLL,
    ptxas report)}."""
    import chip_smoke
    from ray_tpu_torch.ops import _kernels
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, repl) in enumerate(VARIANTS.items()):
        src = out_dir / f"dq_variant_{i}.cu"
        src.write_text(variant_source(repl))
        lib = out_dir / f"libdq_variant_{i}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, f"-I{SRC.parent}",
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        cdll = ctypes.CDLL(str(lib))
        entry = cdll.flash_attention_dq
        entry.argtypes = _kernels.KERNELS["flash_attention_bwd"][1][
            "flash_attention_dq"]
        entry.restype = ctypes.c_int
        built[name] = (entry, chip_smoke.ptxas_report(
            log, "flash_dq_sm90_kernel"))
    return built


def compare_dq() -> None:
    import chip_smoke as cs
    from ray_tpu_torch.ops import flash_attention as tfa

    t0 = time.monotonic()
    built = build_variants(REPO / "ray_tpu_torch" / "_build" / "variants")
    print(f"variants built in {time.monotonic() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    B, H, L, D = cs.FLASH_SHAPE
    BH, scale = B * H, D ** -0.5
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn(BH, L, D, generator=g, device=dev)
                   .bfloat16() for _ in range(4))
    o, lse = tfa._fwd_reference(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    want = tfa._bwd_reference(q, k, v, lse, do, delta, True, scale)[0]
    stream = torch.cuda.current_stream().cuda_stream

    def call(entry, dq):
        rc = entry(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dq.data_ptr(), BH, L, L, D, 1, scale, stream)
        assert rc == 0, f"launch failed: cudaError {rc}"

    for name, (entry, ptxas) in built.items():
        a, b = torch.empty_like(q), torch.empty_like(q)
        call(entry, a)
        call(entry, b)
        torch.cuda.synchronize()
        ratio = cs.flash_ratios(a, want).max().item()
        assert ratio <= 1, f"{name}: {ratio} x the limit"
        print(f"{name}: worst {ratio:.3f} x the limit, repeatable "
              f"{torch.equal(a, b)}; ptxas: {ptxas}", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    names = list(built)
    times = {n: [] for n in names}
    dq = torch.empty_like(q)
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(cs.time_ms(
                lambda: call(built[name][0], dq), iters=20, flush=flush))
    bound, _ = cs.flash_bound_ms("flash_attention_dq", BH, L, L, D, True, 2)
    for name in names:
        ts = times[name]
        print(f"{name}: {' / '.join(f'{t:.4f}' for t in ts)} ms, "
              f"{bound / min(ts):.1%} of the bound ({bound:.4f} ms)",
              flush=True)


RING = REPO / "ray_tpu_torch" / "ops" / "csrc" / "paged_ring.cuh"


def stages(n):
    return [("constexpr int kStages = 2;", f"constexpr int kStages = {n};")]


# a walk that waits for each stage and frees it, and computes nothing
STREAM_ONLY = [("    // s = q . k^T: 4 n tiles of 8 slots\n",
                "    if (true) {\n      __syncwarp();\n"
                "      bar_arrive(empty(r.slot));\n      continue;\n    }\n"
                "    // s = q . k^T: 4 n tiles of 8 slots\n")]

ONE_CONSUMER = [("constexpr int kConsumers = 2;",
                 "constexpr int kConsumers = 1;")]

# the boxes stored as in the pool (rows of 128 bytes, no swizzle): the 8
# rows an ldmatrix reads on the same 4 banks, the K loads 2-way
UNSWIZZLED = [("CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_NONE"),
              ("(((c & 7) ^ (r & 7)) << 4)", "((c & 7) << 4)")]

# name: (replacements in paged_ring.cuh, whether the output is checked);
# the stages a multiple of the consumer warps (paged_ring.cuh says why)
RING_VARIANTS = {
    "design (2 stages of 32 slots, 2 consumer warps, swizzled)":
        ([], True),
    "unswizzled": (UNSWIZZLED, True),
    "4 stages": (stages(4), True),
    "6 stages": (stages(6), True),
    "streaming only (no products)": (STREAM_ONLY, False),
    "one consumer warp": (ONE_CONSUMER, True),
    "one consumer warp, 3 stages": (ONE_CONSUMER + stages(3), True),
}


def build_ring_variants(out_dir: Path):
    """One nvcc per variant (a copy of ops/csrc with the header's lines
    replaced), all started together; returns {name: entry point}."""
    import shutil
    from ray_tpu_torch.ops import _kernels
    procs = {}
    for i, (name, (repl, _)) in enumerate(RING_VARIANTS.items()):
        d = out_dir / f"ring_variant_{i}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(RING.parent, d)
        src = RING.read_text()
        for old, new in repl:
            assert src.count(old) == 1, f"not exactly once: {old}"
            src = src.replace(old, new)
        (d / RING.name).write_text(src)
        lib = d / "libpaged_attention.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib),
               str(d / "paged_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        entry = ctypes.CDLL(str(lib)).paged_attention
        entry.argtypes = _kernels.KERNELS["paged_attention"][1][
            "paged_attention"]
        entry.restype = ctypes.c_int
        built[name] = entry
    return built


def compare_ring() -> None:
    import chip_smoke as cs
    from ray_tpu_torch.ops import paged_attention as tpa

    t0 = time.monotonic()
    built = build_ring_variants(REPO / "ray_tpu_torch" / "_build" /
                                "variants")
    print(f"variants built in {time.monotonic() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for batch, (lens, max_pages, P, _, geometry) in \
            cs.DECODE_BATCHES.items():
        q, kp, vp, pt, sl = cs.decode_batch(dev, lens, max_pages, P,
                                            torch.bfloat16, **geometry)
        B, Hq, D = q.shape
        _, Hkv, ps, _ = kp.shape
        plan = tpa.decode_plan(B, Hq, Hkv, max_pages, ps)
        ref = tpa.paged_attention_reference(q, kp, vp, pt, sl)
        out = torch.empty_like(q)
        work = torch.empty(B * Hq * plan.splits * (D + 2), device=dev)

        def call(entry, pps=plan.pages_per_split):
            rc = entry(1, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                       pt.data_ptr(), sl.data_ptr(), out.data_ptr(),
                       work.data_ptr(), B, kp.shape[0], Hq, Hkv, ps, D,
                       max_pages, pps,
                       D ** -0.5, stream)
            assert rc == 0, f"launch failed: cudaError {rc}"

        names = list(built)
        for name in names:
            call(built[name])
            torch.cuda.synchronize()
            if RING_VARIANTS[name][1]:
                ratio = cs.decode_ratios(out, ref).max().item()
                assert ratio <= 1, f"{batch} {name}: {ratio} x the limit"
        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(cs.time_ms(lambda: call(built[name]),
                                              iters=20, flush=flush))
        vis = sl.clamp(0, max_pages * ps)
        bound, _ = cs.attention_bound_ms(q, kp, torch.ones_like(sl), vis,
                                         vis, False)
        # the design, the unswizzled walk and the streaming variant again
        # with the L2 left clean before each call (time_ms's clean flush)
        for name in (names[0], "unswizzled",
                     "streaming only (no products)"):
            times[f"{name}, clean L2"] = [cs.time_ms(
                lambda: call(built[name]), iters=20, flush=flush,
                clean=True) for _ in range(2)]
        for name, ts in times.items():
            print(f"batch {batch} (plan {tuple(plan)}), {name}: "
                  f"{' / '.join(f'{t:.4f}' for t in ts)} ms, "
                  f"{bound / min(ts):.1%} of the bound ({bound:.4f} ms)",
                  flush=True)
        del q, kp, vp, pt, sl, ref, out, work


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_compare: torch.cuda.is_available() is False; this "
              "script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    if sys.argv[1:2] == ["train"] and len(sys.argv) in (3, 4) \
            and sys.argv[3:] in ([], ["adafactor"], ["adamw"]):
        compare_train(Path(sys.argv[2]).resolve(),
                      (sys.argv[3:] or ["adafactor"])[0])
    elif sys.argv[1:2] == ["serve"] and len(sys.argv) == 3:
        compare_serve(Path(sys.argv[2]).resolve())
    elif sys.argv[1:] == ["telemetry"]:
        compare_telemetry()
    elif sys.argv[1:2] == ["decode"] and len(sys.argv) == 3:
        compare_decode(Path(sys.argv[2]).resolve())
    elif sys.argv[1:2] == ["flash"] and len(sys.argv) == 3:
        _in_turns(Path(sys.argv[2]).resolve(), FLASH, "flash")
    elif sys.argv[1:2] == ["phase6"] and len(sys.argv) == 3:
        _in_turns(Path(sys.argv[2]).resolve(), PHASE6, "phase 6")
    elif sys.argv[1:] == ["ring"]:
        compare_ring()
    elif sys.argv[1:] == ["dq"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        compare_dq()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
