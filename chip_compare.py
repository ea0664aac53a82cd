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
    python3 chip_compare.py sass PARENT_DIR
        the SASS (``cuobjdump -sass``) of the bf16 flash kernels' default
        tile variants in this checkout against the same kernels in the
        checkout in PARENT_DIR (before the kernels took a tile: the
        kernels of the one design), instruction by instruction: the
        count, and every instruction that differs.
    python3 chip_compare.py mixtral
        chip_smoke.py's Mixtral oracle (phase 10's fp32 Mixtral on the card
        against the CPU: every gradient's worst difference over its leaf's
        largest value, limit 1e-5) five times in one process, then once
        each in fresh processes with the CPU's sums on 1 thread, on all
        the machine's threads, and with
        ``torch.use_deterministic_algorithms(True)``; each run prints the
        worst leaf and the digests of the card's and the CPU's gradients,
        so a run that moves names the side that moved.
    python3 chip_compare.py lag PARENT_DIR [PROCESSES]
        how far a caller of chip_smoke.py's main path trails the flight
        recorder, for the checkout in PARENT_DIR and for this one, in
        PROCESSES fresh processes (8 if not given) in turns (parent, this,
        this, parent, ...) after both have built their kernels. Each runs
        phase 4 and then four waves at bench_llm.py's widths (phase 4b:
        the first wave of the process, then three warm ones). Each wave
        prints every caller timer's lag behind its record, the
        milliseconds from the engine's drain of a stream's first token to
        its caller, and the collector's pauses in the wave. First, the
        host alone: the stalls of a lone thread that reads the clock, and
        a blocked thread's wake-up.

Both print the card's name and power limit first. Each exits non-zero
without a CUDA device.
"""

import ctypes
import json
import re
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
if hasattr(tfa, '_launch_dq'):   # a tree whose kernels take a tile
    tiles = tfa.default_tiles(q.dtype, D)
    dq_run = lambda: tfa._launch_dq(q, k, v, do, lse, delta, dq, True,
                                    scale, tiles.dq)
    dkv_run = lambda: tfa._launch_dkv(q, k, v, do, lse, delta, dk, dv,
                                      True, scale, tiles.dkv)
else:
    dq_run = lambda: tfa._launch(
        'flash_attention_bwd', 'flash_attention_dq', dev, 1, q, k, v, do,
        lse, delta, dq, BH, L, L, D, 1, scale)
    dkv_run = lambda: tfa._launch(
        'flash_attention_bwd', 'flash_attention_dkv', dev, 1, q, k, v, do,
        lse, delta, dk, dv, BH, L, L, D, 1, scale)
out = {
    'fwd': cs.time_ms(lambda: tfa._fwd_cuda(q, k, v, True, scale),
                      iters=20, flush=flush),
    'dq': cs.time_ms(dq_run, iters=20, flush=flush),
    'dkv': cs.time_ms(dkv_run, iters=20, flush=flush)}
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


# ------------------------------------------------------ flash SASS

# the default variants' mangled template arguments, and what the same
# kernel carries in a checkout from before the kernels took a tile
SASS_DEFAULTS = [("flash_fwd_sm90_kernel", "ILi128ELi2EE", "kernelE14"),
                 ("flash_dq_sm90_kernel", "ILi64ELi4ELb0EE", "ILb0EE"),
                 ("flash_dq_sm90_kernel", "ILi64ELi4ELb1EE", "ILb1EE"),
                 ("flash_dkv_sm90_kernel", "ILi64ELi2EE", "kernelE14")]


def flash_sass(root: Path) -> dict:
    """{mangled kernel name: [instruction, ...]} of the flash libraries
    of the checkout at root, built there."""
    built = subprocess.run([sys.executable, "-c", (
        "import sys; sys.path.insert(0, '.'); "
        "from ray_tpu_torch.ops import _kernels; "
        "names = ['flash_attention_fwd', 'flash_attention_bwd']; "
        "_kernels.build(names); "
        "print(*[_kernels.library_path(n) for n in names])")],
        cwd=root, capture_output=True, text=True, check=True)
    funcs, name = {}, None
    for lib in built.stdout.split():
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                              capture_output=True, text=True,
                              check=True).stdout
        for line in sass.splitlines():
            head = re.match(r"\s+Function : (\S+)", line)
            if head:
                name = head.group(1)
                funcs[name] = []
                continue
            ins = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if name and ins:
                funcs[name].append(ins.group(1).strip())
    return funcs


def compare_sass(parent: Path) -> None:
    this, before = flash_sass(REPO), flash_sass(parent)
    for kernel, args, old_args in SASS_DEFAULTS:
        mine = [n for n in this if kernel in n and args in n]
        theirs = [n for n in before if kernel in n
                  and (args in n or old_args in n)]
        assert len(mine) == len(theirs) == 1, (kernel, mine, theirs)
        a, b = before[theirs[0]], this[mine[0]]
        differ = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
        print(f"{kernel} {args}: parent {len(a)}, this {len(b)} "
              f"instructions, {len(differ)} differ", flush=True)
        for i, x, y in differ:
            print(f"  {i}: parent {x!r} | this {y!r}", flush=True)


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


MIXTRAL = """
import json, os, sys, torch
sys.path.insert(0, '.')
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
{setup}
for _ in range({runs}):
    r = chip_smoke.mixtral_oracle_readings(torch.device('cuda'))
    print("ORACLE " + json.dumps({{"label": {label!r},
        "threads": torch.get_num_threads(), "worst": r["worst"],
        "rel": r["rel"][r["worst"]], "card": r["card"], "cpu": r["cpu"]}}),
        flush=True)
"""

MIXTRAL_SETTINGS = (
    ("default threads", "", 5),
    ("CPU on 1 thread", "torch.set_num_threads(1)", 1),
    ("CPU on all threads", "torch.set_num_threads(os.cpu_count())", 1),
    ("deterministic algorithms",
     "os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'\n"
     "torch.use_deterministic_algorithms(True)", 1))


def compare_mixtral() -> None:
    """The Mixtral oracle's readings under each of MIXTRAL_SETTINGS, each
    setting in a process of its own; then whether the card's gradients
    and the CPU's each came out equal to the bit across every run."""
    from ray_tpu_torch.ops import _kernels
    _kernels.build()
    readings = []
    for label, setup, runs in MIXTRAL_SETTINGS:
        out = subprocess.run(
            [sys.executable, "-c", MIXTRAL.format(setup=setup, runs=runs,
                                                  label=label)],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        lines = [json.loads(line[len("ORACLE "):])
                 for line in out.stdout.splitlines()
                 if line.startswith("ORACLE ")]
        if out.returncode != 0 or len(lines) != runs:
            print(f"{label}: rc {out.returncode}\n{out.stderr[-3000:]}",
                  flush=True)
        for r in lines:
            print(f"mixtral oracle, {label} ({r['threads']} CPU threads): "
                  f"worst {r['rel']:.3e} ({r['worst']}), card "
                  f"{r['card']}, CPU {r['cpu']}", flush=True)
        readings += lines
    for side in ("card", "cpu"):
        print(f"{side} gradients across the {len(readings)} runs: "
              f"{len({r[side] for r in readings})} distinct digests "
              f"{sorted({r[side] for r in readings})}", flush=True)
    print("ORACLE_READINGS " + json.dumps(readings), flush=True)


# ------------------------------------------------- a caller's lag


LAG_PAIR = re.compile(r"main path: request (\d+) .*")
LAG_TIME = re.compile(r"(TTFT|e2e) record ([\d.]+) ms vs timer ([\d.]+) ms")


def _lag_child(waves: int = 4) -> None:
    """One process of ``lag``, in the checkout on ``sys.path[0]``: phase
    4, then ``waves`` bench-width waves; prints one line "LAG {json}" a
    wave."""
    import gc
    import chip_smoke as cs
    from ray_tpu_torch.llm import engine as engine_mod
    from ray_tpu_torch.llm import serve_llm
    drains, callers, pauses, lines, servers = {}, {}, [], [], []
    log = cs.log

    def capture(msg):
        lines.append(msg)
        log(msg)

    cs.log = capture
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.monotonic()
        else:
            pauses.append((started["t"], time.monotonic() - started["t"]))

    gc.callbacks.append(on_gc)
    cls = engine_mod.InferenceEngine
    drain = cls.drain_progress

    def stamped_drain(self):
        out = drain(self)
        now = time.monotonic()
        for rid, toks in out.items():
            if toks:
                drains.setdefault(rid, now)
        return out

    cls.drain_progress = stamped_drain
    server_init = serve_llm.LLMServer.__init__
    stream = serve_llm.LLMServer.stream

    def init(self, *args, **kwargs):
        server_init(self, *args, **kwargs)
        servers.append(self)

    def stamped_stream(self, request):
        for item in stream(self, request):
            if item.get("token_ids") and not item.get("done"):
                callers.setdefault(item["request_id"], time.monotonic())
            yield item

    serve_llm.LLMServer.__init__ = init
    serve_llm.LLMServer.stream = stamped_stream
    cs.phase_main_path()
    cs.free_card()
    cs.phase_kernel(torch.device("cuda"), cs.BENCH_GEOMETRY)
    for wave in range(waves):
        for kept in (drains, callers, lines):
            kept.clear()
        del pauses[:]
        failed = None
        try:
            cs.phase_main_path(cs.BENCH_MODEL, cs.BENCH_ENGINE,
                               launch_stamp_fails=False)
        except AssertionError as e:
            failed = str(e)
        eng = servers[-1].engine
        recs = [eng.request_log.get(d["rid"])
                for d in servers[-1].request_records()]
        t_lo = min(r.t0 for r in recs)
        t_hi = max(r.t0 + r.finish_ts for r in recs
                   if r.finish_ts is not None)
        record_to_drain, drain_to_caller, submit = {}, {}, {}
        for rid, t_call in callers.items():
            rec = eng.request_log.get(rid)
            key = f"{rec.prompt_tokens} prompt tokens"
            record_to_drain[key] = round(
                (drains[rid] - rec.t0 - rec.first_ts) * 1e3, 3)
            drain_to_caller[key] = round((t_call - drains[rid]) * 1e3, 3)
            # the caller's timer less the record, less the drain's lag
            # behind the record and the caller's behind the drain: what
            # is left is the caller's submission before the record began
            submit[key] = t_call - (rec.t0 + rec.first_ts)
        lags, records = {}, {}
        for ln in lines:
            m = LAG_PAIR.match(ln)
            if m:
                for name, rec, timer in LAG_TIME.findall(ln):
                    lags[f"{name} {m.group(1)}"] = round(
                        float(timer) - float(rec), 2)
                    records[f"{name} {m.group(1)}"] = float(rec)
        for key, request in (("316 prompt tokens", "TTFT 0"),
                             ("9 prompt tokens", "TTFT 3")):
            if key in submit and request in lags:
                submit[key] = round(lags[request] - submit[key] * 1e3, 3)
            else:
                submit.pop(key, None)
        print("LAG " + json.dumps({
            "wave": wave, "failed": failed, "lag_ms": lags,
            "record_ms": records,
            "record_to_drain_ms": record_to_drain,
            "drain_to_caller_ms": drain_to_caller,
            "submission_ms": submit,
            "gc_in_wave_ms": [round(d * 1e3, 2) for t, d in pauses
                              if t < t_hi and t + d > t_lo],
            "gc_longest_in_phase_ms": round(max(
                (d for _, d in pauses), default=0.0) * 1e3, 2)}),
            flush=True)


def stall_probe(seconds: float = 15.0, pings: int = 3000) -> None:
    """What the host does to a thread on its own: the gaps over 1 ms in a
    lone thread that reads the clock in a loop, and the wake-up of a
    thread blocked on a ``queue.Queue`` (one put every 2 ms)."""
    import queue
    import threading
    gaps, end = [], time.monotonic() + seconds
    last = time.monotonic()
    while last < end:
        now = time.monotonic()
        if now - last > 1e-3:
            gaps.append(now - last)
        last = now
    q, back, wake = queue.Queue(), queue.Queue(), []

    def pong():
        for _ in range(pings):
            sent = q.get()
            wake.append(time.monotonic() - sent)
            back.put(None)

    thread = threading.Thread(target=pong)
    thread.start()
    for _ in range(pings):
        q.put(time.monotonic())
        back.get()
        time.sleep(0.002)
    thread.join()
    wake.sort()
    print(f"a lone thread over {seconds:.0f} s: {len(gaps)} gaps over 1 "
          f"ms, {sum(g > 5e-3 for g in gaps)} over 5 ms, the longest "
          f"{max(gaps, default=0.0) * 1e3:.2f} ms; a queue's wake-up over "
          f"{pings}: median {wake[pings // 2] * 1e3:.3f}, 99.9th "
          f"percentile {wake[int(pings * 0.999)] * 1e3:.3f}, most "
          f"{wake[-1] * 1e3:.3f} ms", flush=True)


def compare_lag(parent: Path, processes: int) -> None:
    stall_probe()
    _build_both(parent)
    runs = {}
    for i in range(processes):
        tag, d = (("parent", parent), ("this", REPO))[i % 4 in (1, 2)]
        out = subprocess.run(
            [sys.executable, str(REPO / "chip_compare.py"), "lag-child",
             str(d)], cwd=d, capture_output=True, text=True)
        if out.returncode:
            print(f"{tag} (process {i}) exited {out.returncode}: "
                  f"{out.stderr[-3000:]}", flush=True)
        for line in out.stdout.splitlines():
            if line.startswith("LAG "):
                print(f"{tag} (process {i}) {line}", flush=True)
                runs.setdefault(tag, []).append(json.loads(line[4:]))
    for tag, waves in runs.items():
        lag = sorted(v for w in waves for v in w["lag_ms"].values())
        call = sorted(v for w in waves
                      for v in w["drain_to_caller_ms"].values())
        first = [max(w["lag_ms"].values()) for w in waves
                 if w["wave"] == 0]
        ttft = sorted(w["record_ms"]["TTFT 0"] for w in waves
                      if "TTFT 0" in w["record_ms"])
        sub = sorted(v for w in waves for v in w["submission_ms"].values())
        rec = sorted(v for w in waves
                     for v in w["record_to_drain_ms"].values())
        full = sorted(w["gc_longest_in_phase_ms"] for w in waves)
        print(f"{tag}: {len(waves)} waves, "
              f"{sum(bool(w['failed']) for w in waves)} failed; the record "
              f"behind the timers: median {lag[len(lag) // 2]:.2f}, most "
              f"{lag[-1]:.2f} ms, the worst of each first wave {first}; "
              f"record to drain {rec[0]:.3f}-{rec[-1]:.3f} ms; "
              f"drain to caller: median {call[len(call) // 2]:.3f}, most "
              f"{call[-1]:.3f} ms; a stream's submission before its "
              f"record: median {sub[len(sub) // 2]:.3f}, most "
              f"{sub[-1]:.3f} ms; request 0's TTFT record: median "
              f"{ttft[len(ttft) // 2]:.2f} ms; collections in the waves "
              f"{sum(len(w['gc_in_wave_ms']) for w in waves)}, the "
              f"longest pause in a phase {full[0]:.2f}-{full[-1]:.2f} ms",
              flush=True)


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
    elif sys.argv[1:2] == ["sass"] and len(sys.argv) == 3:
        compare_sass(Path(sys.argv[2]).resolve())
    elif sys.argv[1:] == ["mixtral"]:
        compare_mixtral()
    elif sys.argv[1:] == ["ring"]:
        compare_ring()
    elif sys.argv[1:2] == ["lag"] and len(sys.argv) in (3, 4):
        compare_lag(Path(sys.argv[2]).resolve(),
                    int((sys.argv[3:] or ["8"])[0]))
    elif sys.argv[1:2] == ["lag-child"] and len(sys.argv) == 3:
        sys.path.insert(0, sys.argv[2])
        _lag_child()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
