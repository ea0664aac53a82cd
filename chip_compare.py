#!/usr/bin/env python3
"""Comparisons on one NVIDIA GPU that ``chip_smoke.py`` does not make.

    python3 chip_compare.py train PARENT_DIR
        phase 7 of chip_smoke.py (the 1.23B training step, 2 warm-up and
        5 timed steps, then the step profiler and one step under
        torch.profiler) for the checkout in PARENT_DIR and for this one,
        in turns: parent, this, this, parent, each in its own process
        after both have built their kernels. Make the parent's checkout
        with ``git archive <commit> | tar -x -C PARENT_DIR``.
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
chip_smoke.phase_train(torch.device('cuda'))
"""


def compare_train(parent: Path) -> None:
    build = ("import sys; sys.path.insert(0, '.'); "
             "from ray_tpu_torch.ops import _kernels; _kernels.build()")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d)
             for d in (parent, REPO)]
    assert all(p.wait() == 0 for p in procs), "a build failed"
    for tag, d in (("parent", parent), ("this", REPO), ("this", REPO),
                   ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", TRAIN], cwd=d,
                             capture_output=True, text=True, check=True)
        for line in out.stdout.splitlines():
            if line.startswith("training: step") or "profile_train" in line \
                    or "under the profiler" in line:
                print(f"{tag}: {line[:400]}", flush=True)


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
    if sys.argv[1:2] == ["train"] and len(sys.argv) == 3:
        compare_train(Path(sys.argv[2]).resolve())
    elif sys.argv[1:] == ["dq"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        compare_dq()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
