"""chip_smoke.py's phase 23 (the object plane carrying flash outputs) at a
small size on the CPU: 23a on a three-node ``Cluster`` with the card's
chunk size and node layout, node B told of one card, its card worker
running the plain flash forward on CPU tensors. The phase asserts the
digests at the producer, the driver and every consumer, the spill reads
from B's spill files and the step into the card equal to the bit; here
also no launch (CPU tensors run the plain version). 23b's build phases
run on a stand-in ``nvcc``."""

import sys
from pathlib import Path

import torch

import ray_tpu_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

#: (B, H, L, D): 4 MiB outputs in fp32, 17 chunks of 256 KiB each
SHAPE = (2, 4, 1024, 128)


def test_phase_23a_on_the_cpu():
    out = chip_smoke.phase_transfer(SHAPE, torch.float32, "cpu", num_gpus=1)
    assert out["launches"] == 0
    start = out["start"]
    assert start["visible"] == "0" and start["ready_s"] > 0
    assert start["cuda_s"] >= 0 and start["library_s"] >= 0
    assert not ray_tpu_torch.is_initialized()


def test_phase_23b_build_phases_on_a_stand_in_nvcc(tmp_path, monkeypatch):
    """A cold build directory: one cache miss and one nameless record per
    library; a warm one: none."""
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util import compile_tracker
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nout=""\nwhile [ $# -gt 0 ]; do\n'
                    '  [ "$1" = "-o" ] && out="$2"\n  shift\ndone\n'
                    'sleep 0.05\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    tracker = compile_tracker.CompileTracker(role="driver")
    monkeypatch.setattr(compile_tracker, "_global", tracker)
    built = _kernels.build()
    cold = chip_smoke.build_phases(tracker, built)
    assert len(cold["records"]) == len(_kernels.KERNELS)
    assert chip_smoke.build_phases(tracker, _kernels.build()) is None
