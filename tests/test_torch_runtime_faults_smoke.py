"""chip_smoke.py's phase 22 (the runtime's failures with card workers) at a
small size on the CPU, each node told of one card: 22a and 22d, phase 4's
server (2 layers) named and detached behind a head started with a persist
path, its streams after the head's SIGKILL and restart equal to its
streams before, the card's books kept
across the re-registration, the gauge-free observability checks (print,
spans, burst capture); 22b, lineage and spill of a flash output (the
plain version in the card task); 22c, the OOM kill under a per-worker cap
above the measured RSS, the retry and the actor's death -> restart pair.
22e runs over two cards only; its program is
``tests/test_torch_train_straggler.py``'s."""

import sys
from pathlib import Path

import torch

import ray_tpu_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

MODEL = {"preset": "tiny", "n_layers": 2, "dtype": "float32"}
#: (B, H, L, D) of 22b's and 22c's flash output: 4 MiB in fp32, above the
#: inline threshold, so it lives in the arena
SHAPE = (2, 4, 1024, 128)


def test_head_restart_under_a_live_server_on_the_cpu():
    """The survivor's streams after the restart must equal its own before
    it (on the card also phase 4's). A setting an earlier ``init()`` of
    this process left in the config table (a per-worker cap the server's
    worker exceeds) must not reach the phase's daemons."""
    from ray_tpu_torch.core.config import GlobalConfig, reset_to_defaults
    GlobalConfig.apply({"worker_memory_limit_bytes": 64 << 20,
                        "memory_monitor_refresh_ms": 100})
    engine = dict(chip_smoke.MAIN_ENGINE, device="cpu")
    try:
        out = chip_smoke.phase_head_restart(MODEL, engine, num_gpus=1)
    finally:
        reset_to_defaults()
    assert out["launches"] == 0   # the plain version on CPU tensors
    assert max(out["restart_s"]) < chip_smoke.REREGISTER_BOUND_S
    assert not ray_tpu_torch.is_initialized()


def test_lineage_spill_and_oom_kill_on_the_cpu():
    b = chip_smoke.phase_lineage_spill(SHAPE, torch.float32, "cpu",
                                       num_gpus=1)
    assert b["launches"] == 0 and b["rss"] > 0
    c = chip_smoke.phase_oom(b["rss"], SHAPE, torch.float32, "cpu",
                             num_gpus=1, headroom=256 << 20,
                             ballast=256 << 20)
    assert c["launches"] == 0
    assert not ray_tpu_torch.is_initialized()
