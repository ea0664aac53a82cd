"""chip_smoke.py's phase 16 at a small size on the CPU: 16a's per-shard
flash checks with the kernel entry points replaced by the plain versions
(the card's launches cannot run here), then 16b and 16c through
``TorchTrainer`` over a gloo group of one CPU worker: phase 7's run at a
small width first (in this process, as chip_smoke runs it), the
trainer's losses equal to it, and the restart from the sharded
checkpoint equal to an uninterrupted run."""

import sys
from pathlib import Path

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.ops import flash_attention as tfa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SMALL = dict(chip_smoke.TRAIN_CONFIG, vocab_size=512, dim=256, n_layers=2,
             n_heads=2, n_kv_heads=1, ffn_dim=512)
BATCH = (2, 64)


def test_flash_shards_phase_on_the_cpu(monkeypatch):
    def plain_bwd(library, entry, device, code, q, k, v, do, lse, delta,
                  *outs_and_sizes):
        """The backward kernels' entry points as the plain version, on
        the pointers' tensors (what _bwd_cuda would launch)."""
        dq, dk, dv = tfa._bwd_reference(q, k, v, lse, do, delta, True,
                                        outs_and_sizes[-1])
        outs = outs_and_sizes[:1] if entry.endswith("dq") \
            else outs_and_sizes[:2]
        for dst, src in zip(outs, (dq,) if entry.endswith("dq")
                            else (dk, dv)):
            dst.copy_(src)

    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(tfa, "_fwd_cuda", lambda q, k, v, c, s:
                        tfa._fwd_reference(q, k, v, c, s))
    monkeypatch.setattr(tfa, "_launch", plain_bwd)
    out = chip_smoke.phase_flash_shards(
        torch.device("cpu"), shards={"dp 2": (1, 4, 2), "tp 2": (1, 2, 1)},
        L=128, D=64)
    assert set(out) == {"dp 2", "tp 2"}
    assert all(r <= 1 for o in out.values() for r in o["ratios"].values())


def test_trainer_phase_on_the_cpu():
    cpu = torch.device("cpu")
    chip_smoke.TRAIN_RUNS.clear()
    chip_smoke.phase_train(cpu, SMALL, BATCH, profile=False)
    launches = chip_smoke.phase_trainer(cpu, SMALL, BATCH,
                                        restart_config=SMALL,
                                        restart_batch=BATCH)
    assert not any(launches.values())
    assert not ray_tpu_torch.is_initialized()
    with pytest.raises(ValueError):
        tfa.check_shard_geometry(torch.zeros(1, 4, 2, 8),
                                 torch.zeros(1, 4, 1, 8),
                                 torch.zeros(1, 4, 2, 8))
