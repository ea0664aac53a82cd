"""chip_smoke.py's phase 17 rehearsed on the CPU at tiny widths, through
its own phase functions: 17a (phase 4's requests through a tp=2 server,
both shards on the CPU, against phase 4's streams and launches), 17b (a
tp=4 engine, every shard's attention held against the plain version)
and 17c (the ring's per-rotation work for every virtual rank against
one whole-sequence flash call). The kernels' wrappers count a launch per
call as they do on the card, and call the plain versions.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
TINY = {"preset": "tiny", "n_layers": 2, "dtype": "float32"}


@pytest.fixture
def counting(monkeypatch):
    """The ragged op and the flash forward and backward counting a launch
    per call on the CPU, as their kernels' wrappers do on the card."""
    from ray_tpu_torch.llm import model as tmodel
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.ops import paged_attention as tpa
    ragged, fwd, bwd = (tmodel.ragged_paged_attention, tfa._fwd_call,
                        tfa._bwd_call)

    def count_ragged(*args, **kwargs):
        tpa.launch_counts["ragged_paged_attention"] += 1
        return ragged(*args, **kwargs)

    def count_fwd(*args, **kwargs):
        tfa.launch_counts["flash_attention_fwd"] += 1
        return fwd(*args, **kwargs)

    def count_bwd(*args, **kwargs):
        tfa.launch_counts["flash_attention_dq"] += 1
        tfa.launch_counts["flash_attention_dkv"] += 1
        return bwd(*args, **kwargs)

    monkeypatch.setattr(tmodel, "ragged_paged_attention", count_ragged)
    monkeypatch.setattr(tfa, "_fwd_call", count_fwd)
    monkeypatch.setattr(tfa, "_bwd_call", count_bwd)
    monkeypatch.setattr(chip_smoke, "profile_device",
                        lambda fn, *a, **k: (fn(), "not measured"))
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, *a, **k: (fn(), 1.0)[1])


def test_phase_17a_tp_serving_on_the_cpu(counting):
    """Phase 4's requests through a tp=1 server here (``MainServer``, the
    prefix hit sent twice as phase 4 sends it; phase 4 itself holds the
    recorder to wall-clock timers, which a loaded CPU misses), then 17a
    on the tiny fp32 model: the tp=2 server gives the same streams, with
    2 x the ragged calls."""
    from ray_tpu_torch.ops import paged_attention as tpa
    engine = dict(chip_smoke.MAIN_ENGINE, device="cpu")
    tpa.launch_counts["ragged_paged_attention"] = 0
    here = chip_smoke.MainServer(TINY, engine)
    try:
        streams = here.answer()
        eng = here.srv.engine
        _, hit_req = chip_smoke.main_requests(eng.cfg.vocab_size,
                                              eng.prefill_chunk)
        assert here.srv(hit_req)["token_ids"] == streams["hit"]
    finally:
        here.srv.shutdown()
    main = tpa.launch_counts["ragged_paged_attention"]
    assert main > 0
    out = chip_smoke.phase_tp_serving(
        TINY, engine, main_streams=streams, main_launches=main,
        devices=("cpu", "cpu"))
    assert out["parted"] == []
    assert out["streams"] == streams["wave"] + [streams["hit"]]
    assert out["launches"] == 2 * main


def test_margin_and_noise_reads_the_bf16_forward():
    """The divergence rule's two numbers on a bf16 tiny model: a top-2
    margin, and a nonzero distance of the bf16 logits from fp32's."""
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.models.llama import init_params
    cfg = model_config_from_dict({"n_layers": 2})
    params = {k: (v.bfloat16() if not isinstance(v, dict) else
                  {n: t.bfloat16() for n, t in v.items()})
              for k, v in init_params(cfg, 7, "cpu").items()}
    margin, noise = chip_smoke.margin_and_noise(params, cfg, [5, 17, 42, 9])
    assert margin >= 0 and 0 < noise < 1


def test_phase_17b_tp4_shards_on_the_cpu(counting):
    from ray_tpu_torch.ops import paged_attention as tpa
    out = chip_smoke.phase_tp_shards(
        CPU, TINY, dict(chip_smoke.MAIN_ENGINE, device="cpu"), tp=4,
        prompt_lens=(40, 9), new_tokens=4)
    assert out["worst"] == 0          # the plain version against itself
    assert out["launches"] == tpa.launch_counts["ragged_paged_attention"] > 0


def test_phase_17c_off_diagonal_block_against_plain_on_the_cpu():
    ratios, lse_err = chip_smoke.ring_block_against_plain(
        CPU, shard=(1, 2, 32, 16), dtype=torch.float32)
    assert set(ratios) == {"o", "dq", "dk", "dv"}
    # on the CPU the wrappers run the plain versions: equal to the bit
    assert max(ratios.values()) == 0 and lse_err == 0


def test_phase_17c_ring_blocks_on_the_cpu(counting):
    out = chip_smoke.phase_ring_blocks(CPU, shard=(1, 2, 32, 16),
                                       degrees=(2, 4), dtype=torch.float32)
    assert chip_smoke.ring_blocks(4) == 10
    for sp, r in out.items():
        assert r["launches"] == {
            name: chip_smoke.ring_blocks(sp) for name in (
                "flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv")}
        assert max(r["ratios"].values()) < 1e-2   # fp32: sum order only
