"""chip_smoke.py's phase 21 rehearsed on the CPU at tiny widths, through
its own phase functions: phase 4's requests through a server here
(``MainServer``), then ``phase_pressure`` on the same weights: 21a int8
pools at phase 4's traffic (the page ratio at equal bytes, the launches,
the streams against phase 4's, the kernel's wrapper on the engine's live
pools), 21b copy-on-write, 21c eviction and 21d recompute preemption with
fp32 and with int8 pools, and 21e a tp=2 server over int8 pools with both
shards on the CPU. The ragged op's wrapper counts a launch per call as on
the card (int8 pools apart) and calls the plain version.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TINY = {"preset": "tiny", "n_layers": 2, "dtype": "float32"}


@pytest.fixture
def counting(monkeypatch):
    """The ragged op counting a launch per call on the CPU, and one more
    under its own key on int8 pools, as its wrapper does on the card."""
    from ray_tpu_torch.llm import model as tmodel
    from ray_tpu_torch.ops import paged_attention as tpa
    ragged = tmodel.ragged_paged_attention

    def count_ragged(*args, **kwargs):
        tpa.launch_counts["ragged_paged_attention"] += 1
        if kwargs.get("k_scale") is not None:
            tpa.launch_counts["ragged_paged_attention_int8"] += 1
        return ragged(*args, **kwargs)

    monkeypatch.setattr(tmodel, "ragged_paged_attention", count_ragged)
    monkeypatch.setattr(chip_smoke, "profile_device",
                        lambda fn, *a, **k: (fn(), "not measured"))


#: the main path's engine with chunks of 128 and sequences of 1024 tokens,
#: which cut the plain attention's work on the CPU, and the pools sized
#: for that schedule as phase 21's are for the card's (the schedule does
#: not depend on the model): after the wave 25 of 63 pages are free and a
#: 600-token prompt needs 38; the wave outgrows 44 pages with 3
#: preemptions, none at the cap
ENGINE = dict(chip_smoke.MAIN_ENGINE, device="cpu", prefill_chunk=128,
              max_seq_len=1024)
SIZES = {"EVICT_PAGES": 64, "EVICT_PROMPT": 600, "PREEMPT_PAGES": 44}


def test_phase_21_on_the_cpu(counting, capsys, monkeypatch):
    from ray_tpu_torch.ops import paged_attention as tpa
    for name, value in SIZES.items():
        monkeypatch.setattr(chip_smoke, name, value)
    engine = ENGINE
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
    assert main > 0 and tpa.launch_counts["ragged_paged_attention_int8"] == 0
    out = chip_smoke.phase_pressure(streams, main, TINY, engine)
    lines = capsys.readouterr().out
    # 21a: at fp32 the int8 pool takes 4 x head dim 8 / (8 + 2) the pages
    assert "1638 (4193280 bytes), 3.1992 x the pages" in lines
    # on the CPU the wrapper runs the plain version on both sides
    assert out["max_abs_err"] == 0
    # 21a's wave and hits as phase 4's, 21e's twice that; the engines of
    # 21b-21d between
    assert f"ragged launches {main}, on int8 pools {main}" in lines
    assert f"ragged launches {2 * main} = 2 x {main} (int8 pools " \
        f"{2 * main}; 21a: {main})" in lines
    assert out["launches"] > 3 * main
    for kv in ("float32", "int8"):
        assert f"21b ({kv} pools" in lines and f"21c ({kv} pools" in lines
        assert f"21d ({kv} pools, 44 pages): 3 preemptions" in lines
    assert "finish reasons ['length', 'length', 'length', 'length']" in lines


def test_hold_streams_passes_a_near_tie_and_fails_a_clear_margin():
    """The margin rule on a tiny bf16 model: a parting at the real
    context's margin passes under a floor above it, and fails under a
    floor below it (with the model in fp32, whose bf16 noise is 0)."""
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.models.llama import init_params
    cfg = model_config_from_dict(TINY)
    params = init_params(cfg, 7, "cpu")
    prompt = [5, 17, 42, 9]
    margin, noise = chip_smoke.margin_and_noise(params, cfg, prompt)
    assert noise == 0 and margin > 0
    want = [1, 2, 3]
    got = [1, 2, 4]
    with pytest.raises(AssertionError, match="clear margin"):
        chip_smoke.hold_streams("x", [(prompt[:-2], got, want)], params,
                                cfg, floor=0.0)
    compared, total, parted = chip_smoke.hold_streams(
        "x", [(prompt[:-2], got, want), (prompt, want, want)], params, cfg,
        floor=1e9)
    assert (compared, total) == (5, 6) and parted[0][:2] == (0, 2)
