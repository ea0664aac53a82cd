"""chip_smoke.py's phase 14 (the cluster runtime) at a small size on the
CPU: the node is told of one card, the server actor runs in the leased
worker process, and its token streams must equal the same requests served
in this process; tensors cross, the second lease waits for the first's
kill, and PPO's runners sample in worker processes."""

import sys
from pathlib import Path

import ray_tpu_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

MODEL = {"preset": "tiny", "n_layers": 2, "dtype": "float32"}


def test_chip_smoke_cluster_phase_on_the_cpu():
    engine = dict(chip_smoke.MAIN_ENGINE, device="cpu")
    here = chip_smoke.MainServer(MODEL, engine)
    try:
        streams = here.answer()
    finally:
        here.srv.shutdown()
    assert [len(s) for s in streams["wave"]] == [24, 16, 32, 32]
    assert len(streams["hit"]) == 16
    config, _, _ = chip_smoke.rl_cases()["PPO"]
    out = chip_smoke.phase_cluster(
        MODEL, engine, main_streams=streams, num_gpus=1,
        big_bytes=64 << 20, rl_case=(config, 2, float("-inf")))
    assert out["expected"] > 0 and not any(out["launches"].values())
    assert out["ppo_iterations"] >= 1
    assert not ray_tpu_torch.is_initialized()


def test_node_cards_tells_phases_14_and_15_of_one_card_of_several(
        monkeypatch):
    """On a machine of several cards the node of phases 14 and 15 is told
    of one (their checks are of one card); on one card it counts them."""
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert chip_smoke.node_cards(True, None) == 1
    assert chip_smoke.node_cards(True, 2) == 2
    assert chip_smoke.node_cards(False, None) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert chip_smoke.node_cards(True, None) is None
