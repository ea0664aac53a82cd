"""The port's sharded paths on two and four NVIDIA cards over NCCL, each
against the same rank program over gloo CPU ranks (chip_smoke.py's phase
20 functions, at their narrow widths): every collective over every axis
(2 cards), the sharded train step on dp 2, fsdp 2 and tp 2 (2 cards), a
mesh group whose peer stays away failing within the group's timeout (2
cards), the fused ring of flash blocks, Ulysses, pp 2 and dp 2 x ep 2 (4
cards), and a rank killed mid-run with the run resuming on 3 cards (4
cards). Each test skips below the cards it needs; the module needs an
NVIDIA GPU:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_multicard_cuda.py
"""

import sys
from pathlib import Path

import pytest
import torch

import ray_tpu_torch as rt

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs NVIDIA GPUs: NCCL groups of cards")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, torch.cuda.device_count() is "
                    f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def cards_cluster():
    """A cluster with every card of the machine and room for the gloo
    twins' CPU workers beside the card workers."""
    if not torch.cuda.is_available():
        pytest.skip("needs NVIDIA GPUs: NCCL groups of cards")
    rt.init(num_cpus=chip_smoke.MULTI_CPUS,
            num_gpus=torch.cuda.device_count(), _system_config={
                "object_store_memory_bytes": chip_smoke.MULTI_STORE_BYTES})
    yield rt
    rt.shutdown()


@pytest.mark.cuda
def test_collectives_over_two_cards_match_gloo(cards_cluster, tmp_path):
    _cards(2)
    out = chip_smoke.phase_collectives(True, tmp_path, sizes=(2,),
                                       bus_bytes=16 << 20)
    assert out[2]["worst"]["shift+1 forward"] == 0.0
    assert all(v["busbw_GBps"] > 0 for v in out[2]["bus"].values())


@pytest.mark.cuda
def test_sharded_step_over_two_cards_matches_gloo(cards_cluster, tmp_path):
    _cards(2)
    launches = chip_smoke.phase_sharded_train(True, tmp_path, sizes=(2,))
    assert launches[2]["flash_attention_fwd"] > 0
    assert launches[2]["flash_attention_fwd_reference_cuda"] == 0


@pytest.mark.cuda
def test_a_mesh_group_on_cards_times_out():
    _cards(2)
    line, said = chip_smoke.group_timeout_check(True, 20.0, "fsdp")
    assert said[:1] != ["returned"], line


@pytest.mark.cuda
def test_ring_ulysses_pp_and_ep_over_four_cards_match_gloo(cards_cluster,
                                                           tmp_path):
    _cards(4)
    launches = chip_smoke.phase_axes(True, tmp_path, ring_timed=(1, 512, 8,
                                                                 128))
    assert launches["flash_attention_dkv"] > 0


@pytest.mark.cuda
def test_a_killed_rank_resumes_on_three_cards(cards_cluster, tmp_path):
    _cards(4)
    chip_smoke.phase_shrink(True, tmp_path)
