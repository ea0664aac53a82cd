"""chip_smoke.py's phase 20 (several cards) on the CPU: each sub-phase
with a CPU form runs its rank programs through ``TorchTrainer`` over gloo
CPU ranks against their gloo twins, at tiny widths: 20a's group and
re-join, 20b's collectives over every axis, 20c's sharded train step on
its meshes, 20d's FSDP check (its first loss against one process's),
20e's ring, Ulysses, pipeline and ep programs on 4 ranks (20f's
timed-out group is tests/test_torch_group_timeout.py's, its shrink
tests/test_torch_trainer_cluster.py's program). On the CPU a run is its
own gloo twin: the comparisons run, trivially equal. Kept to about 35
s: 20d's timed steps and 20f's restore and grow run only on the cards.
20g and 20h need cards and log their skips, as phase 20 does on a
machine without enough of them."""

import sys
from pathlib import Path

import pytest
import torch

import ray_tpu_torch as rt

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SMALL = dict(preset="tiny", n_layers=2, dim=128, n_heads=4, n_kv_heads=2,
             ffn_dim=256, attention="flash", remat_policy="selective",
             dtype="float32")
BATCH = (2, 32)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 4})
    yield rt
    rt.shutdown()


def test_group_and_rejoin(cluster, tmp_path):
    out = chip_smoke.phase_group(False, tmp_path, sizes=(2,))
    assert [r["backend"] for r in out[2]] == ["gloo", "gloo"]


def test_collectives_against_their_twin(cluster, tmp_path):
    out = chip_smoke.phase_collectives(False, tmp_path, sizes=(2,),
                                       bus_bytes=1 << 16)
    assert {k.split(" over ")[0] for k in out[2]["bus"]} == set(
        chip_smoke.BUS_FACTOR)
    assert out[2]["worst"]["gather0 forward"] == 0.0


def test_sharded_train_against_its_twin(cluster, tmp_path):
    meshes = {2: {"fsdp2": dict(fsdp=2), "fsdp2_overlap": dict(fsdp=2)}}
    launches = chip_smoke.phase_sharded_train(
        False, tmp_path, sizes=(2,), meshes=meshes, tokens=(4, 16),
        model=dict(chip_smoke.SHARDED_MODEL, dim=128, ffn_dim=256))
    assert not any(launches[2].values())


def test_flagship_check_against_one_process(cluster, tmp_path):
    check, numbers = chip_smoke.phase_flagship(
        False, tmp_path, n=2, check_model=SMALL, model=None, batch=BATCH)
    assert numbers is None
    losses = [m["loss"] for m in chip_smoke.steps_of(check)]
    assert len(losses) == 2 and losses[1] < losses[0], losses


def test_axes_against_their_twin(cluster, tmp_path):
    launches = chip_smoke.phase_axes(False, tmp_path, qkv=(2, 32, 4, 16),
                                     tokens=(4, 16))
    assert not any(launches.values())


def test_card_phases_log_their_skips(capsys):
    assert chip_smoke.phase_tp_cards() is None
    assert chip_smoke.phase_tune_cards() is None
    assert chip_smoke.phase_multicard() == {"flash": [], "ragged": 0}
    said = capsys.readouterr()
    text = said.out + said.err
    for what in ("20g", "20h", "20a-20c", "20d-20h"):
        assert f"phase {what}: skipped, needs" in text, text
    worst = {}
    chip_smoke.hold("moved", [torch.zeros(2).numpy()],
                    [torch.ones(2).numpy()], None, worst)
    chip_smoke.hold_scalar("summed", 1.0, 1.0 + 1e-7, 1e-6, worst)
    assert worst["failed"] == ["moved [0]: inf of the bit"], worst
    with pytest.raises(AssertionError, match="moved"):
        chip_smoke.settle(worst, "a phase")
