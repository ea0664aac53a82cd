"""The port's autoscaler (``autoscaler.py``) against the JAX package's.

The bin packing (``Autoscaler._nodes_needed``) is a pure function of the
node-type catalog and the demand: both packages get the same catalogs and
demands and must answer alike, on the JAX file's TPU catalog and on a GPU
one. Then ``tests/test_autoscaler.py``'s cluster programs run through the
port, with a GPU node type in place of the TPU slice: a pending
``[{"GPU": 1}]`` bundle launches exactly that type and never a CPU type,
and the node drains once the placement group is removed. With
``CUDA_VISIBLE_DEVICES`` naming a card, the head node and the CPU nodes
still advertise none.
"""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu import autoscaler as jas
from ray_tpu_torch import autoscaler as tas
from ray_tpu_torch.runtime import instance_manager as im
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)


def _planner(mod, catalog):
    a = mod.Autoscaler.__new__(mod.Autoscaler)
    a.node_types = {name: mod.NodeTypeSpec(dict(res), max_workers=cap)
                    for name, (res, cap) in catalog.items()}
    return a


TPU_CATALOG = {
    "cpu": ({"CPU": 4.0}, 4),
    "v5e-8": ({"TPU": 8.0, "CPU": 4.0, "TPU-v5e-8-head": 1.0}, 2),
    "v5e-16": ({"TPU": 16.0, "CPU": 8.0, "TPU-v5e-16-head": 1.0}, 2),
}
GPU_CATALOG = {
    "cpu": ({"CPU": 4.0, "GPU": 0.0}, 4),
    "h100": ({"CPU": 4.0, "GPU": 1.0}, 2),
    "h100x4": ({"CPU": 16.0, "GPU": 4.0}, 1),
}
DEMANDS = {
    "TPU": [
        ([{"CPU": 1.0}] * 6, None),
        ([{"TPU-v5e-8-head": 1.0}], None),
        ([{"TPU-v5e-16-head": 1.0}], None),
        ([{"CPU": 2.0}, {"TPU-v5e-8-head": 1.0}, {"CPU": 2.0},
          {"TPU-v5e-16-head": 1.0}, {"CPU": 2.0}], None),
        ([{"TPU": 8.0}], None),
        ([{"TPU-v5e-8-head": 1.0}] * 5, {"v5e-8": 1}),
        ([], None),
    ],
    "GPU": [
        ([{"GPU": 1.0}], None),
        ([{"GPU": 1.0, "CPU": 1.0}] * 3, None),
        ([{"GPU": 4.0}], None),
        ([{"CPU": 1.0}] * 6, None),
        ([{"CPU": 2.0}, {"GPU": 1.0}, {"CPU": 3.0}, {"GPU": 2.0}], None),
        ([{"GPU": 1.0}] * 5, {"h100": 1}),
        ([{"GPU": 8.0}], None),
    ],
}


@pytest.mark.parametrize("catalog", ["TPU", "GPU"])
def test_bin_packing_matches_jax(catalog):
    cat = TPU_CATALOG if catalog == "TPU" else GPU_CATALOG
    want = [_planner(jas, cat)._nodes_needed(d, live)
            for d, live in DEMANDS[catalog]]
    got = [_planner(tas, cat)._nodes_needed(d, live)
           for d, live in DEMANDS[catalog]]
    assert got == want
    if catalog == "GPU":
        # a card bundle opens the one-card type, never a CPU host
        assert got[0] == {"h100": 1}
        assert got[2] == {"h100x4": 1}
        assert got[3] == {"cpu": 2}
        # capped at max_workers: the spare bundles go to the 4-card type
        assert got[5] == {"h100": 1, "h100x4": 1}
        assert got[6] == {}


def test_bin_packing_counts_nodes():
    a = _planner(tas, {"cpu": ({"CPU": 2.0}, 8)})
    assert a._nodes_needed([{"CPU": 1.0}] * 3) == {"cpu": 2}
    assert a._nodes_needed([{"CPU": 4.0}]) == {}
    assert a._nodes_needed([]) == {}
    assert a._nodes_needed([{"CPU": 2.0}, {"CPU": 2.0}]) == {"cpu": 2}


def _alive(n_want, timeout):
    """Poll until exactly ``n_want`` nodes are alive; the last reading."""
    deadline = time.monotonic() + timeout
    alive = [n for n in rt.nodes() if n["Alive"]]
    while time.monotonic() < deadline and len(alive) != n_want:
        time.sleep(0.25)
        alive = [n for n in rt.nodes() if n["Alive"]]
    return alive


def test_scale_up_then_down():
    cluster = tas.AutoscalingCluster(
        head_resources={"CPU": 1.0}, worker_node_type={"CPU": 2.0},
        max_workers=2, idle_timeout_s=3.0)
    try:
        rt.init(address=cluster.address,
                _system_config={"infeasible_grace_s": 60.0})

        @rt.remote(num_cpus=2)
        def heavy(i):
            time.sleep(1.0)
            return i

        out = rt.get([heavy.remote(i) for i in range(4)], timeout=120)
        assert sorted(out) == [0, 1, 2, 3]
        assert len(rt.nodes()) >= 2, "no worker node was launched"
        alive = _alive(1, 90)
        assert len(alive) == 1, f"idle nodes never scaled down: {alive}"
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_gpu_bundle_launches_the_gpu_type_and_drains(monkeypatch):
    """A pending ``[{"GPU": 1}]`` bundle launches exactly one node of the
    GPU type and none of the CPU type, while a CPU backlog in the same
    wave opens a CPU node; each type drains once its demand clears. The
    machine's card is visible to every daemon here
    (``CUDA_VISIBLE_DEVICES``), and still only the GPU node advertises
    one."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    cluster = tas.AutoscalingCluster(
        head_resources={"CPU": 1.0}, idle_timeout_s=2.0,
        node_types={
            "cpu": tas.NodeTypeSpec({"CPU": 2.0, "GPU": 0.0},
                                    max_workers=1),
            "h100": tas.NodeTypeSpec({"CPU": 2.0, "GPU": 1.0},
                                     max_workers=1)})
    scaler = cluster.autoscaler
    scaler.poll_period_s = 0.25
    try:
        rt.init(address=cluster.address,
                _system_config={"infeasible_grace_s": 60.0})
        assert rt.cluster_resources().get("GPU", 0.0) == 0.0

        @rt.remote(num_cpus=2)
        def heavy(i):
            time.sleep(0.5)
            return i

        pg = placement_group([{"GPU": 1}], strategy="STRICT_PACK")
        assert pg.wait(60), "GPU bundle never placed"
        assert sorted(rt.get([heavy.remote(i) for i in range(2)],
                             timeout=120)) == [0, 1]
        launched = [(r.node_type, r.node_id) for r in scaler.im.records()]
        assert sorted(t for t, _ in launched) == ["cpu", "h100"], launched
        gpu_node = next(nid for t, nid in launched if t == "h100")
        assert pg.bundle_node(0) == gpu_node
        gpus = {n["NodeID"]: n["Resources"].get("GPU", 0.0)
                for n in rt.nodes() if n["Alive"]}
        assert gpus.pop(gpu_node) == 1.0
        assert set(gpus.values()) == {0.0}, gpus
        assert rt.cluster_resources()["GPU"] == 1.0

        remove_placement_group(pg)
        alive = _alive(1, 45)
        assert len(alive) == 1, \
            f"idle nodes never scaled down: {[n['Resources'] for n in alive]}"
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and any(
                r.state != im.TERMINATED for r in scaler.im.records()):
            time.sleep(0.1)
        assert {r.state for r in scaler.im.records()} == {im.TERMINATED}
        assert [r.node_type for r in scaler.im.records()
                if r.node_type == "h100"] == ["h100"]
        assert scaler._provider_for("h100").list_live() == {}
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_main_runs_the_autoscaler_as_a_daemon(tmp_path):
    """``python -m ray_tpu_torch.autoscaler`` with a GPU node type at
    ``min_workers`` 1: the daemon launches the node, which advertises the
    one card its type names."""
    import json
    import subprocess
    import sys

    from ray_tpu_torch.runtime.cluster_backend import start_head
    from ray_tpu_torch.runtime.protocol import RpcClient

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    session = os.urandom(4).hex()
    head_proc, address = start_head(session)
    ledger = str(tmp_path / "provider.ledger")
    opts = {"session": session, "ledger_path": ledger, "poll_period_s": 0.2,
            "node_types": {"h100": {"resources": {"CPU": 1.0, "GPU": 1.0},
                                    "max_workers": 1, "min_workers": 1}}}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.autoscaler", address,
         json.dumps(opts)], cwd=root, stdout=subprocess.PIPE, text=True)
    probe = RpcClient(address, name="asc-main-test")
    try:
        assert proc.stdout.readline().strip() == "RTPT_AUTOSCALER_READY"
        deadline = time.monotonic() + 45
        nodes = []
        while time.monotonic() < deadline and not nodes:
            nodes = [n for n in probe.call("list_nodes", timeout=5)
                     if n["alive"]]
            time.sleep(0.2)
        assert len(nodes) == 1
        assert nodes[0]["resources"]["GPU"] == 1.0
    finally:
        proc.kill()
        proc.wait(timeout=10)
        provider = tas.LocalNodeProvider(address, session,
                                         ledger_path=ledger)
        for nid, meta in provider.list_live().items():
            provider.terminate_orphan(nid, meta)
        probe.close()
        head_proc.terminate()
        head_proc.wait(timeout=10)
