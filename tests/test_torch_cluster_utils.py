"""The port's multi-node ``Cluster`` (``cluster_utils.py``) against the
JAX package's.

Each program of ``tests/test_multinode.py`` (cross-node object transfer
and ref passing, scheduling onto the one feasible node, node death) and
the placement-group programs that boot a cluster of their own
(``tests/test_placement_group.py``'s multi-slice program, with one card
per node in place of one slice, and ``tests/test_pg_local.py``) runs
through both packages and must reach the JAX file's gates in each. Then
the port's own case: a node added with no ``GPU`` in its resources
advertises none, even where ``CUDA_VISIBLE_DEVICES`` names a card.
"""

import importlib
import time

import numpy as np
import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def _pkg(name):
    rt = importlib.import_module(name)
    cluster_utils = importlib.import_module(f"{name}.cluster_utils")
    pg_mod = importlib.import_module(f"{name}.util.placement_group")
    return rt, cluster_utils.Cluster, pg_mod


@pytest.fixture(params=PACKAGES)
def two_node_cluster(request):
    rt, Cluster, _ = _pkg(request.param)
    cluster = Cluster()
    try:
        cluster.add_node(num_cpus=2, resources={"nodeA": 1})
        cluster.add_node(num_cpus=2, resources={"nodeB": 1})
        rt.init(address=cluster.address, _system_config={
            "health_check_period_ms": 200,
            "health_check_timeout_ms": 1500,
        })
        yield rt, cluster
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_cross_node_object_transfer(two_node_cluster):
    """A large result produced on node B is pulled to the driver's node."""
    rt, _ = two_node_cluster

    @rt.remote(resources={"nodeB": 0.1})
    def make_big():
        return np.arange(400_000, dtype=np.float64)

    out = rt.get(make_big.remote(), timeout=90)
    assert out.shape == (400_000,)
    assert float(out[-1]) == 399_999.0


def test_cross_node_ref_passing(two_node_cluster):
    """Object created on node A consumed by a task pinned to node B."""
    rt, _ = two_node_cluster

    @rt.remote(resources={"nodeA": 0.1})
    def produce():
        return np.ones(300_000)

    @rt.remote(resources={"nodeB": 0.1})
    def consume(x):
        return float(x.sum())

    assert rt.get(consume.remote(produce.remote()), timeout=90) == 300_000.0


def test_scheduling_spreads_to_feasible_node(two_node_cluster):
    rt, _ = two_node_cluster

    @rt.remote(resources={"nodeB": 1})
    def where():
        return "B"

    assert rt.get(where.remote(), timeout=60) == "B"


def test_node_death_detected_and_actor_dies(two_node_cluster):
    rt, cluster = two_node_cluster

    @rt.remote(resources={"nodeB": 0.1}, max_restarts=0)
    class PinnedB:
        def ping(self):
            return "pong"

    a = PinnedB.remote()
    assert rt.get(a.ping.remote(), timeout=60) == "pong"
    cluster.remove_node(cluster.nodes[1])  # SIGKILL: daemon + its workers

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if len([n for n in rt.nodes() if n["Alive"]]) == 1:
            break
        time.sleep(0.1)
    else:
        pytest.fail("head never marked the killed node dead")

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            rt.get(a.ping.remote(), timeout=10)
            time.sleep(0.2)
        except rt.exceptions.ActorError:
            break
    else:
        pytest.fail("actor on dead node kept answering")

    @rt.remote
    def alive_check():
        return 1

    assert rt.get(alive_check.remote(), timeout=60) == 1


@pytest.mark.parametrize("name", PACKAGES)
def test_one_gang_bundle_per_node_strict_spread(name):
    """Two gang bundles STRICT_SPREAD over two gang nodes: one per node,
    atomically; a third queues until they are removed."""
    rt, Cluster, pgm = _pkg(name)
    cluster = Cluster()
    node = {"ray_tpu": {"TPU": 4, "TPU-v5e": 4, "TPU-v5e-8-head": 1},
            "ray_tpu_torch": {"GPU": 1}}[name]
    gang = {"ray_tpu": "TPU-v5e-8-head", "ray_tpu_torch": "GPU"}[name]
    try:
        cluster.add_node(num_cpus=1, resources=node)
        cluster.add_node(num_cpus=1, resources=node)
        rt.init(address=cluster.address)
        pg = pgm.placement_group([{gang: 1}, {gang: 1}],
                                 strategy="STRICT_SPREAD")
        assert pg.wait(30)
        assert len(set(pg.state()["nodes"])) == 2
        pg2 = pgm.placement_group([{gang: 1}], strategy="STRICT_PACK")
        assert not pg2.wait(1.5)
        pgm.remove_placement_group(pg)
        assert pg2.wait(30)
        pgm.remove_placement_group(pg2)
    finally:
        rt.shutdown()
        cluster.shutdown()


@pytest.mark.parametrize("name", PACKAGES)
def test_local_mode_pg(name):
    rt, _, pgm = _pkg(name)
    rt.init(local_mode=True, num_cpus=4)
    try:
        pg = pgm.placement_group([{"CPU": 2}], strategy="PACK")
        assert pg.wait(5)
        bad = pgm.placement_group([{"CPU": 64}], strategy="PACK")
        assert not bad.wait(0.5)
        assert bad.state()["state"] == "INFEASIBLE"
    finally:
        rt.shutdown()


def test_added_nodes_advertise_only_the_cards_they_name(monkeypatch):
    """With ``CUDA_VISIBLE_DEVICES`` naming a card, a node daemon left to
    count cards finds it; ``Cluster.add_node`` must not let it, or every
    added node would advertise (and lease) the same card."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.runtime.protocol import RpcClient

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    cluster = Cluster()
    try:
        plain = [cluster.add_node(num_cpus=1) for _ in range(2)]
        card = cluster.add_node(num_cpus=1, resources={"GPU": 1})
        probe = RpcClient(cluster.address, name="gpu-trap")
        try:
            gpus = {n["node_id"]: n["resources"].get("GPU", 0.0)
                    for n in probe.call("list_nodes", timeout=10)}
            total = probe.call("cluster_resources", timeout=10)
        finally:
            probe.close()
        assert [gpus[n.node_id] for n in plain] == [0.0, 0.0]
        assert gpus[card.node_id] == 1.0
        assert total["GPU"] == 1.0
    finally:
        cluster.shutdown()
