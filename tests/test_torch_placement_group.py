"""The port's placement groups and ``Cluster`` against the JAX package's.

Each program of ``tests/test_placement_group.py`` and
``tests/test_pg_local.py`` runs through both packages' multi-node
``Cluster`` (a head and two node daemons on this machine) and must reach
that file's gates in each. A bundle over the JAX package's TPU gang
resource (``TPU-v5p-8-head``) is a bundle over ``GPU`` in the port. Then
the port's own case: an actor placed in a ``{"GPU": 1}`` bundle gets a
worker of its own that sees the bundle's card. The programs that boot a
cluster of their own are in ``tests/test_torch_cluster_utils.py``.
"""

import importlib
import os

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]

#: the gang resource each package's cluster reserves a whole card (or
#: slice) with, and the extra resources of the node that holds it
GANG = {"ray_tpu": "TPU-v5p-8-head", "ray_tpu_torch": "GPU"}
GANG_NODE = {"ray_tpu": {"TPU": 4, "TPU-v5p": 4, "TPU-v5p-8-head": 1},
             "ray_tpu_torch": {"GPU": 1}}
PLAIN_NODE = {"ray_tpu": {"TPU": 4, "TPU-v5p": 4}, "ray_tpu_torch": {}}


def _pkg(name):
    rt = importlib.import_module(name)
    cluster_utils = importlib.import_module(f"{name}.cluster_utils")
    pg_mod = importlib.import_module(f"{name}.util.placement_group")
    return rt, cluster_utils.Cluster, pg_mod


@pytest.fixture(scope="module", params=PACKAGES)
def pgc(request):
    rt, Cluster, pg_mod = _pkg(request.param)
    cluster = Cluster()
    try:
        cluster.add_node(num_cpus=2, resources={
            "nodeA": 1, **GANG_NODE[request.param]})
        cluster.add_node(num_cpus=2, resources={
            "nodeB": 1, **PLAIN_NODE[request.param]})
        rt.init(address=cluster.address)
        yield rt, pg_mod, request.param
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_pg_pack_ready(pgc):
    rt, pgm, _ = pgc
    pg = pgm.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(30)
    st = pg.state()
    assert st["state"] == "CREATED"
    assert len(set(st["nodes"])) == 1
    pgm.remove_placement_group(pg)


def test_pg_strict_spread_lands_on_distinct_nodes(pgc):
    rt, pgm, _ = pgc
    pg = pgm.placement_group([{"CPU": 1}, {"CPU": 1}],
                             strategy="STRICT_SPREAD")
    assert pg.wait(30)
    assert len(set(pg.state()["nodes"])) == 2
    pgm.remove_placement_group(pg)


def test_pg_infeasible_stays_pending(pgc):
    rt, pgm, _ = pgc
    pg = pgm.placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert not pg.wait(2)
    assert pg.state()["state"] == "PENDING"
    pgm.remove_placement_group(pg)


def test_pg_queues_until_resources_free(pgc):
    rt, pgm, _ = pgc
    first = pgm.placement_group([{"CPU": 2}, {"CPU": 2}],
                                strategy="STRICT_SPREAD")
    assert first.wait(30)
    second = pgm.placement_group([{"CPU": 2}], strategy="PACK")
    assert not second.wait(1.5)
    pgm.remove_placement_group(first)
    assert second.wait(30), "queued PG never created after resources freed"
    pgm.remove_placement_group(second)


def test_task_runs_in_bundle(pgc):
    rt, pgm, name = pgc
    pg = pgm.placement_group([{"CPU": 1}, {"CPU": 1}],
                             strategy="STRICT_SPREAD")
    assert pg.wait(30)
    target = pg.bundle_node(1)
    worker_mod = f"{name}.core.worker"

    @rt.remote(placement_group=pg, placement_group_bundle_index=1,
               num_cpus=0)
    def where():
        import importlib
        return importlib.import_module(worker_mod).global_worker.node_id

    assert rt.get(where.remote(), timeout=60) == target
    pgm.remove_placement_group(pg)


def test_actor_in_pg_bundle(pgc):
    rt, pgm, name = pgc
    pg = pgm.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.wait(30)
    worker_mod = f"{name}.core.worker"

    @rt.remote
    class Where:
        def node(self):
            import importlib
            return importlib.import_module(worker_mod) \
                .global_worker.node_id

    a = Where.options(placement_group=pg,
                      placement_group_bundle_index=0).remote()
    assert rt.get(a.node.remote(), timeout=60) == pg.bundle_node(0)
    rt.kill(a)
    pgm.remove_placement_group(pg)


def test_gang_reservation(pgc):
    """A one-bundle PG over the gang resource (the JAX package's slice
    head, the port's card) lands on node A, the only node with it; a
    second one queues until the first is removed."""
    rt, pgm, name = pgc
    gang = GANG[name]
    pg = pgm.placement_group([{gang: 1}], strategy="STRICT_PACK")
    assert pg.wait(30)
    holder = next(n["NodeID"] for n in rt.nodes()
                  if n["Resources"].get(gang))
    assert pg.state()["nodes"][0] == holder
    pg2 = pgm.placement_group([{gang: 1}], strategy="STRICT_PACK")
    assert not pg2.wait(1.5)
    pgm.remove_placement_group(pg)
    assert pg2.wait(30)
    pgm.remove_placement_group(pg2)


@pytest.mark.parametrize("pgc", ["ray_tpu_torch"], indirect=True)
def test_gpu_bundle_actor_sees_its_card(pgc):
    """The port only: an actor asking for the card in a ``{"GPU": 1,
    "CPU": 1}`` bundle runs on the bundle's node, in a worker of its own
    that sees the card (``CUDA_VISIBLE_DEVICES``; no CUDA is touched
    here). The JAX package's head leases a PG actor's worker with the
    actor's empty accounting shape, so its PG actors get no chips; the
    port's sends the physical shape."""
    rt, pgm, name = pgc
    pg = pgm.placement_group([{"GPU": 1, "CPU": 1}], strategy="STRICT_PACK")
    assert pg.wait(30)

    @rt.remote(num_gpus=1)
    class Card:
        def where(self):
            import os

            from ray_tpu_torch.core.worker import global_worker
            return global_worker.node_id, \
                os.environ.get("CUDA_VISIBLE_DEVICES")

    a = Card.options(placement_group=pg,
                     placement_group_bundle_index=0).remote()
    node, visible = rt.get(a.where.remote(), timeout=60)
    assert node == pg.bundle_node(0)
    assert visible == "0"
    rt.kill(a)
    pgm.remove_placement_group(pg)


@pytest.mark.parametrize("pgc", ["ray_tpu_torch"], indirect=True)
def test_removing_a_pg_ends_its_actors(pgc):
    """The port only: removing a placement group kills the actors placed
    in its bundles, as the reference's does (the JAX package's head
    leaves them running), and frees the bundle's card for the next
    lease."""
    import time

    rt, pgm, name = pgc
    pg = pgm.placement_group([{"GPU": 1, "CPU": 1}], strategy="STRICT_PACK")
    assert pg.wait(30)

    @rt.remote(num_gpus=1)
    class Card:
        def pid(self):
            import os
            return os.getpid()

    a = Card.options(placement_group=pg,
                     placement_group_bundle_index=0).remote()
    pid = rt.get(a.pid.remote(), timeout=60)
    pgm.remove_placement_group(pg)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        pytest.fail("the actor's worker outlived its placement group")
    with pytest.raises(rt.exceptions.ActorError):
        rt.get(a.pid.remote(), timeout=30)
    # the card is free again: a plain lease of it is placed
    b = Card.remote()
    assert rt.get(b.pid.remote(), timeout=60) != pid
    rt.kill(b)
