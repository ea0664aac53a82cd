"""The port's chunked, striped cross-node object transfer against
ray_tpu's (``tests/test_object_transfer.py``).

Each of the JAX file's three programs runs on a three-node ``Cluster`` of
each package, booted with the JAX file's settings (256 KiB chunks, 128 MiB
arenas, its health-check periods), so every transfer larger than a chunk
takes the pipelined ``read_chunk`` path:
  - an 8 MB array made on node B read by the driver: its shape and spot
    values across chunk boundaries;
  - a 6 MB array made on node A digested on A, then on B, C, B and C: the
    digests (later pulls stripe over the copies the earlier ones left);
  - twenty 8 MB puts from a task on node C, which overflow its arena into
    spill files, read by the driver in chunks: the values of 0, 1, 10, 19.
Each program boots its own clusters, as the JAX file's fixture does.
What each returns must be equal between the packages. Then the port's
own cases: the same programs with a torch tensor in place of the numpy
array, one after another on one cluster, give the port's numpy results;
and a second release of an unpinned object leaves the store's eviction
working (running the programs in a row on one cluster hung a put in
eviction before: the owner's free released a secondary copy that its
pull had already released, which linked it into the LRU list twice).
"""

import gc
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
CHUNK = 256 * 1024
TIMEOUT = 180
#: tests/test_object_transfer.py's settings
SYSTEM_CONFIG = {
    "object_transfer_chunk_bytes": CHUNK,
    "health_check_period_ms": 200,
    "health_check_timeout_ms": 1500,
    "object_store_memory_bytes": 128 * 1024 * 1024,
}
#: each program's result, by program and package ("torch tensors": the
#: port's run with tensors)
SEEN = {}


def agree(program, pkg, value):
    """Keep ``value`` for (program, package); once both packages ran the
    program, their values must be equal."""
    SEEN.setdefault(program, {})[pkg] = value
    if all(p in SEEN[program] for p in PACKAGES):
        assert SEEN[program]["ray_tpu"] == SEEN[program]["ray_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def chunked(request):
    pkg = request.param
    rt = importlib.import_module(pkg)
    Cluster = importlib.import_module(f"{pkg}.cluster_utils").Cluster
    if pkg == "ray_tpu":
        # the JAX store's plain lock deadlocks when the cyclic collector
        # frees an ObjectRef inside it
        gc.disable()
    cluster = Cluster()
    try:
        cluster.add_node(num_cpus=2, resources={"nodeA": 1})
        cluster.add_node(num_cpus=2, resources={"nodeB": 1})
        cluster.add_node(num_cpus=2, resources={"nodeC": 1})
        rt.init(address=cluster.address, _system_config=SYSTEM_CONFIG)
        yield rt
    finally:
        rt.shutdown()
        cluster.shutdown()
        gc.enable()
        gc.collect()


def numpy_arrays():
    return {"arange": lambda n: np.arange(n, dtype=np.float64),
            "integers": lambda seed, n: np.random.default_rng(seed)
            .integers(0, 255, size=n, dtype=np.int64),
            "full": lambda n, v: np.full(n, v, np.float64)}


def torch_tensors():
    import torch
    return {"arange": lambda n: torch.arange(n, dtype=torch.float64),
            "integers": lambda seed, n: torch.from_numpy(
                np.random.default_rng(seed).integers(
                    0, 255, size=n, dtype=np.int64)),
            "full": lambda n, v: torch.full((n,), float(v),
                                            dtype=torch.float64)}


def multichunk_transfer_integrity(rt, make_array):
    """8 MB made on node B, 32 chunks, read by the driver: its shape and
    values spot-checked across chunk boundaries."""
    n = 1_000_000

    @rt.remote(resources={"nodeB": 0.1})
    def make():
        return make_array["arange"](n)

    out = np.asarray(rt.get(make.remote(), timeout=120))
    assert out.shape == (n,)
    idx = np.arange(0, n, 31_337)
    np.testing.assert_array_equal(out[idx], idx.astype(np.float64))
    return out.shape, out[idx].tolist()


def broadcast_to_many_nodes(rt, make_array):
    """One producer on A, consumers on every node: equal digests."""

    @rt.remote(resources={"nodeA": 0.1})
    def produce():
        return make_array["integers"](7, 750_000)   # ~6 MB

    @rt.remote
    def digest(x):
        return int(x.sum()), int(x.shape[0])

    ref = produce.remote()
    expected = rt.get(digest.options(resources={"nodeA": 0.1}).remote(ref),
                      timeout=120)
    outs = rt.get(
        [digest.options(resources={node: 0.1}).remote(ref)
         for node in ("nodeB", "nodeC", "nodeB", "nodeC")], timeout=180)
    assert all(o == expected for o in outs)
    return expected, outs


def spilled_object_chunked_read(rt, make_array):
    """Twenty 8 MB puts overflow node C's arena; the driver reads early
    (spilled) and late ones in chunks."""

    @rt.remote(resources={"nodeC": 0.1})
    def make_many():
        return [rt.put(make_array["full"](1_000_000, i)) for i in range(20)]

    refs = rt.get(make_many.remote(), timeout=TIMEOUT)
    got = []
    for i in [0, 1, 10, 19]:
        arr = np.asarray(rt.get(refs[i], timeout=120))
        assert float(arr[0]) == float(i) and arr.shape == (1_000_000,)
        got.append((float(arr[0]), float(arr[-1]), arr.shape))
    return got


PROGRAMS = [multichunk_transfer_integrity, broadcast_to_many_nodes,
            spilled_object_chunked_read]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_chunked_transfer_matches_ray_tpu(chunked, program):
    agree(program.__name__, chunked.__name__,
          program(chunked, numpy_arrays()))


@pytest.mark.parametrize("chunked", ["ray_tpu_torch"], indirect=True)
def test_torch_tensors_move_as_numpy_arrays_do(chunked):
    """The port's own case: each program with torch tensors, one after
    another on one cluster, gives what the port's numpy run gave (run
    here again if it has not run yet)."""
    for program in PROGRAMS:
        want = SEEN.get(program.__name__, {}).get("ray_tpu_torch")
        if want is None:
            want = program(chunked, numpy_arrays())
        assert program(chunked, torch_tensors()) == want, program.__name__


_RELEASE_TWICE = """
import os, sys
sys.path.insert(0, {root!r})
from ray_tpu_torch.core._native import ObjectStoreFull, ShmStore
store = ShmStore.create("/rtpt_release_twice_%d" % os.getpid(), 1 << 20, 64)
try:
    ids = [bytes([i]) * 28 for i in range(5)]
    store.put(ids[0], b"x" * 300_000)
    store.release(ids[0])            # the pull's release: evictable
    store.release(ids[0])            # the owner's free: no pin left
    for oid in ids[1:4]:             # the fourth put evicts ids[0]
        store.put(oid, b"y" * 300_000)
    assert not store.contains(ids[0])
    try:
        store.put(ids[4], b"z" * 300_000)  # nothing evictable: full
        full = False
    except ObjectStoreFull:
        full = True
    assert full and all(store.contains(i) for i in ids[1:4])
    print("ok")
finally:
    store.close()
    store.unlink()
"""


def test_a_second_release_leaves_eviction_working():
    """The port's store: a release of an object with no pin changes
    nothing, so a later put evicts it and then reports a full arena (in a
    subprocess with a time limit: the defect spun forever in eviction)."""
    code = _RELEASE_TWICE.format(root=str(Path(__file__).resolve()
                                          .parents[1]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
