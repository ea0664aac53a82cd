"""The port's multi-process cluster runtime against ray_tpu's: tasks,
objects through the shm store, and the state API.

Each program of ``tests/test_cluster.py`` runs once through each
package's cluster (head, node daemon, worker processes and the C++ shm
store, booted by ``init()``), and must give the result the JAX package's
test asserts, so both packages give equal results; an error must be of the
same class in both. The fixture boots one cluster per package and module;
pytest runs every program on one package before booting the other.
"""

import importlib
import time

import numpy as np
import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(scope="module", params=PACKAGES)
def rt(request):
    mod = importlib.import_module(request.param)
    mod.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 2,
        "health_check_period_ms": 200,
        "health_check_timeout_ms": 1500,
    })
    yield mod
    mod.shutdown()


def worker_of(rt):
    return importlib.import_module(f"{rt.__name__}.core.worker") \
        .global_worker


def test_task_roundtrip(rt):
    @rt.remote
    def add(a, b, scale=1):
        return (a + b) * scale

    assert rt.get(add.remote(1, 2), timeout=60) == 3
    assert rt.get(add.remote(1, 2, scale=10), timeout=30) == 30


def test_parallel_tasks(rt):
    @rt.remote
    def slp(i):
        time.sleep(0.4)
        return i

    rt.get([slp.remote(i) for i in range(4)], timeout=60)   # warm the pool
    t0 = time.monotonic()
    out = rt.get([slp.remote(i) for i in range(4)], timeout=60)
    dt = time.monotonic() - t0
    assert out == [0, 1, 2, 3]
    # 4 x 0.4 s sleeps must overlap across worker processes
    assert dt < 1.3, f"tasks did not run in parallel: {dt:.2f}s"


def test_parallel_burst_without_cached_leases(rt):
    """A burst submitted while no lease is cached must still fan out."""
    @rt.remote
    def slp(i):
        time.sleep(0.5)
        return i

    rt.get([slp.options(name="warm").remote(i) for i in range(4)],
           timeout=60)
    # let the cached idle leases reap (lease_idle_linger_s=0.5)
    time.sleep(1.2)
    t0 = time.monotonic()
    out = rt.get([slp.remote(i) for i in range(4)], timeout=60)
    dt = time.monotonic() - t0
    assert out == [0, 1, 2, 3]
    assert dt < 1.8, f"burst did not run in parallel: {dt:.2f}s"


def test_large_object_via_shm(rt):
    arr = np.arange(500_000, dtype=np.float64)
    ref = rt.put(arr)
    # big values are sealed in the shm store, not the memory store
    assert worker_of(rt).backend.object_plane.store.contains(
        ref.id().binary())
    assert np.array_equal(arr, rt.get(ref, timeout=30))


def test_ref_args_and_nested_refs(rt):
    @rt.remote
    def double(x):
        return x * 2

    @rt.remote
    def sum_list(refs):
        return sum(rt.get(refs, timeout=30))

    a = rt.put(np.ones(200_000))   # shm-sized
    b = double.remote(a)
    assert float(rt.get(b, timeout=30).sum()) == 400_000.0
    small = [rt.put(i) for i in range(5)]
    assert rt.get(sum_list.remote(small), timeout=30) == 10


def test_task_error_propagation(rt):
    @rt.remote
    def boom():
        raise ValueError("kapow-task")

    with pytest.raises(rt.exceptions.TaskError, match="kapow-task") as e:
        rt.get(boom.remote(), timeout=30)
    assert e.value.cause_cls_name == "ValueError"


def test_nested_task_submission(rt):
    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=30) + 100

    assert rt.get(outer.remote(1), timeout=60) == 102


def test_wait(rt):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(2.0)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, pending = rt.wait([f, s], num_returns=1, timeout=10)
    assert ready == [f] and pending == [s]
    assert rt.get(s, timeout=30) == "slow"


def test_refcount_frees_shm_object(rt):
    arr = np.arange(300_000, dtype=np.float64)
    ref = rt.put(arr)
    key = ref.id().binary()
    store = worker_of(rt).backend.object_plane.store
    rt.get(ref, timeout=30)
    assert store.contains(key)
    del ref
    deadline = time.monotonic() + 10
    while store.contains(key) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not store.contains(key), "shm object not freed after last ref died"


def test_chaos_rpc_injection_retries(rt):
    """The first push_task call fails by injection; the lease-retry path
    recovers."""
    config = importlib.import_module(f"{rt.__name__}.core.config")
    protocol = importlib.import_module(f"{rt.__name__}.runtime.protocol")

    @rt.remote(max_retries=3)
    def ok():
        return "survived"

    config.GlobalConfig.apply({"testing_rpc_failure": "push_task=1"})
    protocol.reset_chaos()
    try:
        assert rt.get(ok.remote(), timeout=60) == "survived"
    finally:
        config.GlobalConfig.apply({"testing_rpc_failure": ""})
        protocol.reset_chaos()


def test_cluster_state_apis(rt):
    res = rt.cluster_resources()
    assert res.get("CPU") == 4.0
    nodes = rt.nodes()
    assert len(nodes) == 1 and nodes[0]["Alive"]
    avail = rt.available_resources()
    assert avail.get("CPU", 0) <= res["CPU"]
    dump = worker_of(rt).backend.state_dump()
    assert "actors" in dump and "nodes" in dump


def test_port_processes_are_its_own(rt):
    """The port's daemons and store carry its own names: its session
    variable, its /rtpt_ segment and its native library, never the JAX
    package's."""
    backend = worker_of(rt).backend
    name = backend.object_plane.store.name
    if rt.__name__ == "ray_tpu_torch":
        assert name.startswith("/rtpt_")
        from ray_tpu_torch._native import build
        assert build.LIB_PATH.endswith(
            "ray_tpu_torch/_build/libray_tpu_torch_native.so")
        import ray_tpu_torch.core._native as native
        assert native._lib._name == build.LIB_PATH
    else:
        assert name.startswith("/rtpu_")
