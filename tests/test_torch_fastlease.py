"""The port's native lease pool (``transport.cc`` ``FastLease``): grant and
release served inside the head's C event loop, Python keeping placement
and reclaim policy. Held to ``tests/test_fastlease.py``'s assertions:
steady-state acquires hit in C, pooled capacity drains for another shape
and when idle, and only the holding connection may re-pool a grant. Those
results depend on timing, so only the port's program runs them; the JAX
package's runs in its own file. The lease signature, a value, is compared
across the packages.
"""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.runtime import wire


@pytest.fixture
def cluster():
    rt.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "lease_idle_linger_s": 0.2,
    })
    yield rt
    rt.shutdown()


def _head_lease_stats():
    """Ask the head process for its native-pool stats via state_dump."""
    from ray_tpu_torch.core.worker import global_worker
    be = global_worker.backend
    dump = be.head.call("state_dump", timeout=10)
    return dump.get("fast_lease") if isinstance(dump, dict) else None


@rt.remote
def tiny(i):
    return i + 1


def _stock_pool(n, timeout=30.0):
    """Bursts of ``n`` tasks until the head's native pool holds a grant.
    A burst arms the pool (its Python-path requests carry their pending
    count), and the restock loop stocks it as the burst's leases linger
    back; a request that finds the cluster busy drains every pool and
    disarms it, so on a loaded machine one burst may leave it empty: the
    burst is repeated, within ``timeout``. -> the pool's stats."""
    deadline = time.monotonic() + timeout
    stats = None
    while time.monotonic() < deadline:
        assert rt.get([tiny.remote(i) for i in range(n)], timeout=60) == \
            [i + 1 for i in range(n)]
        settle = time.monotonic() + 2.0  # inside the 3 s idle drain
        while time.monotonic() < settle:
            stats = _head_lease_stats()
            if stats and stats.get("pooled", 0) > 0:
                return stats
            time.sleep(0.05)
    raise AssertionError(f"native pool never stocked: {stats}")


def test_burst_hits_native_pool(cluster):
    # bursts arm and stock the pool (Python path), the next acquires in C
    _stock_pool(100)
    assert rt.get([tiny.remote(i) for i in range(100)]) == \
        [i + 1 for i in range(100)]
    deadline = time.monotonic() + 10
    stats = None
    while time.monotonic() < deadline:
        stats = _head_lease_stats()
        if stats and stats.get("hits", 0) > 0:
            break
        time.sleep(0.2)
    assert stats is not None, "head did not report fast-lease stats"
    assert stats["hits"] > 0, f"no native acquire ever hit: {stats}"


def test_pool_drains_when_other_shape_needs_capacity(cluster):
    """Pooled 1-CPU grants hold real capacity; a 4-CPU request must drain
    them (drain-on-busy) instead of starving."""
    rt.get([tiny.remote(i) for i in range(50)])
    time.sleep(0.6)  # release to pool

    @rt.remote(num_cpus=4)
    def big():
        return "ran"

    # all 4 CPUs exist only if the pool lets go
    assert rt.get(big.remote(), timeout=30) == "ran"


def test_pool_idle_drain_returns_capacity(cluster):
    rt.get([tiny.remote(i) for i in range(50)])
    # pool idle-drain (fast_lease_idle_drain_s=3) must hand capacity back
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        avail = rt.available_resources()
        if avail.get("CPU", 0) >= 4.0:
            break
        time.sleep(0.5)
    assert rt.available_resources().get("CPU", 0) >= 4.0, \
        "pooled grants never drained back to the cluster"


def test_release_requires_holding_connection(cluster):
    """FOP_LEASE_REL ownership check: only the connection that acquired a
    grant may re-pool it. A foreign conn's release must return status 0
    (sending it down the Python release_lease fallback, which validates
    under the head lock) — otherwise a stale release racing a reconnect
    could hand the same grant to two workers."""
    import pickle

    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.runtime import protocol_native as _pn
    from ray_tpu_torch.runtime.protocol import RpcClient

    be = global_worker.backend
    assert be._head_fast, "the port's head always serves the fast path"
    # arm the pool: bursts stock 1-CPU grants, linger re-pools them
    _stock_pool(50)
    sig = wire.lease_sig({"CPU": 1.0})
    deadline = time.monotonic() + 15
    status, blob = 0, b""
    while time.monotonic() < deadline:
        status, blob = be.head.call_fast(
            _pn.FAST_LEASE_ACQ, key=_pn._U64.pack(sig), timeout=5)
        if status == 1:
            break
        time.sleep(0.3)
    assert status == 1, "native pool never stocked a 1-CPU grant"
    fast_key = pickle.loads(blob)["fast_key"]

    other = RpcClient(be.head_addr, name="chaos-release")
    try:
        st_foreign, _ = other.call_fast(
            _pn.FAST_LEASE_REL, key=_pn._U64.pack(fast_key), timeout=5)
        assert st_foreign == 0, \
            "a foreign connection re-pooled another conn's held lease"
    finally:
        other.close()
    # the true holder's release still re-pools
    st_holder, _ = be.head.call_fast(
        _pn.FAST_LEASE_REL, key=_pn._U64.pack(fast_key), timeout=5)
    assert st_holder == 1, "holder's own release was refused"


def test_lease_sig_stability():
    # head and client must agree on the shape signature across dict order
    a = wire.lease_sig({"CPU": 1.0, "custom": 2.0})
    b = wire.lease_sig({"custom": 2.0, "CPU": 1.0})
    assert a == b
    assert wire.lease_sig({"CPU": 2.0}) != wire.lease_sig({"CPU": 1.0})


def test_lease_sig_equal_across_packages():
    """Both packages sign a shape alike (the key the native pool files a
    grant under), GPU shapes included."""
    from ray_tpu.runtime import wire as jwire
    shapes = [{"CPU": 1.0}, {"CPU": 2.0}, {"CPU": 1.0, "custom": 2.0},
              {"GPU": 1.0}, {"CPU": 1.0, "GPU": 2.0}, {}]
    assert [wire.lease_sig(s) for s in shapes] == \
        [jwire.lease_sig(s) for s in shapes]
