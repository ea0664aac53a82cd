"""GPU detection and GPU leases in the port's cluster runtime.

``GPUAcceleratorManager`` mirrors the JAX package's TPU manager tests
(``tests/test_placement_group.py``: detection, visibility env, allocation
and release, an invalid request). On the CPU the node is told it has two
cards (``init(num_gpus=2)``): each ``num_gpus=1`` actor gets a dedicated
worker that sees only its own card through ``CUDA_VISIBLE_DEVICES``, and
a third waits until one of them is killed. No CUDA runs here: the
workers only read their environment.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.accelerators.gpu import (DeviceAllocator,
                                            GPUAcceleratorManager)

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------- unit: GPU manager


def test_gpu_count_from_visible_devices(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    assert GPUAcceleratorManager.detect() == 4
    assert GPUAcceleratorManager.node_resources() == {"GPU": 4.0}
    # CUDA stops at the first invalid entry; "" hides every card
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,-1,3")
    assert GPUAcceleratorManager.detect() == 1
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert GPUAcceleratorManager.detect() == 0
    assert GPUAcceleratorManager.node_resources() == {}


def test_gpu_count_without_visible_devices(monkeypatch):
    """Without the variable the count comes from nvidia-smi or the
    driver's procfs entries; a box with neither counts 0 cards."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    if not os.path.isdir("/proc/driver/nvidia/gpus") and \
            shutil.which("nvidia-smi") is None:
        assert GPUAcceleratorManager.detect() == 0
    assert GPUAcceleratorManager.node_resources(0) == {}
    assert GPUAcceleratorManager.node_resources(2) == {"GPU": 2.0}


def test_detection_imports_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager\n"
         "GPUAcceleratorManager.detect()\n"
         "print('torch' in sys.modules)\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_device_request_validation():
    GPUAcceleratorManager.validate_device_request(1, 2)
    GPUAcceleratorManager.validate_device_request(2, 2)
    for bad in (0, 3, 0.5, 1.5):
        with pytest.raises(ValueError):
            GPUAcceleratorManager.validate_device_request(bad, 2)


def test_visibility_env(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert GPUAcceleratorManager.visibility_env([0, 1]) == \
        {"CUDA_VISIBLE_DEVICES": "0,1"}
    # a node started under CUDA_VISIBLE_DEVICES hands out its own names
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6")
    assert GPUAcceleratorManager.visibility_env([1]) == \
        {"CUDA_VISIBLE_DEVICES": "6"}


def test_device_allocator():
    alloc = DeviceAllocator(4)
    a = alloc.allocate(b"w1", 2)
    b = alloc.allocate(b"w2", 2)
    assert sorted(a + b) == [0, 1, 2, 3]
    assert alloc.allocate(b"w3", 1) is None
    alloc.release(b"w1")
    assert alloc.allocate(b"w3", 2) == a
    alloc.release_devices([7])
    assert 7 in alloc.free


def test_shutdown_stops_the_planes_its_connect_started():
    """A cluster's driver installs the process's log plane (and the other
    process-global planes) only where none runs, and its ``shutdown()``
    stops what it started: a server built afterwards in this process logs
    under its own role, not the gone driver's. (Before the module's
    cluster below: one driver connection at a time.)"""
    from ray_tpu_torch.util import compile_tracker, log_plane
    log_plane.stop_global()
    compile_tracker.stop_global()
    rt.init(num_cpus=1, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024})
    try:
        assert log_plane.get_global().role == "driver"
    finally:
        rt.shutdown()
    assert log_plane.get_global() is None
    assert compile_tracker.get_global() is None
    logger = log_plane.ensure_started(role="llm")
    try:
        rt.init(num_cpus=1, _system_config={
            "object_store_memory_bytes": 64 * 1024 * 1024})
        try:
            assert log_plane.get_global() is logger
        finally:
            rt.shutdown()
        assert log_plane.get_global() is logger
    finally:
        log_plane.stop_global()


# ---------------------------------------------------------- GPU leases


@pytest.fixture(scope="module")
def gpu_cluster():
    rt.init(num_cpus=4, num_gpus=2, _system_config={
        "object_store_memory_bytes": 256 * 1024 * 1024,
        "worker_pool_max": 8,
    })
    yield rt
    rt.shutdown()


@rt.remote(num_gpus=1)
class Leased:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


def test_cluster_advertises_gpus(gpu_cluster):
    assert gpu_cluster.cluster_resources()["GPU"] == 2.0


def test_gpu_leases_get_distinct_cards_and_wait(gpu_cluster):
    a, b = Leased.remote(), Leased.remote()
    (va, pa), (vb, pb) = rt.get([a.visible.remote(), b.visible.remote()],
                                timeout=90)
    assert sorted([va, vb]) == ["0", "1"]
    assert pa != pb and os.getpid() not in (pa, pb)
    # both cards are held: a third lease stays pending
    c = Leased.remote()
    ready_ref = c.visible.remote()
    ready, _ = rt.wait([ready_ref], timeout=2)
    assert ready == []
    # killing one frees its card (the worker process ends) and the third
    # places on it
    rt.kill(a)
    vc, pc = rt.get(ready_ref, timeout=90)
    assert vc == va and pc not in (pa, pb)
    assert _gone(pa)
    rt.kill(b)
    rt.kill(c)


def test_gpu_task_gets_a_dedicated_worker(gpu_cluster):
    @rt.remote(num_gpus=2)
    def both():
        return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

    @rt.remote
    def plain():
        return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

    visible, pid = rt.get(both.remote(), timeout=90)
    assert visible == "0,1"
    plain_visible, plain_pid = rt.get(plain.remote(), timeout=90)
    assert plain_pid != pid
    assert plain_visible == os.environ.get("CUDA_VISIBLE_DEVICES")


def test_gpu_lease_beyond_the_node_fails(gpu_cluster):
    """A count no node can hold never runs on the CPU: the actor dies
    with the reason, as the JAX package's invalid TPU shapes do."""
    @rt.remote(num_gpus=0.5)
    class Half:
        def m(self):
            return 1

    with pytest.raises(rt.exceptions.ActorDiedError, match="GPU"):
        rt.get(Half.remote().m.remote(), timeout=90)


def _gone(pid, timeout=30.0):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.05)
    return False

