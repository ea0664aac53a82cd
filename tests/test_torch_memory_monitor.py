"""The port's memory monitor and OOM worker killing, held to
``tests/test_memory_monitor.py``'s assertions: a worker past the per-worker
RSS cap is killed and its task raises ``OutOfMemoryError``; with retries
the frugal second attempt completes; frugal work is untouched. These
results depend on timing, so only the port's program runs here; the JAX
package's runs in its own file. (chip_smoke.py's phase 22c runs the same
with card workers, its cap above their measured RSS.)
"""

import os

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import OutOfMemoryError


@pytest.fixture()
def oom_rt():
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024,
        # deterministic per-worker cap: a worker whose RSS exceeds 400 MB
        # is OOM-killed regardless of actual host pressure
        "worker_memory_limit_bytes": 400 * 1024 * 1024,
        "memory_monitor_refresh_ms": 100,
    })
    yield rt
    rt.shutdown()


def test_memory_hog_killed_with_oom_error(oom_rt):
    @rt.remote(max_retries=0)
    def hog():
        import time
        ballast = np.ones(120_000_000)  # ~960 MB, far over the cap
        time.sleep(30)
        return ballast.nbytes

    with pytest.raises(OutOfMemoryError):
        rt.get(hog.remote(), timeout=90)


def test_oom_retry_completes_elsewhere(oom_rt, tmp_path):
    marker = str(tmp_path / "attempted")

    @rt.remote(max_retries=2)
    def flaky_hog():
        import time
        if not os.path.exists(marker):
            open(marker, "w").close()
            ballast = np.ones(120_000_000)  # first attempt hogs -> killed
            time.sleep(30)
            return -1
        return 42  # retry is frugal and completes

    assert rt.get(flaky_hog.remote(), timeout=120) == 42


def test_frugal_workload_untouched(oom_rt):
    @rt.remote
    def modest(i):
        return i * 2

    assert rt.get([modest.remote(i) for i in range(8)], timeout=60) == \
        [i * 2 for i in range(8)]
