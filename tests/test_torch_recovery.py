"""The port's object spilling and lineage reconstruction, held to
``tests/test_recovery.py``'s assertions: puts past a tiny arena spill to
disk and read back, a spilled object works as a task argument, a task's
output deleted from the arena (or its spill file deleted) is rebuilt by
running the task again, and a put object, which has no lineage, raises
``ObjectLostError``. Only the port's program runs here (the arena's
pressure and the rebuilds depend on timing); the JAX package's runs in its
own file.
"""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.worker import global_worker


@pytest.fixture
def small_store_rt():
    # arena deliberately tiny so puts overflow to disk
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 8 * 1024 * 1024,
        "memory_store_threshold_bytes": 64 * 1024,
    })
    yield rt
    rt.shutdown()


@pytest.fixture
def normal_rt():
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024,
    })
    yield rt
    rt.shutdown()


def test_put_overflow_spills_to_disk_and_reads_back(small_store_rt):
    # each array ~2 MB; an 8 MB arena cannot hold 8 of them + pins
    arrays = [np.full(256_000, i, np.float64) for i in range(8)]
    refs = [rt.put(a) for a in arrays]
    for i, ref in enumerate(refs):
        back = rt.get(ref, timeout=60)
        np.testing.assert_array_equal(back, arrays[i])


def test_spilled_object_usable_as_task_arg(small_store_rt):
    refs = [rt.put(np.full(256_000, i, np.float64)) for i in range(8)]

    @rt.remote
    def first(x):
        return float(x[0])

    vals = rt.get([first.remote(r) for r in refs], timeout=120)
    assert vals == [float(i) for i in range(8)]


def test_lineage_reconstruction_after_eviction(normal_rt):
    @rt.remote
    def make(i):
        return np.full(200_000, i, np.float64)  # shm-sized

    ref = make.remote(7)
    np.testing.assert_array_equal(rt.get(ref, timeout=60)[:3], 7.0)
    # simulate loss: delete the primary copy from the arena out-of-band
    store = global_worker.backend.object_plane.store
    key = ref.id().binary()
    assert store.contains(key)
    store.release(key)   # drop primary pin
    store.delete(key)
    assert not store.contains(key)
    # get() must re-execute make(7) via lineage, not raise ObjectLost
    back = rt.get(ref, timeout=120)
    np.testing.assert_array_equal(back[:3], 7.0)


def test_lineage_rebuilds_after_spill_file_lost(small_store_rt):
    """Delete a spilled primary's backing file out from under the store:
    rt.get must fall through arena-miss -> spill-miss -> ObjectLost and
    recover via try_reconstruct (re-running the creating task) instead of
    raising."""
    import os

    from ray_tpu_torch.core.config import GlobalConfig
    from ray_tpu_torch.runtime.object_plane import spill_file_path

    @rt.remote
    def make(i):
        return np.full(256_000, i, np.float64)  # ~2 MB, shm-sized

    # 8 x 2 MB into an 8 MB arena: overflow forces spills
    refs = [make.remote(i) for i in range(8)]
    vals = rt.get(refs, timeout=120)
    store = global_worker.backend.object_plane.store
    victim = None
    for i, ref in enumerate(refs):
        p = spill_file_path(GlobalConfig.session_dir, store.name,
                            ref.id().hex())
        if os.path.exists(p):
            victim = (i, ref, p)
            break
    assert victim is not None, "nothing spilled under memory pressure"
    i, ref, spill_path = victim
    os.unlink(spill_path)  # the disk copy is gone for good
    key = ref.id().binary()
    if store.contains(key):  # drop any arena copy too: total loss
        store.release(key)
        store.delete(key)
    del vals
    back = rt.get(ref, timeout=120)
    np.testing.assert_array_equal(back[:3], float(i))


def test_lineage_not_available_for_put_objects(normal_rt):
    arr = np.arange(200_000, dtype=np.float64)
    ref = rt.put(arr)
    store = global_worker.backend.object_plane.store
    key = ref.id().binary()
    rt.get(ref, timeout=30)
    store.release(key)
    store.delete(key)
    with pytest.raises(rt.exceptions.ObjectLostError):
        rt.get(ref, timeout=30)
