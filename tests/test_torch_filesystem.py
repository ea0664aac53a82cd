"""The port's StorageFilesystem seam against ray_tpu's: local and memory
backends, the retry policy, fault points and the resolver.

Each program of ``tests/test_filesystem.py`` runs through both packages'
``util/filesystem.py`` and must give the results the JAX test asserts, so
both give equal results; a ``StorageError`` path raises in both. Faults are
armed through each package's own ``util/fault_injector.py``: the port's
reads ``RTPT_FAULT_INJECT`` (a deliberate difference, pinned below), and
its fixture lives in this file.
"""

import importlib
import os
import threading

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def fsm(request):
    return importlib.import_module(f"{request.param}.util.filesystem")


@pytest.fixture
def injector(fsm):
    """The fault injector of ``fsm``'s package, its points and variable
    reset after the test."""
    fi = importlib.import_module(
        fsm.__name__.replace("filesystem", "fault_injector"))
    yield fi
    fi.reset()
    os.environ.pop(fi.ENV_VAR, None)


def test_fault_injector_reads_the_ports_own_variable():
    from ray_tpu.util import fault_injector as jfi
    from ray_tpu_torch.util import fault_injector as tfi
    assert tfi.ENV_VAR == "RTPT_FAULT_INJECT"
    assert jfi.ENV_VAR == "RTPU_FAULT_INJECT"
    assert tfi.ENV_VAR != jfi.ENV_VAR


def test_put_get_roundtrip_and_overwrite(fsm, tmp_path):
    fs = fsm.LocalFilesystem()
    p = str(tmp_path / "a" / "b.bin")
    fs.put(p, b"one")
    assert fs.get(p) == b"one"
    fs.put(p, b"two")
    assert fs.get(p) == b"two"


def test_put_is_atomic_no_staging_left(fsm, tmp_path):
    fs = fsm.LocalFilesystem()
    fs.put(str(tmp_path / "x"), b"data")
    assert sorted(os.listdir(tmp_path)) == ["x"]


def test_get_missing_raises_filenotfound(fsm, tmp_path):
    with pytest.raises(FileNotFoundError):
        fsm.LocalFilesystem().get(str(tmp_path / "nope"))


def test_list_delete_rename(fsm, tmp_path):
    fs = fsm.LocalFilesystem()
    fs.put(str(tmp_path / "d" / "one"), b"1")
    fs.put(str(tmp_path / "d" / "two"), b"2")
    assert fs.list(str(tmp_path / "d")) == ["one", "two"]
    assert fs.list(str(tmp_path / "missing")) == []
    fs.rename(str(tmp_path / "d" / "one"), str(tmp_path / "d" / "uno"))
    assert fs.list(str(tmp_path / "d")) == ["two", "uno"]
    fs.delete(str(tmp_path / "d"))
    assert fs.list(str(tmp_path / "d")) == []
    fs.delete(str(tmp_path / "d"))


def test_memory_roundtrip_list_exists(fsm):
    fs = fsm.MemoryFilesystem()
    fs.put("/run/ck/one", b"1")
    fs.put("/run/ck/sub/two", b"2")
    assert fs.get("run/ck/one") == b"1"
    assert fs.list("/run/ck") == ["one", "sub"]
    assert fs.exists("/run/ck/sub")
    with pytest.raises(FileNotFoundError):
        fs.get("/run/ck/three")


def test_memory_delete_tree_and_rename(fsm):
    fs = fsm.MemoryFilesystem()
    fs.put("a/x", b"1")
    fs.put("a/y/z", b"2")
    fs.rename("a", "b")
    assert fs.get("b/x") == b"1" and fs.get("b/y/z") == b"2"
    fs.delete("b")
    assert fs.list("b") == []
    with pytest.raises(FileNotFoundError):
        fs.rename("gone", "anywhere")


def test_memory_put_copies_bytes(fsm):
    fs = fsm.MemoryFilesystem()
    buf = bytearray(b"abc")
    fs.put("k", buf)
    buf[0] = ord("z")
    assert fs.get("k") == b"abc"


def test_backoff_is_bounded_full_jitter(fsm):
    rp = fsm.RetryPolicy(max_attempts=5, base_s=0.1, cap_s=0.3)
    for attempt in range(1, 10):
        for _ in range(20):
            s = rp.backoff_s(attempt)
            assert 0.0 <= s <= min(0.3, 0.1 * 2 ** attempt)


def test_transient_faults_are_retried(fsm, injector):
    fs = fsm.FaultInjectableFilesystem(
        fsm.MemoryFilesystem(), retry=fsm.RetryPolicy(
            max_attempts=4, base_s=0.001, cap_s=0.002))
    injector.configure("storage.put=raise*2")
    fs.put("k", b"v")
    assert fs.get("k") == b"v"


def test_exhausted_retries_raise_storage_error(fsm, injector):
    fs = fsm.FaultInjectableFilesystem(
        fsm.MemoryFilesystem(), retry=fsm.RetryPolicy(
            max_attempts=3, base_s=0.001, cap_s=0.002))
    injector.configure("storage.put=raise")
    with pytest.raises(fsm.StorageError):
        fs.put("k", b"v")


def test_absence_is_not_retried(fsm, injector):
    fs = fsm.FaultInjectableFilesystem(fsm.MemoryFilesystem())
    with pytest.raises(FileNotFoundError):
        fs.get("never-put")


def test_get_point_covers_reads(fsm, injector):
    fs = fsm.FaultInjectableFilesystem(
        fsm.MemoryFilesystem(), retry=fsm.RetryPolicy(
            max_attempts=2, base_s=0.001, cap_s=0.002))
    fs.put("k", b"v")
    injector.configure("storage.get=raise")
    with pytest.raises(fsm.StorageError):
        fs.get("k")


def test_env_armed_fault_reaches_the_filesystem(fsm, injector):
    """The spec in the package's own variable arms the point: the port's
    injector reads RTPT_FAULT_INJECT, the JAX package's RTPU_."""
    os.environ[injector.ENV_VAR] = "storage.get=raise"
    injector.reset()
    fs = fsm.FaultInjectableFilesystem(
        fsm.MemoryFilesystem(), retry=fsm.RetryPolicy(
            max_attempts=2, base_s=0.001, cap_s=0.002))
    fs.inner.put("k", b"v")
    with pytest.raises(fsm.StorageError):
        fs.get("k")


def test_default_is_fault_injectable_local(fsm):
    fs = fsm.storage_filesystem(None)
    assert isinstance(fs, fsm.FaultInjectableFilesystem)
    assert isinstance(fs.inner, fsm.LocalFilesystem)


def test_memory_spec_is_process_shared(fsm):
    a = fsm.storage_filesystem("memory://shared-x")
    b = fsm.storage_filesystem("memory://shared-x")
    a.put("k", b"v")
    assert b.get("k") == b"v"
    other = fsm.storage_filesystem("memory://other")
    with pytest.raises(FileNotFoundError):
        other.get("k")


def test_instance_passthrough(fsm):
    mem = fsm.MemoryFilesystem()
    assert fsm.storage_filesystem(mem) is mem


def test_concurrent_memory_puts(fsm):
    fs = fsm.storage_filesystem(f"memory://concurrent-{fsm.__name__}")
    errs = []

    def work(i):
        try:
            for j in range(50):
                fs.put(f"d/{i}-{j}", bytes([i]))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
        assert not t.is_alive()
    assert not errs
    assert len(fs.list("d")) == 400


def test_both_packages_store_the_same_tree(tmp_path):
    """One program of puts, a rename and a delete through each package's
    local filesystem leaves equal trees: names and bytes."""
    trees = {}
    for pkg in PACKAGES:
        fsm = importlib.import_module(f"{pkg}.util.filesystem")
        root = tmp_path / pkg
        fs = fsm.storage_filesystem(None)
        for i in range(4):
            fs.put(str(root / "ck" / f"step-{i}" / "state.bin"),
                   bytes([i]) * (i + 1))
        fs.rename(str(root / "ck" / "step-0"), str(root / "ck" / "first"))
        fs.delete(str(root / "ck" / "step-3"))
        trees[pkg] = {
            (d, f): fs.get(str(root / "ck" / d / f))
            for d in fs.list(str(root / "ck"))
            for f in fs.list(str(root / "ck" / d))}
    assert trees["ray_tpu"] == trees["ray_tpu_torch"]
    assert sorted(trees["ray_tpu_torch"]) == [
        ("first", "state.bin"), ("step-1", "state.bin"),
        ("step-2", "state.bin")]
