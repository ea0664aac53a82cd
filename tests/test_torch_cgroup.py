"""The port's cgroup-v2 worker isolation against ray_tpu's, on a fake
unified hierarchy in a tmpdir (real kernels need delegation), plus the
no-op degradation without one.

Each program of ``tests/test_cgroup.py`` runs through both packages'
``runtime/cgroup.py`` and must give the results the JAX test asserts; the
leaf layouts and weights both leave are compared file by file. One
deliberate difference, pinned here: the port's session slice is
``rtpt-<session>`` where the JAX package's is ``rtpu-<session>``, so the
two never share a slice on one machine.
"""

import importlib
import os
import threading

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
PREFIX = {"ray_tpu": "rtpu-", "ray_tpu_torch": "rtpt-"}


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


def manager(pkg):
    return importlib.import_module(f"{pkg}.runtime.cgroup").CgroupManager


def make_fake_root(tmp_path):
    root = tmp_path / "cg"
    root.mkdir(parents=True)
    (root / "cgroup.controllers").write_text("cpuset cpu io memory pids\n")
    return str(root)


def tree(root):
    """{relative path: contents} of every file under ``root``, the
    package's slice prefix taken out of the paths."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            for prefix in PREFIX.values():
                rel = rel.replace(prefix, "<slice>-")
            with open(path) as f:
                out[rel] = f.read()
    return out


def test_slice_names_are_the_ports_own(tmp_path):
    slices = {}
    for p in PACKAGES:
        root = make_fake_root(tmp_path / p)
        mgr = manager(p)("s", root=root)
        slices[p] = sorted(d for d in os.listdir(root)
                           if os.path.isdir(os.path.join(root, d)))
        mgr.shutdown()
    assert slices == {"ray_tpu": ["rtpu-s"], "ray_tpu_torch": ["rtpt-s"]}


def test_slice_and_worker_leaf_lifecycle(pkg, tmp_path):
    root = make_fake_root(tmp_path)
    mgr = manager(pkg)("sess1", root=root)
    slice_dir = os.path.join(root, PREFIX[pkg] + "sess1")
    assert mgr.enabled
    assert os.path.isdir(slice_dir)
    sub = os.path.join(slice_dir, "cgroup.subtree_control")
    assert "+memory" in open(sub).read()

    leaf = mgr.create_worker_group("abcd" * 8,
                                   memory_bytes=256 * 1024 * 1024,
                                   num_cpus=2.0)
    assert leaf is not None and os.path.isdir(leaf)
    assert open(os.path.join(leaf, "memory.max")).read() == \
        str(256 * 1024 * 1024)
    assert open(os.path.join(leaf, "memory.oom.group")).read() == "1"
    assert open(os.path.join(leaf, "cpu.weight")).read() == "200"

    assert mgr.attach(leaf, 12345)
    assert open(os.path.join(leaf, "cgroup.procs")).read() == "12345"

    with open(os.path.join(leaf, "memory.events"), "w") as f:
        f.write("low 0\nhigh 3\nmax 7\noom 1\noom_kill 1\n")
    ev = mgr.memory_events(leaf)
    assert ev["oom_kill"] == 1 and ev["max"] == 7

    for f in os.listdir(leaf):
        os.unlink(os.path.join(leaf, f))
    mgr.remove_worker_group(leaf)
    assert not os.path.isdir(leaf)
    os.unlink(sub)
    mgr.shutdown()
    assert not os.path.isdir(slice_dir)


def test_degrades_to_noop_without_v2_root(pkg, tmp_path):
    mgr = manager(pkg)("sess2", root=str(tmp_path / "not-cgroup"))
    assert not mgr.enabled
    assert mgr.create_worker_group("ffff" * 8, memory_bytes=1) is None
    assert not mgr.attach(None, 1)
    assert mgr.memory_events(None) == {}
    mgr.shutdown()


def test_cpu_weight_bounds(pkg, tmp_path):
    root = make_fake_root(tmp_path)
    mgr = manager(pkg)("sess3", root=root)
    tiny = mgr.create_worker_group("aa" * 16, num_cpus=0.001)
    assert open(os.path.join(tiny, "cpu.weight")).read() == "1"
    huge = mgr.create_worker_group("bb" * 16, num_cpus=500.0)
    assert open(os.path.join(huge, "cpu.weight")).read() == "10000"
    mgr.shutdown()


def test_leaf_layouts_and_weights_equal_across_packages(tmp_path):
    """One program (leaves of several memory caps and CPU requests, pids
    attached) through each package leaves equal trees, file for file."""
    trees = {}
    for p in PACKAGES:
        root = make_fake_root(tmp_path / p)
        mgr = manager(p)("same", root=root)
        for i, (mem, cpus) in enumerate(((0, 1.0), (64 << 20, 0.5),
                                         (1 << 30, 16.0), (0, 0.0))):
            leaf = mgr.create_worker_group(f"{i:02x}" * 16,
                                           memory_bytes=mem, num_cpus=cpus)
            mgr.attach(leaf, 1000 + i)
        trees[p] = tree(root)
    assert trees["ray_tpu"] == trees["ray_tpu_torch"]
    assert trees["ray_tpu_torch"][
        os.path.join("<slice>-same", "w-" + "01" * 8, "cpu.weight")] == "50"


def test_node_spawn_passes_cpu_request_to_cgroup(pkg, tmp_path,
                                                 monkeypatch):
    node_mod = importlib.import_module(f"{pkg}.runtime.node")
    root = make_fake_root(tmp_path)
    mgr = manager(pkg)("sess4", root=root)

    class FakeProc:
        pid = 4242
        returncode = None

        def wait(self):
            threading.Event().wait()  # parked: daemon thread, test-scoped

        def poll(self):
            return None

    monkeypatch.setattr(node_mod.subprocess, "Popen",
                        lambda *a, **k: FakeProc())
    nd = object.__new__(node_mod.NodeDaemon)
    nd.session = "sess4"
    nd.address = "127.0.0.1:0"
    nd.head_addr = "127.0.0.1:0"
    nd.shm_name = "shm"
    nd.cgroups = mgr
    nd.chips = None
    nd.devices = None
    nd._lock = threading.Lock()
    nd._workers = {}
    entry = nd._spawn_worker(num_cpus=1.5)
    assert entry.cgroup_leaf is not None
    assert os.path.basename(os.path.dirname(entry.cgroup_leaf)) == \
        PREFIX[pkg] + "sess4"
    assert open(os.path.join(entry.cgroup_leaf,
                             "cpu.weight")).read() == "150"
    assert open(os.path.join(entry.cgroup_leaf,
                             "cgroup.procs")).read() == "4242"
