"""The port's multiprocessing pool, joblib backend and host-side
collectives against the JAX package's.

Each program of ``tests/test_util_pool.py`` and
``tests/test_collective.py`` runs through both packages' cluster runtimes
and must reach those files' gates in each (the actor pool and queue of
``tests/test_util_extras.py``, in local mode, are in
``tests/test_torch_util_local.py``). The port's own case: the
collectives take torch tensors and give back tensors of the caller's
dtype on the caller's device, reduced on the host as numpy is (bf16 by
way of float32).
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(name, sub):
    return importlib.import_module(f"{name}.{sub}")


# ------------------------------------ cluster: multiprocessing, joblib, ...


@pytest.fixture(scope="module", params=PACKAGES)
def crt(request):
    rt = importlib.import_module(request.param)
    rt.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024})
    yield rt, request.param
    rt.shutdown()


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def test_pool_map_starmap_apply_imap(crt):
    rt, name = crt
    Pool = _mod(name, "util.multiprocessing").Pool
    with Pool(processes=4) as p:
        assert p.map(_sq, range(20)) == [x * x for x in range(20)]
        assert p.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
        assert p.apply(_add, (2, 3)) == 5
        r = p.apply_async(_sq, (9,))
        assert r.get(timeout=30) == 81
        assert r.ready() and r.successful()
        assert list(p.imap(_sq, range(10), chunksize=3)) == \
            [x * x for x in range(10)]
        assert sorted(p.imap_unordered(_sq, range(10), chunksize=3)) == \
            sorted(x * x for x in range(10))


def test_pool_initializer_runs(crt):
    rt, name = crt
    Pool = _mod(name, "util.multiprocessing").Pool

    def init_marker(v):
        os.environ["_POOL_MARK"] = str(v)

    def read_marker(_):
        import os as _os
        return _os.environ.get("_POOL_MARK")

    with Pool(processes=2, initializer=init_marker, initargs=(7,)) as p:
        out = p.map(read_marker, range(4), chunksize=1)
    assert all(v == "7" for v in out), out


def test_pool_closed_rejects_and_join_waits(crt, tmp_path):
    rt, name = crt
    Pool = _mod(name, "util.multiprocessing").Pool
    p = Pool(processes=1)
    p.close()
    with pytest.raises(ValueError):
        p.map(_sq, [1])
    p.join()

    mark = str(tmp_path / f"mark-{name}")

    def slow_write(path):
        import time as _time
        _time.sleep(1.0)
        with open(path, "w") as f:
            f.write("done")
        return path

    p = Pool(processes=1)
    p.map_async(slow_write, [mark])
    p.close()
    p.join()
    assert os.path.exists(mark)


def test_imap_streams_infinite_input(crt):
    import itertools
    rt, name = crt
    Pool = _mod(name, "util.multiprocessing").Pool
    with Pool(processes=2) as p:
        gen = p.imap(_sq, itertools.count())
        assert [next(gen) for _ in range(5)] == [0, 1, 4, 9, 16]


def test_joblib_backend(crt):
    joblib = pytest.importorskip("joblib")
    rt, name = crt
    backend = _mod(name, "util.joblib_backend")
    if name == "ray_tpu":
        backend.register_ray_tpu()
    else:
        backend.register_ray_tpu_torch()
    from joblib import Parallel, delayed
    with joblib.parallel_backend(name, n_jobs=4):
        out = Parallel()(delayed(_sq)(i) for i in range(12))
    assert out == [i * i for i in range(12)]


def test_by_value_modules_name_torch_not_jax():
    """A function of torch (or of this package) ships by reference, as
    the JAX package's jax functions do; a user module's ships by value."""
    code = ("import sys, cloudpickle, torch, types\n"
            "from ray_tpu_torch.util.multiprocessing import _dumps_by_value\n"
            "mod = types.ModuleType('user_mod')\n"
            "exec('def f(x):\\n    return x + 1\\n', mod.__dict__)\n"
            "sys.modules['user_mod'] = mod\n"
            "blob = _dumps_by_value(mod.f)\n"
            "del sys.modules['user_mod']\n"
            "print(cloudpickle.loads(blob)(1))\n"
            "print(b'torch' in _dumps_by_value(torch.relu))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "True"]


def test_collectives_across_actor_processes(crt):
    rt, name = crt
    coll = f"{name}.util.collective"

    @rt.remote
    class Member:
        def __init__(self, rank, world):
            import importlib
            self.g = importlib.import_module(coll).init_collective_group(
                f"g1-{name}", world, rank)
            self.rank = rank

        def run_all(self):
            import numpy as np
            out = {}
            out["allreduce"] = self.g.allreduce(
                np.full(4, self.rank + 1.0))
            out["mean"] = self.g.allreduce(
                np.full(2, float(self.rank)), op="mean")
            out["gather"] = [float(a[0]) for a in self.g.allgather(
                np.asarray([10.0 * self.rank]))]
            out["scatter"] = self.g.reducescatter(
                np.arange(6, dtype=np.float64))
            out["bcast"] = self.g.broadcast(
                np.asarray([42.0 + self.rank]), src_rank=1)
            return out

    world = 3
    members = [Member.remote(r, world) for r in range(world)]
    outs = rt.get([m.run_all.remote() for m in members], timeout=120)
    splits = np.array_split(3 * np.arange(6, dtype=np.float64), world)
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["allreduce"], np.full(4, 6.0))
        np.testing.assert_allclose(out["mean"], np.ones(2))
        assert out["gather"] == [0.0, 10.0, 20.0]
        np.testing.assert_allclose(out["bcast"], [43.0])
        np.testing.assert_allclose(out["scatter"], splits[rank])
    _mod(name, "util.collective").destroy_collective_group(f"g1-{name}")


@pytest.mark.parametrize("crt", ["ray_tpu_torch"], indirect=True)
def test_collectives_take_tensors_and_keep_dtype_and_device(crt):
    rt, name = crt

    @rt.remote
    class Member:
        def __init__(self, rank, world):
            from ray_tpu_torch.util.collective import init_collective_group
            self.g = init_collective_group("gt", world, rank)
            self.rank = rank

        def run_all(self):
            import torch
            r = self.rank
            x = torch.arange(4, dtype=torch.float32) + r
            out = {
                "sum_f32": self.g.allreduce(x),
                "max_bf16": self.g.allreduce(
                    (x * 0.5).to(torch.bfloat16), op="max"),
                "mean_i64": self.g.allreduce(
                    torch.full((2,), 2 * r, dtype=torch.int64), op="mean"),
                "gather": self.g.allgather(torch.tensor([r], dtype=torch.int32)),
                "scatter": self.g.reducescatter(
                    torch.arange(6, dtype=torch.float64)),
                "bcast": self.g.broadcast(
                    torch.full((3,), 42.0 + r, dtype=torch.float16),
                    src_rank=1),
                "numpy": self.g.allreduce(np.full(2, 1.0)),
            }
            return {k: (v if isinstance(v, (list, np.ndarray)) else
                        (v, str(v.dtype), str(v.device)))
                    for k, v in out.items()}

    world = 2
    members = [Member.remote(r, world) for r in range(world)]
    outs = rt.get([m.run_all.remote() for m in members], timeout=120)
    import torch
    for rank, out in enumerate(outs):
        t, dtype, device = out["sum_f32"]
        assert (dtype, device) == ("torch.float32", "cpu")
        assert torch.equal(t, torch.tensor([1.0, 3.0, 5.0, 7.0]))
        t, dtype, _ = out["max_bf16"]
        assert dtype == "torch.bfloat16"
        assert torch.equal(t.float(), torch.tensor([0.5, 1.0, 1.5, 2.0]))
        t, dtype, _ = out["mean_i64"]
        assert dtype == "torch.int64" and torch.equal(t, torch.ones(
            2, dtype=torch.int64))
        assert [(int(g[0]), str(g[0].dtype)) for g in out["gather"]] == \
            [(0, "torch.int32"), (1, "torch.int32")]
        t, dtype, _ = out["scatter"]
        assert dtype == "torch.float64"
        assert torch.equal(t, torch.arange(6, dtype=torch.float64)
                           .mul(2).chunk(2)[rank])
        t, dtype, _ = out["bcast"]
        assert dtype == "torch.float16"
        assert torch.equal(t, torch.full((3,), 43.0, dtype=torch.float16))
        assert isinstance(out["numpy"], np.ndarray)
        np.testing.assert_allclose(out["numpy"], [2.0, 2.0])
    from ray_tpu_torch.util.collective import destroy_collective_group
    destroy_collective_group("gt")
