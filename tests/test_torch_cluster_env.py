"""The port's cluster runtime against ray_tpu's: runtime environments,
dataset blocks through the shm store, and Tune trials as processes.

The programs of ``tests/test_runtime_env.py``'s cluster section,
``tests/test_data_cluster.py`` (blocks through shm) and
``tests/test_tune_cluster.py``, each run once through each package's
cluster, to the result the JAX package's test asserts.
"""

import importlib
import os

import numpy as np
import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(scope="module", params=PACKAGES)
def rt(request):
    mod = importlib.import_module(request.param)
    mod.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 256 * 1024 * 1024,
        "worker_pool_max": 8,
        "worker_pool_prestart": 2,
    })
    yield mod
    mod.shutdown()


def test_task_sees_env_vars(rt):
    @rt.remote(runtime_env={"env_vars": {"CLUSTER_TEST_FLAG": "42"}})
    def read():
        return os.environ.get("CLUSTER_TEST_FLAG")

    @rt.remote
    def read_plain():
        return os.environ.get("CLUSTER_TEST_FLAG")

    assert rt.get(read.remote(), timeout=60) == "42"
    # a default-environment worker must not inherit the env
    assert rt.get(read_plain.remote(), timeout=60) is None


def test_distinct_envs_get_distinct_workers(rt):
    @rt.remote(runtime_env={"env_vars": {"WHO": "alpha"}})
    def who_a():
        return os.environ["WHO"], os.getpid()

    @rt.remote(runtime_env={"env_vars": {"WHO": "beta"}})
    def who_b():
        return os.environ["WHO"], os.getpid()

    (va, pa), (vb, pb) = rt.get([who_a.remote(), who_b.remote()], timeout=60)
    assert va == "alpha" and vb == "beta"
    assert pa != pb


def test_working_dir_ships_files_and_modules(rt, tmp_path):
    wd = tmp_path / "proj"
    wd.mkdir()
    (wd / "data.txt").write_text("payload-123")
    mod_name = f"helper_mod_{rt.__name__}"
    (wd / f"{mod_name}.py").write_text("def magic():\n    return 777\n")

    @rt.remote(runtime_env={"working_dir": str(wd)})
    def use(name):
        helper = importlib.import_module(name)
        with open("data.txt") as f:
            data = f.read()
        return data, helper.magic(), os.getcwd()

    data, magic, cwd = rt.get(use.remote(mod_name), timeout=90)
    assert data == "payload-123"
    assert magic == 777
    assert str(wd) not in cwd   # ran from the node cache, not the source


def test_actor_runtime_env(rt):
    @rt.remote(runtime_env={"env_vars": {"ACTOR_ENV": "yes"}})
    class E:
        def read(self):
            return os.environ.get("ACTOR_ENV")

    e = E.remote()
    assert rt.get(e.read.remote(), timeout=60) == "yes"


def test_blocks_flow_through_shm(rt):
    rd = importlib.import_module(f"{rt.__name__}.data")
    worker = importlib.import_module(f"{rt.__name__}.core.worker") \
        .global_worker
    n = 200_000   # float64 blocks well over the inline threshold: shm
    ds = rd.from_numpy(np.arange(n, dtype=np.float64), num_blocks=4) \
        .map_batches(lambda a: a * 2.0, batch_format="numpy")
    mat = ds.materialize()
    store = worker.backend.object_plane.store
    assert any(store.contains(ref.id().binary()) for ref in mat._refs), \
        "no materialized block found in the shm store"
    out = np.concatenate(
        list(mat.iter_batches(batch_size=50_000, batch_format="numpy")))
    np.testing.assert_allclose(np.sort(out), np.arange(n) * 2.0)


def test_trials_run_as_processes(rt):
    tune = importlib.import_module(f"{rt.__name__}.tune")

    def trainable(cfg):
        for i in range(3):
            tune.report({"score": cfg["x"] + i, "pid": os.getpid()})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([10, 20, 30])},
        tune_config=tune.TuneConfig(metric="score", mode="max"))
    grid = tuner.fit()
    assert all(t.status == tune.TrialStatus.TERMINATED for t in grid.trials)
    pids = {t.last_result["pid"] for t in grid.trials}
    assert os.getpid() not in pids, "trials must run out-of-process"
    assert grid.get_best_result().config["x"] == 30
