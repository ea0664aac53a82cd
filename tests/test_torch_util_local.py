"""The port's actor pool and distributed queue against the JAX package's:
each program of ``tests/test_util_extras.py`` runs through both packages'
local mode and must reach that file's gates in each."""

import importlib

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def _mod(name, sub):
    return importlib.import_module(f"{name}.{sub}")


@pytest.fixture(scope="module", params=PACKAGES)
def local_rt(request):
    rt = importlib.import_module(request.param)
    rt.init(local_mode=True, num_cpus=4)
    yield rt, request.param
    rt.shutdown()


def test_actor_pool_ordered_and_unordered(local_rt):
    rt, name = local_rt
    ActorPool = _mod(name, "util.actor_pool").ActorPool

    @rt.remote
    class Sq:
        def compute(self, x):
            return x * x

    pool = ActorPool([Sq.remote() for _ in range(2)])
    assert pool.map(lambda a, v: a.compute.remote(v), [1, 2, 3, 4, 5]) == \
        [1, 4, 9, 16, 25]
    assert sorted(pool.map_unordered(
        lambda a, v: a.compute.remote(v), [2, 3, 4])) == [4, 9, 16]


def test_queue_fifo_and_limits(local_rt):
    rt, name = local_rt
    qmod = _mod(name, "util.queue")
    q = qmod.Queue(maxsize=2)
    q.put("a")
    q.put("b")
    with pytest.raises(qmod.Full):
        q.put("c", block=False)
    assert q.get() == "a"
    assert q.get() == "b"
    with pytest.raises(qmod.Empty):
        q.get_nowait()
    assert q.empty()


def test_queue_across_tasks(local_rt):
    rt, name = local_rt
    q = _mod(name, "util.queue").Queue()

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return True

    assert rt.get(producer.remote(q, 5), timeout=60)
    assert [q.get(timeout=10) for _ in range(5)] == [0, 1, 2, 3, 4]


