"""The port's cluster runtime against ray_tpu's: actors and the fault
paths (process kills, crashes, retries and restarts).

The programs of ``tests/test_cluster.py``'s actor and fault-tolerance
sections, each run once through each package's cluster, to the result
the JAX package's test asserts; an error must be of the same class in
both packages.
"""

import importlib
import os
import signal
import time
import uuid

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


def test_actor_ordered_state(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def inc(self, d=1):
            self.v += d
            return self.v

    c = Counter.remote(10)
    out = rt.get([c.inc.remote() for _ in range(5)], timeout=60)
    assert out == [11, 12, 13, 14, 15]


def test_named_actor(rt):
    @rt.remote
    class KV:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v
            return True

        def get(self, k):
            return self.d.get(k)

    name = f"kv-{uuid.uuid4().hex[:6]}"
    a = KV.options(name=name).remote()
    rt.get(a.set.remote("x", 42), timeout=60)
    h = rt.get_actor(name)
    assert rt.get(h.get.remote("x"), timeout=30) == 42
    with pytest.raises(ValueError):
        rt.get_actor("no-such-actor")


def test_actor_handle_in_task(rt):
    @rt.remote
    class Acc:
        def __init__(self):
            self.v = 0

        def add(self, d):
            self.v += d
            return self.v

    @rt.remote
    def bump(handle, n):
        return rt.get([handle.add.remote(1) for _ in range(n)], timeout=30)

    a = Acc.remote()
    assert rt.get(bump.remote(a, 3), timeout=60) == [1, 2, 3]


def test_actor_creation_error(rt):
    @rt.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("ctor-fail")

        def m(self):
            return 1

    b = Broken.remote()
    with pytest.raises(rt.exceptions.ActorDiedError, match="ctor-fail"):
        rt.get(b.m.remote(), timeout=60)


def test_actor_method_error(rt):
    @rt.remote
    class Bad:
        def boom(self):
            raise ValueError("kapow-actor")

        def fine(self):
            return "ok"

    b = Bad.remote()
    with pytest.raises(rt.exceptions.TaskError, match="kapow-actor"):
        rt.get(b.boom.remote(), timeout=60)
    # the actor survives an application error
    assert rt.get(b.fine.remote(), timeout=30) == "ok"


def test_kill_actor(rt):
    @rt.remote
    class P:
        def pid(self):
            return os.getpid()

    p = P.remote()
    rt.get(p.pid.remote(), timeout=60)
    rt.kill(p)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        try:
            rt.get(p.pid.remote(), timeout=10)
            time.sleep(0.1)
        except rt.exceptions.ActorDiedError:
            return
    pytest.fail("kill() never surfaced ActorDiedError")


def test_worker_crash_surfaces(rt):
    @rt.remote(max_retries=0)
    def die():
        os._exit(1)

    with pytest.raises(rt.exceptions.WorkerCrashedError):
        rt.get(die.remote(), timeout=60)


def test_task_retry_on_worker_death(rt, tmp_path):
    marker = str(tmp_path / f"flaky_{uuid.uuid4().hex[:8]}")

    @rt.remote(max_retries=2)
    def flaky(path):
        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)
        return "recovered"

    assert rt.get(flaky.remote(marker), timeout=90) == "recovered"


def test_retry_survives_corpse_leases(rt):
    """Kill a pooled worker before submitting, so early leases name a
    dead address; max_retries=1 tasks must all still succeed."""
    @rt.remote
    def whoami():
        return os.getpid()

    pids = set(rt.get([whoami.remote() for _ in range(4)], timeout=90))
    os.kill(next(iter(pids)), signal.SIGKILL)

    @rt.remote(max_retries=1)
    def ping(i):
        return i * 2

    out = rt.get([ping.remote(i) for i in range(16)], timeout=120)
    assert out == [i * 2 for i in range(16)]


def test_actor_restart_and_exhaustion(rt):
    @rt.remote(max_restarts=1)
    class Svc:
        def __init__(self):
            self.n = 0

        def pid(self):
            return os.getpid()

        def inc(self):
            self.n += 1
            return self.n

    s = Svc.remote()
    pid1 = rt.get(s.pid.remote(), timeout=60)
    assert rt.get(s.inc.remote(), timeout=30) == 1
    os.kill(pid1, signal.SIGKILL)

    # restarted instance: fresh state, new pid
    val, pid2 = None, None
    deadline = time.monotonic() + 45
    while time.monotonic() < deadline:
        try:
            val = rt.get(s.inc.remote(), timeout=15)
            pid2 = rt.get(s.pid.remote(), timeout=15)
            break
        except rt.exceptions.ActorError:
            time.sleep(0.2)
    assert pid2 is not None and pid2 != pid1
    assert val == 1, "restart must reset actor state"

    # a second kill exhausts max_restarts=1: permanently dead
    os.kill(pid2, signal.SIGKILL)
    deadline = time.monotonic() + 45
    while time.monotonic() < deadline:
        try:
            rt.get(s.pid.remote(), timeout=15)
            time.sleep(0.2)
        except rt.exceptions.ActorDiedError:
            return
    pytest.fail("actor never became DEAD after exhausting restarts")
