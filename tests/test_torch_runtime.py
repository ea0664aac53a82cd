"""The port's local-mode runtime against ray_tpu's local mode.

Each program runs through both packages, each ``init(local_mode=True)``ed
in its own fixture, and the results must be equal. Blocking tasks wait on
a ``threading.Event`` (local mode passes values by reference), so the
``wait`` and timeout cases are deterministic.
"""

import os
import threading

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch


@pytest.fixture
def jax_rt():
    ray_tpu.init(local_mode=True, num_cpus=4)
    yield ray_tpu
    ray_tpu.shutdown()


@pytest.fixture
def torch_rt():
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def tasks(rt):
    @rt.remote
    def square(x):
        return x * x

    return rt.get([square.remote(i) for i in range(8)])


def ref_arguments(rt):
    @rt.remote
    def add(a, b):
        return a + b

    x = rt.put(3)
    y = add.remote(x, 4)
    return rt.get(add.remote(y, y)), rt.get(x)


def num_returns(rt):
    @rt.remote(num_returns=2)
    def pair(x):
        return x, x + 1

    a, b = pair.remote(10)
    return rt.get([a, b])


def actor_calls_in_order(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(5)
    return rt.get([c.incr.remote(k=i % 3) for i in range(20)])


def method_num_returns(rt):
    @rt.remote
    class Splitter:
        @rt.method(num_returns=2)
        def split(self, s):
            return s[:2], s[2:]

    a, b = Splitter.remote().split.remote("abcdef")
    return rt.get(a), rt.get(b)


def put_get(rt):
    values = [1, "text", [1, 2, 3], {"k": (4, 5)}, np.arange(6).reshape(2, 3)]
    out = rt.get([rt.put(v) for v in values])
    return [v.tolist() if isinstance(v, np.ndarray) else v for v in out]


def wait_with_num_returns_and_timeout(rt):
    gate = threading.Event()

    @rt.remote
    def fast(i):
        return i

    @rt.remote
    def slow(i, ev):
        ev.wait(30)
        return i

    refs = [fast.remote(0), slow.remote(1, gate), fast.remote(2),
            slow.remote(3, gate), fast.remote(4)]
    ready, pending = rt.wait(refs, num_returns=2, timeout=10)
    first = (len(ready), len(pending), set(rt.get(ready)) <= {0, 2, 4})
    rt.get(refs[::2], timeout=10)
    # three are ready: asking for four returns three at the timeout
    ready, pending = rt.wait(refs, num_returns=4, timeout=0.3)
    timed_out = (len(ready), len(pending), sorted(rt.get(ready)))
    gate.set()
    ready, pending = rt.wait(refs, num_returns=5, timeout=10)
    return first, timed_out, (len(ready), len(pending)), rt.get(refs)


def get_timeout(rt):
    gate = threading.Event()

    @rt.remote
    def blocked(ev):
        ev.wait(30)
        return "done"

    ref = blocked.remote(gate)
    try:
        rt.get(ref, timeout=0.1)
        raised = None
    except rt.exceptions.GetTimeoutError as e:
        raised = (type(e).__name__, isinstance(e, TimeoutError))
    gate.set()
    return raised, rt.get(ref, timeout=10)


def task_error(rt):
    @rt.remote
    def fails(x):
        raise ValueError(f"bad input {x}")

    try:
        rt.get(fails.remote(7))
    except rt.exceptions.TaskError as e:
        return type(e).__name__, e.cause_cls_name, "bad input 7" in str(e)
    return None


def kill_then_call(rt):
    @rt.remote
    class Echo:
        def echo(self, x):
            return x

    a = Echo.remote()
    before = rt.get(a.echo.remote("hi"))
    rt.kill(a)
    try:
        rt.get(a.echo.remote("again"), timeout=10)
        after = None
    except rt.exceptions.ActorDiedError as e:
        after = type(e).__name__
    return before, after


def named_actor(rt):
    @rt.remote
    class Keeper:
        def __init__(self, v):
            self.v = v

        def value(self):
            return self.v

    Keeper.options(name="keeper").remote(42)
    found = rt.get(rt.get_actor("keeper").value.remote())
    try:
        rt.get_actor("nobody")
        missing = None
    except ValueError:
        missing = "ValueError"
    return found, missing


def runtime_env_vars(rt):
    @rt.remote(runtime_env={"env_vars": {"RTPU_PORT_TEST_VAR": "set"}})
    def read():
        return os.environ.get("RTPU_PORT_TEST_VAR")

    return rt.get(read.remote()), "RTPU_PORT_TEST_VAR" in os.environ


def streaming(rt):
    @rt.remote(num_returns="streaming")
    def count(n):
        for i in range(n):
            yield i * 10

    return [rt.get(r) for r in count.remote(4)]


def cancelled_task(rt):
    gate = threading.Event()

    @rt.remote
    def blocked(ev):
        ev.wait(30)

    @rt.remote
    def never():
        return 1

    # fill the pool so that `never` is queued when it is cancelled
    holds = [blocked.remote(gate) for _ in range(4)]
    ref = never.remote()
    rt.cancel(ref)
    gate.set()
    rt.get(holds, timeout=10)
    try:
        rt.get(ref, timeout=10)
    except rt.exceptions.TaskCancelledError as e:
        return type(e).__name__
    return None


def resources(rt):
    return rt.cluster_resources(), rt.available_resources(), rt.nodes()


PROGRAMS = [tasks, ref_arguments, num_returns, actor_calls_in_order,
            method_num_returns, put_get, wait_with_num_returns_and_timeout,
            get_timeout, task_error, kill_then_call, named_actor,
            runtime_env_vars, streaming, cancelled_task, resources]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_port_runtime_matches_ray_tpu_local_mode(program, jax_rt, torch_rt):
    want = program(jax_rt)
    got = program(torch_rt)
    assert got == want
    assert None not in (want if isinstance(want, tuple) else (want,))


def test_cluster_init_raises():
    with pytest.raises(NotImplementedError, match="local mode only"):
        ray_tpu_torch.init()
    assert not ray_tpu_torch.is_initialized()


def test_init_twice_raises_unless_tolerated(torch_rt):
    with pytest.raises(RuntimeError, match="called twice"):
        torch_rt.init(local_mode=True)
    assert torch_rt.init(local_mode=True, ignore_reinit_error=True) \
        == {"address": "existing"}


def test_api_before_init_raises():
    with pytest.raises(ray_tpu_torch.exceptions.RayTpuError,
                       match="not initialized"):
        ray_tpu_torch.put(1)


def test_bind_raises(torch_rt):
    @torch_rt.remote
    def f(x):
        return x

    @torch_rt.remote
    class A:
        def m(self):
            return 1

    with pytest.raises(NotImplementedError, match="dag"):
        f.bind(1)
    with pytest.raises(NotImplementedError, match="dag"):
        A.remote().m.bind()


@pytest.mark.parametrize("env, error", [
    ({"working_dir": "."}, NotImplementedError),
    ({"pip": ["x"]}, NotImplementedError),
    ("env_vars", ValueError),
    ({"env_vars": {"A": 1}}, ValueError),
])
def test_runtime_env_local_mode_cannot_apply_raises(env, error):
    with pytest.raises(error):
        ray_tpu_torch.remote(runtime_env=env)(lambda: None)

    class C:
        pass

    with pytest.raises(error):
        ray_tpu_torch.remote(runtime_env=env)(C)


def test_runtime_context(torch_rt):
    ctx = torch_rt.get_runtime_context()
    assert ctx.get()["job_id"] == ray_tpu_torch.core.worker.global_worker \
        .job_id.hex()
    assert len(ctx.get()["worker_id"]) == 32


def test_shutdown_waits_for_actor_threads():
    ray_tpu_torch.init(local_mode=True, num_cpus=2)

    @ray_tpu_torch.remote
    class Slow:
        def work(self):
            threading.Event().wait(0.2)
            return 1

    a = Slow.remote()
    a.work.remote()
    ray_tpu_torch.shutdown()
    assert not [t for t in threading.enumerate()
                if t.name == "actor-Slow" and t.is_alive()]


def test_resources_with_a_card_and_custom_resources():
    """``init(num_gpus=, resources=)`` shows in the resource views, as the
    JAX package's ``resources=`` does (it has no num_gpus)."""
    ray_tpu.init(local_mode=True, num_cpus=2, resources={"GPU": 1.0,
                                                         "pool": 3.0})
    ray_tpu_torch.init(local_mode=True, num_cpus=2, num_gpus=1,
                       resources={"pool": 3.0})
    try:
        assert ray_tpu_torch.cluster_resources() == \
            ray_tpu.cluster_resources() == {"CPU": 2.0, "GPU": 1.0,
                                            "pool": 3.0}
        assert ray_tpu_torch.nodes() == ray_tpu.nodes()
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


# an IMPALA program that ends without shutdown(): its runner actors are
# still sampling inside torch code when the interpreter exits
EXIT_PROGRAM = """
import sys
sys.path.insert(0, {root!r})
import torch
import ray_tpu_torch
from ray_tpu_torch.rllib import IMPALAConfig
ray_tpu_torch.init(local_mode=True)
algo = IMPALAConfig(seed=0).build(device="cpu")
algo.train()
algo.train()
print("trained")
"""


def test_exit_without_shutdown_joins_the_actor_threads():
    """``init`` registers ``shutdown`` to run at exit: without it, the
    program above aborted ("terminate called without an active
    exception", rc 134) in about three runs of four, so it runs three
    times."""
    import subprocess
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    for _ in range(3):
        out = subprocess.run([sys.executable, "-c",
                              EXIT_PROGRAM.format(root=root)],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
        assert out.stdout.strip() == "trained"
        assert "terminate called" not in out.stderr


def test_memory_store_frees_inside_its_own_lock():
    """The cyclic collector may run an ObjectRef's ``__del__`` inside an
    allocation the memory store makes under its lock; ``__del__`` frees
    its object through the same lock on the same thread. Here an entry's
    construction drops the last reference to another object: the store
    must not deadlock (the JAX package's plain lock does)."""
    from ray_tpu_torch.core import memory_store as ms
    from ray_tpu_torch.core.ids import ObjectID, TaskID
    store = ms.MemoryStore()
    task = TaskID.for_driver(ray_tpu_torch.core.ids.JobID.from_int(1))
    held, fresh = ObjectID.for_put(task, 1), ObjectID.for_put(task, 2)
    store.put(held, "value")

    class FreeingEntry(ms._Entry):
        def __init__(self):
            super().__init__()
            store.delete(held)            # what __del__ would do here

    done = threading.Event()

    def run():
        orig = ms._Entry
        ms._Entry = FreeingEntry
        try:
            store.put(fresh, 1)
        finally:
            ms._Entry = orig
        done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(10)
    assert done.is_set(), "the store deadlocked on its own lock"
    assert not store.contains(held) and store.get_if_ready(fresh)[0] == 1
