"""The port's local-mode runtime against ray_tpu's local mode.

Each program runs through both packages, each ``init(local_mode=True)``ed
in its own fixture, and the results must be equal. Among them are the
programs of ``tests/test_core_api.py``: an error through a dependency, an
actor's method error that leaves it alive, actor handles passed to tasks,
``.options()`` overrides, nested tasks and ``wait`` capping the ready refs
at ``num_returns``. Blocking tasks wait on
a ``threading.Event`` (local mode passes values by reference), so the
``wait`` and timeout cases are deterministic.
"""

import gc
import os
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch


@pytest.fixture
def jax_rt():
    # the JAX local-mode store's plain lock deadlocks when the cyclic
    # collector frees an ObjectRef inside it: no collection while the JAX
    # program runs (as tests/test_torch_data.py does)
    gc.disable()
    ray_tpu.init(local_mode=True, num_cpus=4)
    try:
        yield ray_tpu
    finally:
        ray_tpu.shutdown()
        gc.enable()
        gc.collect()


@pytest.fixture
def torch_rt():
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def tasks(rt):
    @rt.remote
    def square(x):
        return x * x

    return rt.get([square.remote(i) for i in range(8)], timeout=60)


def ref_arguments(rt):
    @rt.remote
    def add(a, b):
        return a + b

    x = rt.put(3)
    y = add.remote(x, 4)
    return rt.get(add.remote(y, y), timeout=60), rt.get(x, timeout=60)


def num_returns(rt):
    @rt.remote(num_returns=2)
    def pair(x):
        return x, x + 1

    a, b = pair.remote(10)
    return rt.get([a, b], timeout=60)


def actor_calls_in_order(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(5)
    return rt.get([c.incr.remote(k=i % 3) for i in range(20)], timeout=60)


def method_num_returns(rt):
    @rt.remote
    class Splitter:
        @rt.method(num_returns=2)
        def split(self, s):
            return s[:2], s[2:]

    a, b = Splitter.remote().split.remote("abcdef")
    return rt.get(a, timeout=60), rt.get(b, timeout=60)


def put_get(rt):
    values = [1, "text", [1, 2, 3], {"k": (4, 5)}, np.arange(6).reshape(2, 3)]
    out = rt.get([rt.put(v) for v in values], timeout=60)
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
    first = (len(ready), len(pending),
             set(rt.get(ready, timeout=60)) <= {0, 2, 4})
    rt.get(refs[::2], timeout=10)
    # three are ready: asking for four returns three at the timeout
    ready, pending = rt.wait(refs, num_returns=4, timeout=0.3)
    timed_out = (len(ready), len(pending), sorted(rt.get(ready, timeout=60)))
    gate.set()
    ready, pending = rt.wait(refs, num_returns=5, timeout=10)
    return (first, timed_out, (len(ready), len(pending)),
            rt.get(refs, timeout=60))


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
        rt.get(fails.remote(7), timeout=60)
    except rt.exceptions.TaskError as e:
        return type(e).__name__, e.cause_cls_name, "bad input 7" in str(e)
    return None


def kill_then_call(rt):
    @rt.remote
    class Echo:
        def echo(self, x):
            return x

    a = Echo.remote()
    before = rt.get(a.echo.remote("hi"), timeout=60)
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
    found = rt.get(rt.get_actor("keeper").value.remote(), timeout=60)
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

    return (rt.get(read.remote(), timeout=60),
            "RTPU_PORT_TEST_VAR" in os.environ)


def streaming(rt):
    @rt.remote(num_returns="streaming")
    def count(n):
        for i in range(n):
            yield i * 10

    return [rt.get(r, timeout=60) for r in count.remote(4)]


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


def error_through_dependency(rt):
    @rt.remote
    def boom():
        raise RuntimeError("first failure")

    @rt.remote
    def identity(x):
        return x

    try:
        rt.get(identity.remote(boom.remote()), timeout=60)
    except rt.exceptions.TaskError as e:
        return type(e).__name__, "first failure" in str(e)
    return None


def actor_error_keeps_actor(rt):
    @rt.remote
    class A:
        def ok(self):
            return "ok"

        def fail(self):
            raise RuntimeError("method error")

    a = A.remote()
    try:
        rt.get(a.fail.remote(), timeout=60)
        failed = None
    except rt.exceptions.TaskError as e:
        failed = type(e).__name__, "method error" in str(e)
    return failed, rt.get(a.ok.remote(), timeout=60)


def actor_handle_passing(rt):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    @rt.remote
    def bump(counter):
        return rt.get(counter.incr.remote(), timeout=60)

    c = Counter.remote()
    return sorted(rt.get([bump.remote(c) for _ in range(5)], timeout=60))


def options_override(rt):
    @rt.remote
    def f():
        return "x"

    return rt.get(f.options(name="custom", num_returns=1).remote(),
                  timeout=60)


def nested_tasks(rt):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=60) + 1

    return rt.get(outer.remote(10), timeout=60)


def wait_caps_ready_at_num_returns(rt):
    refs = [rt.put(i) for i in range(5)]
    ready, pending = rt.wait(refs, num_returns=2, timeout=5)
    return len(ready), len(pending), rt.get(ready, timeout=60)


PROGRAMS = [tasks, ref_arguments, num_returns, actor_calls_in_order,
            method_num_returns, put_get, wait_with_num_returns_and_timeout,
            get_timeout, task_error, kill_then_call, named_actor,
            runtime_env_vars, streaming, cancelled_task, resources,
            error_through_dependency, actor_error_keeps_actor,
            actor_handle_passing, options_override, nested_tasks,
            wait_caps_ready_at_num_returns]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_port_runtime_matches_ray_tpu_local_mode(program, jax_rt, torch_rt):
    want = program(jax_rt)
    got = program(torch_rt)
    assert got == want
    assert None not in (want if isinstance(want, tuple) else (want,))


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
    """bind() builds lazy DAG nodes in local mode too (it raised before
    ``dag.py`` was ported); what raises now is a graph executed without
    the input its InputNode stands for."""
    from ray_tpu_torch.dag import (ActorMethodNode, DAGNode, InputNode,
                                   execute_with_input)

    @torch_rt.remote
    def f(x):
        return x

    @torch_rt.remote
    class A:
        def m(self):
            return 1

    node = f.bind(1)
    assert isinstance(node, DAGNode)
    assert torch_rt.get(node.execute(), timeout=30) == 1
    method = A.remote().m.bind()
    assert isinstance(method, ActorMethodNode)
    assert torch_rt.get(method.execute(), timeout=30) == 1
    with InputNode() as inp:
        dag = f.bind(inp)
    with pytest.raises(ValueError, match="no input supplied"):
        dag.execute()
    assert torch_rt.get(execute_with_input(dag, 7), timeout=30) == 7


@pytest.mark.parametrize("env, error", [
    ({"working_dir": "."}, ray_tpu_torch.exceptions.TaskError),
    ({"pip": ["x"]}, NotImplementedError),
    ("env_vars", ValueError),
    ({"env_vars": {"A": 1}}, ValueError),
])
def test_runtime_env_local_mode_cannot_apply_raises(env, error):
    """Malformed envs and keys of neither mode raise at decoration; a
    working_dir is a cluster-mode key, which local mode, like the JAX
    package's, fails at the call (tests/test_runtime_env.py)."""
    class C:
        def m(self):
            return 1

    if "working_dir" not in env:
        with pytest.raises(error):
            ray_tpu_torch.remote(runtime_env=env)(lambda: None)
        with pytest.raises(error):
            ray_tpu_torch.remote(runtime_env=env)(C)
        return
    f = ray_tpu_torch.remote(runtime_env=env)(lambda: None)
    actor_cls = ray_tpu_torch.remote(runtime_env=env)(C)
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        with pytest.raises(error, match="working_dir"):
            ray_tpu_torch.get(f.remote(), timeout=30)
        with pytest.raises(ray_tpu_torch.exceptions.ActorDiedError,
                           match="working_dir"):
            ray_tpu_torch.get(actor_cls.remote().m.remote(), timeout=30)
    finally:
        ray_tpu_torch.shutdown()


def test_killed_local_actor_lets_its_instance_go(torch_rt):
    """A killed local-mode actor's instance dies once its thread has
    joined, not at shutdown (the thread drops it at the kill tombstone)."""
    import gc
    import weakref

    @torch_rt.remote
    class Holder:
        def ping(self):
            return "pong"

    h = Holder.remote()
    assert torch_rt.get(h.ping.remote(), timeout=30) == "pong"
    backend = ray_tpu_torch.core.worker.global_worker.backend
    entry = backend.actors[h.actor_id]
    alive = weakref.ref(entry.instance)
    torch_rt.kill(h)
    entry.thread.join(timeout=30)
    assert not entry.thread.is_alive()
    gc.collect()
    assert alive() is None
    assert h.actor_id in backend.actors   # the tombstone stays for calls
    with pytest.raises(torch_rt.exceptions.ActorDiedError):
        torch_rt.get(h.ping.remote(), timeout=10)


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


def test_stack_sampler_runs_only_when_asked():
    """The continuous stack sampler is off unless ``profile_enabled`` is
    set; once set, it samples this process's threads."""
    from ray_tpu_torch.core import config
    from ray_tpu_torch.util import stack_profiler
    config.reset_to_defaults()
    assert stack_profiler.ensure_started() is None
    config.GlobalConfig.apply({"profile_enabled": True, "profile_hz": 200})
    try:
        assert stack_profiler.ensure_started().running
        deadline = time.monotonic() + 10
        export = None
        while export is None and time.monotonic() < deadline:
            time.sleep(0.05)
            export = stack_profiler.drain_export()
        assert export is not None and export["samples"] > 0
        assert export["stacks"]
    finally:
        stack_profiler.stop_global()
        config.reset_to_defaults()
