"""The port's lazy and compiled DAGs against ray_tpu's.

Each program of the DAG part of ``tests/test_jobs_dag_workflow.py`` runs
once through each package's cluster runtime (head, node daemon, worker
processes and the shm store, booted by ``init()``) and must give the
values the JAX test asserts: bind/execute, a diamond whose shared node
runs once, ``InputNode``, and the compiled actor chain (ordering over 20
pipelined executions, an error travelling the channel, ``teardown``).
The JAX test's speed criterion (compiled >= 2x eager chained calls) is a
timing assert, which runs on the card in ``chip_smoke.py`` phase 18b, not
in this suite.

``CompiledDAG`` on the CPU runs the stages in order; it is held against
the JAX package's ``experimental_compile`` (one jitted program) on the
same values from a numpy seed (rtol 1e-6, the JAX test's), and a new
input signature is a compile that the compile tracker records.
"""

import importlib
import uuid

import numpy as np
import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
RTOL = 1e-6


@pytest.fixture(scope="module", params=PACKAGES)
def rt(request):
    mod = importlib.import_module(request.param)
    mod.init(num_cpus=3, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024,
    })
    yield mod
    mod.shutdown()


def dag_mod(rt):
    return importlib.import_module(f"{rt.__name__}.dag")


def test_dag_bind_execute(rt):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def mul(a, b):
        return a * b

    dag = mul.bind(add.bind(1, 2), add.bind(3, 4))
    assert rt.get(dag.execute(), timeout=60) == 21


def test_dag_diamond_runs_shared_node_once(rt, tmp_path):
    marker = str(tmp_path / f"dag_{uuid.uuid4().hex[:8]}")

    @rt.remote
    def base(path):
        with open(path, "a") as f:
            f.write("x")
        return 10

    @rt.remote
    def inc(v):
        return v + 1

    @rt.remote
    def total(a, b):
        return a + b

    shared = base.bind(marker)
    dag = total.bind(inc.bind(shared), inc.bind(shared))
    assert rt.get(dag.execute(), timeout=60) == 22
    assert open(marker).read() == "x", "shared node ran more than once"


def test_dag_input_node(rt):
    dag_m = dag_mod(rt)

    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def add1(x):
        return x + 1

    with dag_m.InputNode() as inp:
        dag = add1.bind(double.bind(inp))
    assert rt.get(dag_m.execute_with_input(dag, 5), timeout=60) == 11
    assert rt.get(dag_m.execute_with_input(dag, 7), timeout=60) == 15


def _diamond(rt):
    dag_m = dag_mod(rt)

    @rt.remote
    def scale(x):
        return x * 2.0

    @rt.remote
    def shift(x):
        return x + 1.0

    @rt.remote
    def combine(a, b):
        return a * b          # diamond: both branches from one input

    with dag_m.InputNode() as inp:
        return combine.bind(scale.bind(inp), shift.bind(inp))


def _as_input(rt, x):
    if rt.__name__ == "ray_tpu":
        import jax.numpy as jnp
        return jnp.asarray(x)
    import torch
    return torch.tensor(x)


def test_compiled_dag_matches_task_path(rt):
    """experimental_compile's result equals the task path's on the same
    graph, and a repeat execution gives the closed form (the JAX test's
    program, on each package)."""
    dag_m = dag_mod(rt)
    dag = _diamond(rt)
    x = np.asarray([1.0, 2.0, 3.0], np.float32)
    compiled = dag_m.experimental_compile(dag)
    fused = compiled.execute(_as_input(rt, x))
    via_tasks = rt.get(dag_m.execute_with_input(dag, x), timeout=60)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(via_tasks),
                               rtol=RTOL)
    first = np.array(fused, copy=True)
    again = compiled.execute(_as_input(rt, x * 2))
    np.testing.assert_allclose(np.asarray(again),
                               x * 2 * 2 * (x * 2 + 1), rtol=RTOL)
    # a result kept from one execute is not overwritten by the next
    np.testing.assert_array_equal(np.asarray(fused), first)


def test_compiled_dag_against_jax():
    """The port's CompiledDAG (stages in order, CPU tensors) against the
    JAX package's one jitted program, on the same values from a numpy
    seed and at two input signatures."""
    import torch

    import ray_tpu
    import ray_tpu_torch
    from ray_tpu import dag as jdag
    from ray_tpu_torch import dag as tdag
    jc = jdag.experimental_compile(_diamond(ray_tpu))
    tc = tdag.experimental_compile(_diamond(ray_tpu_torch))
    assert isinstance(tc, tdag.CompiledDAG)
    rng = np.random.default_rng(0)
    for shape in [(3,), (4, 5), (3,)]:
        x = rng.standard_normal(shape).astype(np.float32)
        got = tc.execute(torch.tensor(x))
        want = np.asarray(jc.execute(_as_input(ray_tpu, x)))
        assert isinstance(got, torch.Tensor) and got.shape == shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_compiled_dag_records_compiles():
    """Each new input signature is one compile in the tracker (a new CUDA
    graph on the card; on the CPU, the first run at that signature),
    with the signature recorded; a repeat signature records nothing."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import dag as tdag
    from ray_tpu_torch.util import compile_tracker
    tracker = compile_tracker.ensure_started()
    assert tracker is not None

    def compiles():
        return (tracker.callable_stats("dag.compiled") or {}).get(
            "compiles", 0)

    base = compiles()
    compiled = tdag.experimental_compile(_diamond(ray_tpu_torch))
    compiled.execute(torch.ones(3))
    compiled.execute(torch.ones(3) * 2)
    assert compiles() == base + 1
    compiled.execute(torch.ones(2, 3))
    compiled.execute(torch.ones(3, dtype=torch.float64))
    assert compiles() == base + 3
    last = tracker.last_recompile("dag.")
    assert last is not None and last["name"] == "dag.compiled"
    assert compiled.captures() == 0      # no CUDA input, no graph


def test_compiled_dag_needs_input_node():
    import ray_tpu_torch
    from ray_tpu_torch import dag as tdag

    @ray_tpu_torch.remote
    def one():
        return 1

    with pytest.raises(ValueError, match="InputNode"):
        tdag.experimental_compile(one.bind())


def test_compiled_actor_dag_pipeline(rt):
    """The cross-actor compiled DAG (pre-launched loops + shm channel
    rings): ordering under pipelined submission, error propagation, a
    window larger than the rings, and teardown (the JAX test's program
    without its timing assert)."""
    dag_m = dag_mod(rt)

    @rt.remote(num_cpus=0)
    class Doubler:
        def f(self, x):
            if x == "boom":
                raise ValueError("boom-input")
            return x * 2

    @rt.remote(num_cpus=0)
    class AddOne:
        def g(self, x):
            return x + 1

    a, b = Doubler.remote(), AddOne.remote()
    assert rt.get(b.g.remote(rt.get(a.f.remote(1), timeout=60)),
                  timeout=60) == 3

    with dag_m.InputNode() as inp:
        dag = b.g.bind(a.f.bind(inp))
    compiled = dag_m.experimental_compile(dag, capacity=4)
    assert isinstance(compiled, dag_m.CompiledActorDAG)
    try:
        refs = [compiled.execute(i) for i in range(20)]
        assert [r.get() for r in refs] == [2 * i + 1 for i in range(20)]

        bad = compiled.execute("boom")
        ok = compiled.execute(5)
        with pytest.raises(ValueError, match="boom-input"):
            bad.get()
        assert ok.get() == 11
        with pytest.raises(ValueError, match="already consumed"):
            ok.get()
    finally:
        compiled.teardown()
    with pytest.raises(RuntimeError, match="torn down"):
        compiled.execute(1)
    # the actors serve eager calls again once their loops have stopped
    assert rt.get(b.g.remote(rt.get(a.f.remote(4), timeout=60)),
                  timeout=60) == 9


def test_compiled_actor_dag_rejects_non_chains(rt):
    dag_m = dag_mod(rt)

    @rt.remote(num_cpus=0)
    class Two:
        def h(self, x, y):
            return x + y

    t = Two.remote()
    with dag_m.InputNode() as inp:
        dag = t.h.bind(inp, inp)
    with pytest.raises(ValueError, match="linear chains"):
        dag_m.experimental_compile(dag)
    rt.kill(t)


def test_channel_round_trip_and_backpressure(rt):
    """The shm ring alone on the driver's store: values (a tensor for the
    port) come back in order, a full ring refuses try_put, close() makes
    the reader raise ChannelClosed."""
    chan = importlib.import_module(f"{rt.__name__}.runtime.channel")
    worker = importlib.import_module(f"{rt.__name__}.core.worker")
    store = worker.global_worker.backend.object_plane.store
    name = uuid.uuid4().hex[:12]
    w = chan.ShmChannel(store, name, 2)
    r = chan.ShmChannel(store, name, 2)
    if rt.__name__ == "ray_tpu_torch":
        import torch
        value = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    else:
        value = np.arange(6, dtype=np.float32).reshape(2, 3)
    w.put(("v", value))
    assert w.try_put(("v", 1))
    assert not w.try_put(("v", 2))          # both slots taken
    tag, got = r.get(timeout=5)
    assert tag == "v" and got.shape == (2, 3)
    assert (np.asarray(got.float() if hasattr(got, "float") else got)
            == np.arange(6).reshape(2, 3)).all()
    assert r.get(timeout=5) == ("v", 1)
    assert w.close(timeout=5)
    with pytest.raises(chan.ChannelClosed):
        r.get(timeout=5)
    with pytest.raises(TimeoutError):
        r.get(timeout=0.05)
    w.drain()
