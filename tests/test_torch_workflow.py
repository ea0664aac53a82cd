"""The port's durable workflows against ray_tpu's.

The six workflow programs of ``tests/test_jobs_dag_workflow.py`` run
once through each package's cluster runtime and must give the values and
step counts the JAX test asserts: resume from checkpoints after a failed
step, a dynamic continuation, a durable event, cancel and status, resume
from the stored graph with step retries, and ``run_async``. Then the
checkpoint layout: a workflow the JAX package ran replays in the port
from the JAX package's checkpoints (no step runs again), and its status
and list read the same in both.
"""

import importlib
import os
import threading
import time

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(scope="module", params=PACKAGES)
def rt(request):
    mod = importlib.import_module(request.param)
    mod.init(num_cpus=3, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024,
    })
    yield mod
    mod.shutdown()


def wf_mod(rt):
    return importlib.import_module(f"{rt.__name__}.workflow")


def test_workflow_resumes_from_checkpoints(rt, tmp_path):
    workflow = wf_mod(rt)
    side = str(tmp_path / "wf")
    crash = side + ".crash"
    storage = str(tmp_path / "store")

    @rt.remote
    def step_a():
        with open(side + ".a", "a") as f:
            f.write("a")
        return 5

    @rt.remote
    def step_b(v):
        if os.path.exists(crash):
            os.unlink(crash)
            raise RuntimeError("boom-first-run")
        with open(side + ".b", "a") as f:
            f.write("b")
        return v * 2

    dag = step_b.bind(step_a.bind())
    open(crash, "w").close()
    with pytest.raises(Exception, match="boom-first-run"):
        workflow.run(dag, workflow_id="wf1", storage=storage)
    assert workflow.get_status("wf1", storage=storage) == workflow.RESUMABLE
    # resume: step_a must replay from its checkpoint, not re-run
    assert workflow.run(dag, workflow_id="wf1", storage=storage) == 10
    assert workflow.run.last_stats == {"steps_run": 1, "steps_replayed": 1}
    assert open(side + ".a").read() == "a"
    assert open(side + ".b").read() == "b"
    # third run replays everything
    assert workflow.run(dag, workflow_id="wf1", storage=storage) == 10
    assert workflow.run.last_stats["steps_run"] == 0
    workflow.delete("wf1", storage=storage)
    assert workflow.get_status("wf1", storage=storage) is None


def test_workflow_dynamic_continuation(rt, tmp_path):
    workflow = wf_mod(rt)
    storage = str(tmp_path)
    pkg = rt.__name__

    @rt.remote
    def leaf(x):
        return x + 1

    @rt.remote
    def fanout(n):
        # decide the rest of the graph at runtime
        import importlib
        wf = importlib.import_module(f"{pkg}.workflow")
        return wf.continuation(leaf.bind(n * 10))

    dag = fanout.bind(3)
    assert workflow.run(dag, workflow_id="wf_dyn", storage=storage) == 31
    # resume replays BOTH the parent and the continuation steps
    assert workflow.run(dag, workflow_id="wf_dyn", storage=storage) == 31
    assert workflow.run.last_stats["steps_run"] == 0
    assert workflow.get_status("wf_dyn", storage=storage) == \
        workflow.COMPLETED
    with pytest.raises(TypeError, match="DAG node"):
        workflow.continuation(3)
    workflow.delete("wf_dyn", storage=storage)


def test_workflow_event_wait_and_signal(rt, tmp_path):
    workflow = wf_mod(rt)
    storage = str(tmp_path)

    @rt.remote
    def after_event(v):
        return f"got:{v}"

    dag = after_event.bind(workflow.event("approve", timeout_s=30.0))

    def deliver():
        time.sleep(0.4)
        workflow.signal("wf_ev", "approve", "yes", storage=storage)

    t = threading.Thread(target=deliver)
    t.start()
    out = workflow.run(dag, workflow_id="wf_ev", storage=storage)
    t.join(60)
    assert not t.is_alive()
    assert out == "got:yes"
    # durable: a fresh run sees the delivered event without re-waiting
    assert workflow.run(dag, workflow_id="wf_ev", storage=storage) == \
        "got:yes"
    # an event never delivered fails the run at its timeout
    late = after_event.bind(workflow.event("never", timeout_s=0.2))
    with pytest.raises(workflow.WorkflowError, match="not delivered"):
        workflow.run(late, workflow_id="wf_late", storage=storage)
    workflow.delete("wf_ev", storage=storage)
    workflow.delete("wf_late", storage=storage)


def test_workflow_cancel_and_status(rt, tmp_path):
    workflow = wf_mod(rt)
    storage = str(tmp_path)

    @rt.remote
    def slow_step():
        time.sleep(0.2)
        return 1

    @rt.remote
    def never_runs(v):
        return v

    # cancel before start: the run stops at its first step boundary
    workflow.cancel("wf_cancel", storage=storage)
    dag = never_runs.bind(slow_step.bind())
    with pytest.raises(workflow.WorkflowCancelledError):
        workflow.run(dag, workflow_id="wf_cancel", storage=storage)
    assert workflow.get_status("wf_cancel", storage=storage) == \
        workflow.CANCELLED
    ids = [w["workflow_id"] for w in workflow.list_all(storage)]
    assert "wf_cancel" in ids
    workflow.delete("wf_cancel", storage=storage)


def test_workflow_resume_api_and_step_retries(rt, tmp_path):
    workflow = wf_mod(rt)
    storage = str(tmp_path / "store")
    flake = str(tmp_path / "flake")

    @rt.remote
    def flaky():
        if not os.path.exists(flake):
            open(flake, "w").close()
            raise RuntimeError("first attempt dies")
        return 7

    @rt.remote
    def double(v):
        return v * 2

    dag = double.bind(flaky.bind())
    assert workflow.run(dag, workflow_id="wf_retry", storage=storage,
                        max_step_retries=2) == 14
    # resume with NO dag argument — from storage
    assert workflow.resume("wf_retry", storage=storage) == 14
    assert workflow.run.last_stats["steps_run"] == 0
    with pytest.raises(workflow.WorkflowError, match="no stored"):
        workflow.resume("wf_missing", storage=storage)
    workflow.delete("wf_retry", storage=storage)


def test_workflow_run_async(rt, tmp_path):
    workflow = wf_mod(rt)
    storage = str(tmp_path)

    @rt.remote
    def add(a, b):
        return a + b

    ref = workflow.run_async(add.bind(2, 3), workflow_id="wf_async",
                             storage=storage)
    assert rt.get(ref, timeout=60) == 5
    assert workflow.get_status("wf_async", storage=storage) == \
        workflow.COMPLETED
    workflow.delete("wf_async", storage=storage)


def _steps():
    """Plain step functions, one qualified name for both packages (a
    step's checkpoint key hashes it)."""
    def source(n):
        import numpy as np
        return np.arange(n, dtype=np.float32)

    def total(a, scale):
        return {"sum": float(a.sum()) * scale, "n": len(a)}

    return source, total


def test_checkpoints_read_across_packages(rt, tmp_path):
    """A workflow run by the JAX package replays in the port from the JAX
    package's checkpoints (and the reverse, by the port), and both read
    its status and list the same."""
    other = importlib.import_module(
        "ray_tpu_torch" if rt.__name__ == "ray_tpu" else "ray_tpu")
    workflow, other_wf = wf_mod(rt), wf_mod(other)
    storage = str(tmp_path)
    source, total = _steps()

    def dag_of(pkg):
        return pkg.remote(total).bind(pkg.remote(source).bind(6), 2.0)

    want = {"sum": 30.0, "n": 6}
    assert workflow.run(dag_of(rt), workflow_id="wf_x",
                        storage=storage) == want
    assert other_wf.get_status("wf_x", storage=storage) == "COMPLETED"
    assert [w["workflow_id"] for w in other_wf.list_all(storage)] == \
        ["wf_x"]
    # the other package replays every step without a runtime of its own:
    # no task is submitted when each step's checkpoint is there
    run = other_wf._WorkflowRun("wf_x", other_wf._storage_for(storage),
                                60.0, 0)
    assert run.run_node(dag_of(other), "root") == want
    assert (run.steps_run, run.steps_replayed) == (0, 1)
    other_wf.signal("wf_x", "ping", [1, "a"], storage=storage)
    raw = workflow._storage_for(storage).get("wf_x/event_ping")
    assert workflow.cloudpickle.loads(raw) == [1, "a"]
    other_wf.delete("wf_x", storage=storage)
    assert workflow.list_all(storage) == []
