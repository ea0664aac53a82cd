"""Two faults of the port's cluster client that showed only under the whole
test run's load, where test files share a process:

- a shut-down client's telemetry thread flushed once more after
  ``shutdown()``, and that flush drains every live flight recorder in the
  process (``llm/request_log.py`` ``drain_all_exports``): an engine built
  in the next few seconds lost its finished records to a closed head;
- a task that ran on a lease its submitter already held left the demand
  its failed lease requests recorded at the head, which no grant popped:
  the autoscaler read it for ``demand_window_s`` more and could launch a
  node (of another type, when the best fit was at capacity) for work that
  was done.
"""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.llm.request_log import FlightRecorder


@pytest.fixture
def cluster():
    rt.init(num_cpus=2, _system_config={"metrics_export_period_s": 0.2})
    yield
    rt.shutdown()


def test_no_flush_after_shutdown_drains_live_recorders(cluster):
    rt.shutdown()
    rec = FlightRecorder()
    for i in range(5):
        r = rec.start(f"r{i}", 3, 2)
        rec.finish(r, r.t0 + 0.1, "length")
    time.sleep(1.0)             # five of the dead client's periods
    assert len(rec.drain_export()) == 5


def test_demand_is_retired_when_the_tasks_ran_on_held_leases(cluster):
    @rt.remote(num_cpus=2)
    def heavy(i):
        time.sleep(0.3)
        return i

    # one at a time on the node's 2 CPUs: the later tasks wait, and their
    # lease requests record demand, then run on the first task's lease
    assert rt.get([heavy.remote(i) for i in range(3)], timeout=60) == \
        [0, 1, 2]
    deadline = time.monotonic() + 5.0
    demand = None
    while time.monotonic() < deadline:
        demand = global_worker.backend.head.call(
            "autoscaler_state", {"demand_window_s": 10.0})["demand"]
        if not demand:
            break
        time.sleep(0.05)
    assert demand == []
