"""The port's instance manager (``runtime/instance_manager.py``) against the
JAX package's, then ``tests/test_instance_lifecycle.py``'s cluster
programs through the port's autoscaler.

The state-machine programs run through both packages' managers on the
same script of calls: the journal (event types and fields, each trace id
replaced by its order of first use), the persisted store and each
record's history must be equal, and each run must reach the JAX file's
gates. The cluster programs (the whole journal chain of one launch, the
SIGKILLed launch and its restarts, the orphaned request, the stillborn
node) run on the port only: the JAX file already runs them on its own
package.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from ray_tpu.runtime import instance_manager as jim
from ray_tpu_torch.runtime import instance_manager as im
from ray_tpu_torch.util import fault_injector as tfi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Journal:
    """Capture journal emissions as (event_type, fields) tuples."""

    def __init__(self):
        self.events = []

    def __call__(self, etype, **fields):
        self.events.append((etype, fields))

    def types(self, node_id=None):
        return [t for t, f in self.events
                if node_id is None or f.get("node_id") == node_id]

    def normalized(self):
        """Events with trace ids numbered by first use and wall-clock
        fields dropped: what two runs of one script must share."""
        ids = {}
        out = []
        for t, f in self.events:
            f = dict(f)
            f.pop("age_s", None)
            if f.get("trace_id"):
                f["trace_id"] = ids.setdefault(f["trace_id"], len(ids))
            out.append((t, f))
        return out


def _store_view(store):
    return {k: {kk: vv for kk, vv in v.items()
                if kk not in ("trace_id", "created_wall", "updated_wall",
                              "history")}
            for k, v in store.load_all().items()}


def happy_path(m):
    store = m.MemoryInstanceStore()
    j = _Journal()
    mgr = m.InstanceManager(store, journal=j)
    rec = mgr.request("cpu", {"CPU": 2.0}, "n1")
    assert rec.state == m.REQUESTED and rec.trace_id
    assert store.load_all()["n1"]["state"] == m.REQUESTED
    mgr.transition("n1", m.ALLOCATED, metadata={"pid": 123})
    assert store.load_all()["n1"]["metadata"] == {"pid": 123}
    mgr.transition("n1", m.RUNNING)
    assert mgr.live_counts() == {"cpu": 1}
    mgr.transition("n1", m.DRAINING)
    assert mgr.live_counts() == {}
    mgr.transition("n1", m.TERMINATED)
    assert store.load_all() == {}
    assert j.types("n1") == ["instance_requested", "instance_allocated",
                             "instance_running", "instance_draining",
                             "instance_terminated"]
    assert {f["trace_id"] for _, f in j.events} == {rec.trace_id}
    return j.normalized(), [s for s, _ in rec.history]


def invalid_transitions(m):
    mgr = m.InstanceManager(m.MemoryInstanceStore())
    mgr.request("cpu", {"CPU": 1.0}, "n1")
    raised = []
    for target in (m.DRAINING, m.DEAD):
        with pytest.raises(m.InvalidTransition) as e:
            mgr.transition("n1", target)
        raised.append(str(e.value))
    mgr.transition("n1", m.LAUNCH_FAILED)
    with pytest.raises(m.InvalidTransition) as e:
        mgr.transition("n1", m.RUNNING)
    raised.append(str(e.value))
    with pytest.raises(KeyError):
        mgr.transition("ghost", m.RUNNING)
    return raised


def reconcile_verdicts(m):
    store = m.MemoryInstanceStore()
    seeder = m.InstanceManager(store)
    seeder.request("cpu", {"CPU": 1.0}, "adopt-me")
    seeder.request("cpu", {"CPU": 1.0}, "orphan-me")
    r = seeder.request("cpu", {"CPU": 1.0}, "was-running")
    seeder.transition(r.node_id, m.ALLOCATED)
    seeder.transition(r.node_id, m.RUNNING)
    d = seeder.request("cpu", {"CPU": 1.0}, "was-draining")
    seeder.transition(d.node_id, m.ALLOCATED)
    seeder.transition(d.node_id, m.RUNNING)
    seeder.transition(d.node_id, m.DRAINING)

    j = _Journal()
    mgr = m.InstanceManager(store, journal=j)
    assert mgr.load() == 4
    killed = []
    actions = mgr.reconcile(
        registered={"adopt-me"},
        provider_live={"ghost-id": {"pid": 999999}},
        terminate=lambda rec: killed.append(rec.node_id),
        orphan_grace_s=0.0)
    assert actions["adopted"] == ["adopt-me"]
    assert actions["orphaned"] == ["orphan-me"]
    assert actions["dead"] == ["was-running"]
    assert actions["drained"] == ["was-draining"]
    assert actions["unrecorded"] == ["ghost-id"]
    assert sorted(killed) == ["ghost-id", "orphan-me"]
    assert mgr.get("orphan-me").state == m.TERMINATED
    assert mgr.get("was-running").state == m.DEAD
    assert set(store.load_all()) == {"adopt-me"}
    return actions, sorted(killed), j.normalized(), _store_view(store)


def reconcile_grace(m):
    store = m.MemoryInstanceStore()
    m.InstanceManager(store).request("cpu", {"CPU": 1.0}, "young")
    mgr = m.InstanceManager(store)
    mgr.load()
    actions = mgr.reconcile(registered=set(), orphan_grace_s=60.0)
    assert actions["pending"] == ["young"]
    assert mgr.get("young").state == m.REQUESTED
    return actions


def reconcile_idempotent(m):
    store = m.MemoryInstanceStore()
    m.InstanceManager(store).request("cpu", {"CPU": 1.0}, "n1")
    j = _Journal()
    mgr = m.InstanceManager(store, journal=j)
    mgr.load()
    mgr.reconcile(registered={"n1"}, orphan_grace_s=0.0)
    n_events = len(j.events)
    assert j.types("n1") == ["instance_running"]
    again = mgr.reconcile(registered={"n1"}, orphan_grace_s=0.0)
    assert len(j.events) == n_events, "idempotent reconcile re-journaled"
    assert all(not v for v in again.values())
    mgr.load()
    assert mgr.get("n1").state == m.RUNNING
    return j.normalized(), again, _store_view(store)


PROGRAMS = [happy_path, invalid_transitions, reconcile_verdicts,
            reconcile_grace, reconcile_idempotent]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_state_machine_matches_jax(program):
    assert program(im) == program(jim)


def test_kv_prefix_and_transition_map_match_jax():
    assert im.KV_PREFIX == jim.KV_PREFIX
    assert im._ALLOWED == jim._ALLOWED
    assert im._EVENT_BY_STATE == jim._EVENT_BY_STATE
    assert im.TERMINAL_STATES == jim.TERMINAL_STATES


def test_instance_manager_and_autoscaler_import_neither_torch_nor_jax():
    code = ("import sys\n"
            "import ray_tpu_torch.runtime.instance_manager\n"
            "import ray_tpu_torch.util.fault_injector\n"
            "import ray_tpu_torch.autoscaler\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


# ------------------------------------------------ the port's cluster programs


def _wait(predicate, timeout, period=0.2, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        val = predicate()
        if val:
            return val
        time.sleep(period)
    raise AssertionError(f"timed out waiting for {desc}")


def _boot_head(session):
    from ray_tpu_torch.runtime.cluster_backend import start_head
    from ray_tpu_torch.runtime.protocol import RpcClient, RpcError
    head_proc, address = start_head(session)
    probe = RpcClient(address, name="lifecycle-test")

    def up():
        try:
            probe.call("list_nodes", timeout=5)
            return True
        except RpcError:
            return False
    _wait(up, 30, desc="head boot")
    return head_proc, address, probe


def _stop_head(head_proc, probe):
    probe.close()
    head_proc.terminate()
    try:
        head_proc.wait(timeout=5)
    except Exception:
        head_proc.kill()


def _instance_events(probe, node_id):
    evs = probe.call("events_dump", {}, timeout=10)
    return [e for e in evs if e.get("node_id") == node_id
            and (e["type"].startswith("instance_")
                 or e["type"] == "node_launch_failed")]


def test_full_lifecycle_journal_chain():
    from ray_tpu_torch.autoscaler import (Autoscaler, LocalNodeProvider,
                                          NodeTypeSpec)

    session = os.urandom(4).hex()
    head_proc, address, probe = _boot_head(session)
    scaler = Autoscaler(
        address, LocalNodeProvider(address, session),
        node_types={"w": NodeTypeSpec({"CPU": 1.0}, max_workers=1,
                                      min_workers=1)},
        idle_timeout_s=1.0, poll_period_s=0.2).start()
    try:
        rec = _wait(
            lambda: next((r for r in scaler.im.records(im.RUNNING)), None),
            45, desc="node to reach RUNNING")
        nid = rec.node_id
        assert probe.call("kv_get", {"key": im.KV_PREFIX + nid},
                          timeout=5)["state"] == im.RUNNING
        # the launched node advertises no card: its type names none
        node = next(n for n in probe.call("list_nodes", timeout=5)
                    if n["node_id"] == nid)
        assert node["resources"].get("GPU", 0.0) == 0.0

        scaler.node_types["w"].min_workers = 0
        _wait(lambda: scaler.im.get(nid).state == im.TERMINATED, 30,
              desc="idle drain to TERMINATED")

        chain = _instance_events(probe, nid)
        assert [e["type"] for e in chain] == [
            "instance_requested", "instance_allocated", "instance_running",
            "instance_draining", "instance_terminated"], chain
        traces = {e["trace_id"] for e in chain}
        assert len(traces) == 1 and rec.trace_id in traces
        decisions = [e for e in probe.call("events_dump", {}, timeout=10)
                     if e["type"].startswith("autoscaler_scale")
                     and e.get("node_id") == nid]
        assert {e["type"] for e in decisions} == {"autoscaler_scale_up",
                                                 "autoscaler_scale_down"}
        assert all(e["trace_id"] == rec.trace_id for e in decisions)
        assert probe.call("kv_keys", {"prefix": im.KV_PREFIX},
                          timeout=5) == []
        assert scaler.provider.list_live() == {}
    finally:
        scaler.stop()
        _stop_head(head_proc, probe)


def _spawn_runner(address, opts, fault=""):
    env = dict(os.environ)
    if fault:
        env[tfi.ENV_VAR] = fault
    else:
        env.pop(tfi.ENV_VAR, None)
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.autoscaler", address,
         json.dumps(opts)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _kill_ledger_pids(ledger_path):
    try:
        with open(ledger_path, encoding="utf-8") as f:
            for line in f:
                try:
                    entry = json.loads(line)
                except ValueError:
                    continue
                if entry.get("op") == "create":
                    try:
                        os.kill(int(entry["pid"]), signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
    except FileNotFoundError:
        pass


@pytest.mark.chaos
def test_sigkill_mid_launch_restart_converges_no_orphans(tmp_path):
    from ray_tpu_torch.autoscaler import LocalNodeProvider

    session = os.urandom(4).hex()
    ledger = str(tmp_path / "provider.ledger")
    opts = {"session": session, "ledger_path": ledger,
            "poll_period_s": 0.2,
            "node_types": {"w": {"resources": {"CPU": 1.0},
                                 "max_workers": 1, "min_workers": 1}}}
    head_proc, address, probe = _boot_head(session)
    runner = None
    # every incarnation's Popen stays referenced: collecting one closes
    # the read end of its stdout pipe, which the node daemon it launched
    # inherited and writes to
    runners = []
    try:
        runner = _spawn_runner(address, opts,
                               fault="autoscaler.post_create=kill9")
        runners.append(runner)
        assert runner.wait(timeout=60) == -signal.SIGKILL
        keys = _wait(lambda: probe.call(
            "kv_keys", {"prefix": im.KV_PREFIX}, timeout=5), 10,
            desc="write-ahead record")
        assert len(keys) == 1
        record = probe.call("kv_get", {"key": keys[0]}, timeout=5)
        nid = record["node_id"]
        assert record["state"] == im.REQUESTED
        provider = LocalNodeProvider(address, session, ledger_path=ledger)
        assert set(provider.list_live()) == {nid}
        _wait(lambda: any(n["node_id"] == nid and n["alive"]
                          for n in probe.call("list_nodes", timeout=5)),
              45, desc="orphan node registration")

        runner = _spawn_runner(address, opts)
        runners.append(runner)
        _wait(lambda: probe.call(
            "kv_get", {"key": im.KV_PREFIX + nid},
            timeout=5)["state"] == im.RUNNING, 45,
            desc="adoption to RUNNING")
        types = [e["type"] for e in _instance_events(probe, nid)]
        assert types == ["instance_requested", "instance_running"], types
        traces = {e["trace_id"] for e in _instance_events(probe, nid)}
        assert len(traces) == 1
        assert set(provider.list_live()) == {nid}
        assert probe.call("kv_keys", {"prefix": im.KV_PREFIX},
                          timeout=5) == [im.KV_PREFIX + nid]
        evs = probe.call("events_dump", {}, timeout=10)
        assert not [e for e in evs if e["type"] in
                    ("instance_terminated", "instance_unrecorded",
                     "node_launch_failed")], evs

        runner.send_signal(signal.SIGKILL)
        runner.wait(timeout=10)
        runner = _spawn_runner(address, opts)
        runners.append(runner)
        time.sleep(3.0)  # several reconcile passes
        assert runner.poll() is None, runner.stdout.read()
        types = [e["type"] for e in _instance_events(probe, nid)]
        assert types == ["instance_requested", "instance_running"], \
            f"double restart duplicated transitions: {types}"
        assert set(provider.list_live()) == {nid}
    finally:
        for r in runners:
            r.kill()
        _kill_ledger_pids(ledger)
        _stop_head(head_proc, probe)


@pytest.mark.chaos
def test_requested_orphan_terminated_after_restart(tmp_path):
    from ray_tpu_torch.autoscaler import LocalNodeProvider

    session = os.urandom(4).hex()
    ledger = str(tmp_path / "provider.ledger")
    base = {"session": session, "ledger_path": ledger,
            "poll_period_s": 0.2,
            "config": {"instance_orphan_grace_s": 0.5}}
    opts1 = {**base, "node_types": {"w": {"resources": {"CPU": 1.0},
                                          "max_workers": 1,
                                          "min_workers": 1}}}
    opts2 = {**base, "node_types": {"w": {"resources": {"CPU": 1.0},
                                          "max_workers": 1,
                                          "min_workers": 0}}}
    head_proc, address, probe = _boot_head(session)
    runner = None
    try:
        runner = _spawn_runner(address, opts1,
                               fault="autoscaler.pre_create=kill9")
        assert runner.wait(timeout=60) == -signal.SIGKILL
        keys = _wait(lambda: probe.call(
            "kv_keys", {"prefix": im.KV_PREFIX}, timeout=5), 10,
            desc="write-ahead record")
        nid = probe.call("kv_get", {"key": keys[0]}, timeout=5)["node_id"]
        time.sleep(1.0)  # age the record past the 0.5 s orphan grace

        runner = _spawn_runner(address, opts2)
        _wait(lambda: probe.call("kv_keys", {"prefix": im.KV_PREFIX},
                                 timeout=5) == [], 30,
              desc="orphan record cleanup")
        chain = _instance_events(probe, nid)
        assert [e["type"] for e in chain] == [
            "instance_requested", "instance_terminated"], chain
        assert chain[-1].get("detail") == "orphaned-launch"
        assert LocalNodeProvider(address, session,
                                 ledger_path=ledger).list_live() == {}
    finally:
        if runner is not None:
            runner.kill()
        _kill_ledger_pids(ledger)
        _stop_head(head_proc, probe)


@pytest.mark.chaos
def test_stillborn_node_journaled_as_launch_failed():
    from ray_tpu_torch.autoscaler import (Autoscaler, LocalNodeProvider,
                                          NodeTypeSpec)

    session = os.urandom(4).hex()
    head_proc, address, probe = _boot_head(session)
    # armed through the env so only the daemons the autoscaler spawns
    # (which inherit it) die at boot
    os.environ[tfi.ENV_VAR] = "node.boot=exit:3"
    scaler = Autoscaler(
        address, LocalNodeProvider(address, session),
        node_types={"w": NodeTypeSpec({"CPU": 1.0}, max_workers=1,
                                      min_workers=1)},
        idle_timeout_s=5.0, poll_period_s=0.2).start()
    try:
        failed = _wait(
            lambda: [e for e in probe.call("events_dump",
                                           {"type": "node_launch_failed"},
                                           timeout=5)
                     if e.get("detail") == "died-pre-register"],
            45, desc="node_launch_failed journal entry")
        ev = failed[0]
        assert ev["node_type"] == "w"
        assert ev["exit_info"] == "3"
        assert ev["trace_id"]
        rec = scaler.im.get(ev["node_id"])
        assert rec is not None and rec.state == im.LAUNCH_FAILED
    finally:
        os.environ.pop(tfi.ENV_VAR, None)
        tfi.reset()
        scaler.stop()
        _stop_head(head_proc, probe)
