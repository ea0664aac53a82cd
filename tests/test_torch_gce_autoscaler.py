"""The Compute Engine provider under the port's autoscaler, on a live
cluster: the twin of ``tests/test_autoscaler.py::
test_tpu_slice_gang_scale_up_and_drain`` (the JAX package's TPU slice
behind its mocked API), with an A3 VM in place of the slice.

A pending ``[{"GPU": 1, "GPU-H100": 1}]`` bundle gives exactly one
insert through a fake Compute API, capped at ``max_workers``; a local
daemon standing in for the VM joins under the handle's node id, the
group is placed, and once it is removed idle drain gives exactly one
DELETE of that instance. Then a restart: the autoscaler dies after the
insert and before it persists the launch's metadata; a new one finds the
instance through ``list_live`` and terminates the orphan by its
deterministic name. Every wait is bounded.
"""

import os
import threading
import time

import pytest

import ray_tpu_torch as rt
import ray_tpu_torch.util.fault_injector as tfi
from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeSpec
from ray_tpu_torch.core.config import GlobalConfig
from ray_tpu_torch.providers.gce_gpu import GceGpuNodeProvider
from ray_tpu_torch.runtime import instance_manager as im
from ray_tpu_torch.runtime.cluster_backend import start_head, start_node
from ray_tpu_torch.runtime.protocol import RpcClient, RpcError
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)

MACHINE = "a3-highgpu-1g"
BUNDLE = {"GPU": 1, "GPU-H100": 1}
INSTANCES = ("https://compute.googleapis.com/compute/v1/projects/proj/"
             "zones/us-central1-a/instances")


class FakeCompute:
    """Compute Engine's instance collection in memory: an insert adds a
    RUNNING instance, a DELETE drops it, GETs read them."""

    def __init__(self):
        self.requests = []
        self.instances = {}
        self._lock = threading.Lock()

    def request(self, method, url, body=None):
        name = url.split("/instances", 1)[1].split("?")[0].lstrip("/")
        with self._lock:
            self.requests.append((method, url, body))
            if method == "POST":
                self.instances[body["name"]] = {
                    "name": body["name"], "status": "RUNNING",
                    "labels": dict(body["labels"])}
                return {"kind": "compute#operation"}
            if method == "DELETE":
                self.instances.pop(name, None)
                return {"kind": "compute#operation"}
            if name:
                return dict(self.instances[name])
            return {"items": [dict(i) for i in self.instances.values()]}

    def calls(self, method):
        with self._lock:
            return [r for r in self.requests if r[0] == method]


def _wait(predicate, timeout, desc, period=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        val = predicate()
        if val:
            return val
        time.sleep(period)
    raise AssertionError(f"timed out waiting for {desc}")


def _provider(address, session, fake):
    return GceGpuNodeProvider(
        project="proj", zone="us-central1-a", machine_type=MACHINE,
        image="projects/proj/global/images/h100", head_addr=address,
        session=session, http=fake)


@pytest.fixture
def head():
    """A head: -> (address, session, probe)."""
    session = os.urandom(4).hex()
    head_proc, address = start_head(session)
    probe = RpcClient(address, name="gce-test")

    def up():
        try:
            probe.call("list_nodes", timeout=5)
            return True
        except RpcError:
            return False
    try:
        _wait(up, 30, "the head")
        yield address, session, probe
    finally:
        probe.close()
        head_proc.terminate()
        try:
            head_proc.wait(timeout=10)
        except Exception:
            head_proc.kill()


def _stop(proc):
    if proc is None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except Exception:
        proc.kill()


def test_a3_scale_up_and_drain(head):
    address, session, probe = head
    static_node = start_node(address, session,
                             resources={"CPU": 1.0, "GPU": 0.0})
    _wait(lambda: any(n["alive"] for n in probe.call("list_nodes",
                                                     timeout=5)),
          30, "the static node")
    fake = FakeCompute()
    provider = _provider(address, session, fake)
    shape = GceGpuNodeProvider.node_type(MACHINE, cpus=1)
    scaler = Autoscaler(address, provider, node_type=shape, max_workers=1,
                        idle_timeout_s=2.0, poll_period_s=0.3).start()
    joined = None
    try:
        rt.init(address=address,
                _system_config={"infeasible_grace_s": 60.0})
        pg = placement_group([dict(BUNDLE)], strategy="STRICT_PACK")
        # the pending bundle -> exactly one insert
        _wait(lambda: fake.calls("POST"), 20, "the insert")
        ((_, url, body),) = fake.calls("POST")
        assert url == INSTANCES
        assert body["machineType"] == \
            f"zones/us-central1-a/machineTypes/{MACHINE}"
        (script,) = [i["value"] for i in body["metadata"]["items"]
                     if i["key"] == "startup-script"]
        assert address in script and session in script
        # capped at max_workers: no second insert while it is pending
        time.sleep(1.0)
        assert len(fake.calls("POST")) == 1
        ((_, handle),) = _wait(lambda: scaler._handles, 10, "the handle")
        node_id = handle.rtpu_node_id
        assert body["name"] == f"rtpt-{node_id[:12]}"
        assert body["labels"] == {"rtpt-session": session,
                                  "rtpt-node-id": node_id}

        # the VM boots: a local daemon under the provisioned identity,
        # with the shape the VM's daemon would detect
        joined = start_node(address, session, resources=shape,
                            node_id=node_id)
        assert pg.wait(30), "the bundle never placed on the joined node"
        assert pg.bundle_node(0) == node_id
        remove_placement_group(pg)

        # idle past the timeout -> the instance is deleted through the API
        _wait(lambda: all(r.state == im.TERMINATED
                          for r in scaler.im.records()), 30, "the drain")
        deletes = fake.calls("DELETE")
        assert [d[1] for d in deletes] == [f"{INSTANCES}/{body['name']}"]
        assert handle.name == deletes[0][1]
        assert provider.list_live() == {}
        assert len(fake.calls("POST")) == 1
    finally:
        rt.shutdown()
        scaler.stop()
        _stop(joined)
        _stop(static_node)


def test_restart_terminates_the_orphaned_instance(head):
    address, session, probe = head
    fake = FakeCompute()
    shape = GceGpuNodeProvider.node_type(MACHINE, cpus=1)
    first = Autoscaler(
        address, _provider(address, session, fake),
        node_types={"a3": NodeTypeSpec(shape, max_workers=1,
                                       min_workers=1)})
    # the first autoscaler dies right after the insert, before the launch
    # is ALLOCATED (with the instance's name) in its record
    tfi.configure("autoscaler.post_create=raise*1")
    try:
        with pytest.raises(tfi.FaultInjected):
            first._reconcile_once()
    finally:
        tfi.reset()
        first.head.close()
    ((_, _, body),) = fake.calls("POST")
    node_id = body["labels"]["rtpt-node-id"]
    name = f"{INSTANCES}/{body['name']}"
    assert _provider(address, session, fake).list_live() == \
        {node_id: {"name": name}}
    (key,) = probe.call("kv_keys", {"prefix": im.KV_PREFIX}, timeout=5)
    rec = probe.call("kv_get", {"key": key}, timeout=5)
    assert (rec["node_id"], rec["state"]) == (node_id, im.REQUESTED)
    assert not rec.get("metadata")

    old_grace = GlobalConfig.instance_orphan_grace_s
    GlobalConfig.apply({"instance_orphan_grace_s": 0.5})
    second = None
    try:
        time.sleep(0.6)  # age the record past the grace
        lists = len([r for r in fake.calls("GET") if r[1] == INSTANCES])
        second = Autoscaler(
            address, _provider(address, session, fake),
            node_types={"a3": NodeTypeSpec(shape, max_workers=1)},
            poll_period_s=0.2).start()
        _wait(lambda: probe.call("kv_keys", {"prefix": im.KV_PREFIX},
                                 timeout=5) == [], 20, "the orphan's release")
        deletes = fake.calls("DELETE")
        assert [d[1] for d in deletes] == [name]
        # the restart read the provider's ledger
        assert len([r for r in fake.calls("GET")
                    if r[1] == INSTANCES]) > lists
        chain = [e for e in probe.call("events_dump", {}, timeout=10)
                 if e.get("node_id") == node_id
                 and e["type"].startswith("instance_")]
        assert [e["type"] for e in chain] == [
            "instance_requested", "instance_terminated"], chain
        assert chain[-1].get("detail") == "orphaned-launch"
        assert _provider(address, session, fake).list_live() == {}
        assert len(fake.calls("POST")) == 1
    finally:
        GlobalConfig.apply({"instance_orphan_grace_s": old_grace})
        if second is not None:
            second.stop()
