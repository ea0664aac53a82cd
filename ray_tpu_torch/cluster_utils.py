"""Multi-node-on-one-machine test harness.

Role-equivalent to the reference's `ray.cluster_utils.Cluster` (reference:
python/ray/cluster_utils.py:135, add_node at :202) — the single
highest-leverage piece of the reference's test infra (SURVEY.md §4 item 3):
boots N node daemons as separate OS processes on one machine, each with its
own shm store and worker pool, all registered to one head, so distributed
protocols (cross-node object transfer, node death, scheduling spillover)
are exercised for real without a real cluster.

The port of ``ray_tpu/cluster_utils.py``. A node added here advertises the
cards its ``resources`` name, and none otherwise: a node daemon left to
count them would find every card of the machine, so on a one-card
machine two added nodes would each advertise ``GPU: 1`` for the same card
and hand it to two workers at once. (The JAX package's nodes find no TPU
on such a machine, which this matches.)
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core import config as config_mod
from ray_tpu_torch.runtime.cluster_backend import start_head, start_node
from ray_tpu_torch.runtime.protocol import RpcClient, RpcError


class NodeHandle:
    def __init__(self, proc: subprocess.Popen, node_id: str):
        self.proc = proc
        self.node_id = node_id


class Cluster:
    """Boot a head + N node-daemon processes on this machine."""

    def __init__(self, session: Optional[str] = None):
        import os
        self.session = session or os.urandom(4).hex()
        self.head_proc, self.address = start_head(self.session)
        self._probe = RpcClient(self.address, name="cluster-probe")
        self.nodes: List[NodeHandle] = []

    def add_node(self, num_cpus: float = 1,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_bytes: int = 64 * 1024 * 1024,
                 wait: bool = True) -> NodeHandle:
        merged = {"CPU": float(num_cpus), "GPU": 0.0, **(resources or {})}
        known = {n["node_id"] for n in self._list_nodes()}
        proc = start_node(self.address, self.session, resources=merged,
                          object_store_bytes=object_store_bytes)
        node_id = ""
        if wait:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"node exited rc={proc.returncode} during startup")
                fresh = [n for n in self._list_nodes()
                         if n["node_id"] not in known and n["alive"]]
                if fresh:
                    node_id = fresh[0]["node_id"]
                    break
                time.sleep(0.05)
            else:
                raise RuntimeError("node never registered")
        handle = NodeHandle(proc, node_id)
        self.nodes.append(handle)
        return handle

    def _list_nodes(self) -> list:
        try:
            return self._probe.call("list_nodes")
        except RpcError:
            return []

    def remove_node(self, node: NodeHandle, graceful: bool = False) -> None:
        """Kill a node daemon (ungraceful by default — simulates node
        failure; the head's health checker must notice)."""
        if graceful:
            node.proc.terminate()
        else:
            node.proc.kill()
        node.proc.wait(timeout=10)
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, n: int, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if sum(1 for x in self._list_nodes() if x["alive"]) >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(f"cluster never reached {n} alive nodes")

    def shutdown(self) -> None:
        self._probe.close()
        for node in self.nodes:
            try:
                node.proc.terminate()
            except OSError:
                pass
        for node in self.nodes:
            try:
                node.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                node.proc.kill()
        self.nodes.clear()
        try:
            self.head_proc.terminate()
            self.head_proc.wait(timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            self.head_proc.kill()
