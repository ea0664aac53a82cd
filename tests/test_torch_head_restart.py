"""The port's head (GCS) restart recovery beyond KV, held to
``tests/test_head_restart.py``'s assertions: after a hard head kill and a
restart on the same address with the same persist path, the node daemon
re-registers (carrying its live actor and in-use resources), the named
actor resolves with its state, fresh tasks run, and a lease granted by the
old head is released through the new one. These results depend on timing,
so only the port's program runs here; the JAX package's runs in its own
file.
"""

import os
import signal
import time

import ray_tpu_torch
from ray_tpu_torch.runtime.cluster_backend import start_head, start_node
from ray_tpu_torch.runtime.protocol import RpcClient, RpcError


def _wait_alive_nodes(addr, n, timeout=30.0):
    c = RpcClient(addr, name="probe")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if sum(x["alive"] for x in c.call("list_nodes", timeout=2)) >= n:
                c.close()
                return
        except RpcError:
            pass
        time.sleep(0.1)
    c.close()
    raise AssertionError(f"{n} nodes never registered at {addr}")


def test_actor_and_tasks_survive_head_restart(tmp_path):
    persist = str(tmp_path / "gcs.pkl")
    session = "headrestart"
    head_proc, addr = start_head(session, persist_path=persist)
    port = int(addr.rsplit(":", 1)[1])
    node_proc = start_node(addr, session, resources={"CPU": 2.0})
    head_proc2 = None
    try:
        _wait_alive_nodes(addr, 1)
        ray_tpu_torch.init(address=addr)

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        a = Counter.options(name="survivor", lifetime="detached").remote()
        assert ray_tpu_torch.get(a.incr.remote(), timeout=60) == 1

        # hard-kill the head mid-workload
        os.kill(head_proc.pid, signal.SIGKILL)
        head_proc.wait(timeout=10)

        # actor RPC is direct worker-to-worker: it must keep serving even
        # while the control plane is down
        assert ray_tpu_torch.get(a.incr.remote(), timeout=30) == 2

        # restart the head on the SAME address with the same snapshot
        head_proc2, addr2 = start_head(session, port=port,
                                       persist_path=persist)
        assert addr2 == addr
        # the node daemon notices and re-registers (with its live actor)
        _wait_alive_nodes(addr, 1)

        # named-actor lookup through the NEW head resolves to the SAME
        # still-running instance (state preserved: counter continues)
        deadline = time.monotonic() + 30
        while True:
            try:
                b = ray_tpu_torch.get_actor("survivor")
                got = ray_tpu_torch.get(b.incr.remote(), timeout=10)
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        assert got == 3

        # fresh task submission goes through the recovered lease path
        @ray_tpu_torch.remote
        def seven():
            return 7

        assert ray_tpu_torch.get(seven.remote(), timeout=60) == 7
    finally:
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass
        for proc in (node_proc, head_proc2):
            if proc is None:
                continue
            try:
                proc.terminate()
                proc.wait(timeout=5)
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass


def test_recovered_lease_release_frees_resources(tmp_path):
    """A lease granted by the old head is released through the new head
    (keyed by worker when the lease id is unknown) so resources do not
    leak after recovery."""
    persist = str(tmp_path / "gcs2.pkl")
    session = "headrestart2"
    head_proc, addr = start_head(session, persist_path=persist)
    port = int(addr.rsplit(":", 1)[1])
    node_proc = start_node(addr, session, resources={"CPU": 1.0})
    head_proc2 = None
    try:
        _wait_alive_nodes(addr, 1)
        ray_tpu_torch.init(address=addr)

        @ray_tpu_torch.remote
        def hold(t):
            time.sleep(t)
            return os.getpid()

        # occupy the single CPU slot through the old head's lease
        ref = hold.remote(4.0)
        time.sleep(1.0)  # ensure the lease is held and the task is running
        os.kill(head_proc.pid, signal.SIGKILL)
        head_proc.wait(timeout=10)
        head_proc2, _ = start_head(session, port=port, persist_path=persist)
        _wait_alive_nodes(addr, 1)
        # in-flight task completes across the restart
        assert isinstance(ray_tpu_torch.get(ref, timeout=60), int)
        # after release, the CPU slot must be usable again via the new head
        assert ray_tpu_torch.get(hold.remote(0.01), timeout=60) > 0
    finally:
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass
        for proc in (node_proc, head_proc2):
            if proc is None:
                continue
            try:
                proc.terminate()
                proc.wait(timeout=5)
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass


def test_free_port_lies_below_the_ephemeral_range():
    """A head's (and a rank 0's) port is picked in one process and bound in
    another seconds later, and a restarted head binds it again: it comes
    from below the kernel's ephemeral range, which outgoing connections
    and ``bind(0)`` draw from meanwhile, and nothing holds it."""
    import socket

    from ray_tpu_torch.runtime.cluster_backend import _free_port
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    ports = {_free_port() for _ in range(20)}
    assert all(1024 <= p < low for p in ports), (ports, low)
    assert len(ports) > 1
    for p in ports:
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))

