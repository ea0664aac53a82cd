"""The port's object-plane accounting and cluster event journal against
ray_tpu's, end to end.

Each program of ``tests/test_memory_events.py`` runs on a two-node
cluster of each package (the JAX package's with the cyclic collector
paused) and must give what the JAX test asserts:
  - a put/pull/spill workload whose ``memory`` totals (the head's
    directory, and the CLI's) equal each node's ShmStore counters exactly,
    bytes and counts, with primaries, secondaries and spills, the spill in
    the journal and its sequence numbers ordered;
  - a SIGKILLed actor worker whose ``worker_death`` (with its exit cause)
    precedes the ``actor_restarting`` it causes, under one trace id.
The directory's rows and the journal's records are compared field by
field across the packages.
"""

import gc
import importlib
import io
import json
import os
import signal
import time
from contextlib import redirect_stdout

import pytest

MiB = 1 << 20
PACKAGES = ["ray_tpu", "ray_tpu_torch"]
#: each program's fields, by program and package
SEEN = {}


def sub(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def agree(program, pkg, value):
    """Keep ``value`` for (program, package); once both packages ran the
    program, their values must be equal."""
    SEEN.setdefault(program, {})[pkg] = value
    if len(SEEN[program]) == len(PACKAGES):
        assert SEEN[program]["ray_tpu"] == SEEN[program]["ray_tpu_torch"]


@pytest.fixture(scope="module", params=PACKAGES)
def two_node(request):
    pkg = request.param
    rt = importlib.import_module(pkg)
    if pkg == "ray_tpu":
        gc.disable()
    rt.init(num_cpus=1, _system_config={
        "object_store_memory_bytes": 16 * MiB,
        "metrics_export_period_s": 0.2,
    })
    backend = sub(pkg, "core.worker").global_worker.backend
    start_node = sub(pkg, "runtime.cluster_backend").start_node
    session = backend.head.call("connect_driver", {})["session"]
    proc = start_node(backend.head_addr, session,
                      resources={"CPU": 1.0, "n2": 1.0})
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"second node exited rc={proc.returncode}")
            nodes = backend.head.call("list_nodes")
            if sum(1 for n in nodes if n["alive"]) >= 2:
                break
            time.sleep(0.2)
        else:
            raise RuntimeError("second node never registered")
        yield rt, backend
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        finally:
            rt.shutdown()
            gc.enable()
            gc.collect()


def test_memory_totals_match_store_ground_truth(two_node):
    """Drive put (primaries on node 1), cross-node get (a secondary on
    node 1) and arena-overflow task returns (primaries + spills on node
    2), then require the head's aggregated directory totals to equal
    each node's ShmStore counters exactly."""
    rt_, backend = two_node
    pkg = rt_.__name__
    RpcClient = sub(pkg, "runtime.protocol").RpcClient
    cli = sub(pkg, "scripts.cli")
    head = backend.head

    @rt_.remote(resources={"n2": 0.001})
    def make_blob(i):
        return bytes([i % 251]) * MiB

    # 3 driver puts -> primaries in node 1's arena (1 MiB >> the 100KiB
    # inline cutoff, so every object is shm-sealed and directory-tracked)
    keep = [rt_.put(b"p" * MiB) for _ in range(3)]
    # 18 pinned 1 MiB results on node 2's 16 MiB arena -> spill pressure
    results = [make_blob.remote(i) for i in range(18)]
    done, _ = rt_.wait(results, num_returns=len(results), timeout=180)
    assert len(done) == len(results)
    # pull one result across nodes -> a secondary copy in node 1's arena
    first = rt_.get(results[0], timeout=120)
    assert len(first) == MiB

    nodes = [n for n in head.call("list_nodes") if n["alive"]]
    assert len(nodes) == 2
    probes = {n["node_id"]: RpcClient(n["address"], name="acct-probe")
              for n in nodes}
    # expected directory population once every owner has flushed:
    # 3 puts + 1 pulled secondary (node 1) + 18 task results (node 2,
    # spilled ones included — they stay tracked, just not arena-resident)
    expect_rows = 3 + 1 + len(results)

    od, last = {}, None
    deadline = time.monotonic() + 90
    try:
        while time.monotonic() < deadline:
            od = head.call("objects_dump", timeout=10)
            totals = od.get("totals", {})
            tracked = sum(t.get("count", 0) for node_t in totals.values()
                          for t in node_t.values())
            ok, last = tracked == expect_rows, [("tracked", tracked)]
            for nid, c in probes.items():
                st = c.call("store_stats", timeout=10)
                t = totals.get(nid, {})
                arena = sum(t.get(r, {}).get("arena_bytes", 0)
                            for r in ("primary", "secondary"))
                count = sum(t.get(r, {}).get("count", 0)
                            for r in ("primary", "secondary"))
                last.append((nid[:8], arena, st["bytes_used"],
                             count, st["num_objects"]))
                ok &= arena == st["bytes_used"] \
                    and count == st["num_objects"]
            if ok:
                break
            time.sleep(0.3)
        else:
            raise AssertionError(
                f"accounting never matched store ground truth: {last}")

        # the CLI sees the same aggregation (the `memory` command's
        # totals are the thing that must match, not just the RPC)
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(["memory", "--format", "json",
                             "--address", backend.head_addr]) == 0
        via_cli = json.loads(buf.getvalue())
        for nid, c in probes.items():
            st = c.call("store_stats", timeout=10)
            t = via_cli["totals"].get(nid, {})
            assert sum(t.get(r, {}).get("arena_bytes", 0)
                       for r in ("primary", "secondary")) \
                == st["bytes_used"], (nid, t, st)
            assert sum(t.get(r, {}).get("count", 0)
                       for r in ("primary", "secondary")) \
                == st["num_objects"], (nid, t, st)

        roles = {r["role"] for r in od["rows"]}
        assert {"primary", "secondary", "spilled"} <= roles, roles
        spilled = sum(t.get("spilled", {}).get("count", 0)
                      for t in od["totals"].values())
        assert spilled >= 1, "16 MiB arena under 18 MiB pinned: must spill"

        # the overflow made it into the journal (worker-originated,
        # sequenced at head arrival), and seqs are strictly ordered
        evs = head.call("events_dump", timeout=10)
        spill_evs = [e for e in evs if e["type"] == "spill_overflow"]
        assert spill_evs and all(e["bytes"] > 0 for e in spill_evs)
        assert len([e for e in evs if e["type"] == "node_register"]) >= 2
        seqs = [e["seq"] for e in evs]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        # the directory's shape, row for row, equal across the packages
        agree("memory", pkg, (
            expect_rows, sorted(roles), sorted(od["totals"]) == sorted(
                probes), sorted({k for r in od["rows"] for k in r}),
            sorted(via_cli["totals"]) == sorted(probes)))
    finally:
        for c in probes.values():
            c.close()
        del keep, results, first


def test_worker_death_journal_ordering(two_node):
    """SIGKILL an actor's worker: the journal must record worker_death
    (with the exit cause) BEFORE the actor_restarting it triggers, both
    stamped with the same trace id."""
    rt_, backend = two_node
    head = backend.head

    @rt_.remote(max_restarts=1)
    class Phoenix:
        def pid(self):
            return os.getpid()

    a = Phoenix.remote()
    pid1 = rt_.get(a.pid.remote(), timeout=60)
    os.kill(pid1, signal.SIGKILL)

    wd = ar = None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        evs = head.call("events_dump", timeout=10)
        wds = [e for e in evs if e["type"] == "worker_death"]
        ars = [e for e in evs if e["type"] == "actor_restarting"]
        if wds and ars:
            wd, ar = wds[-1], ars[-1]
            break
        time.sleep(0.2)
    assert wd and ar, "journal never saw the death -> restart pair"
    assert "exit code" in wd["exit_cause"] or "oom" in wd["exit_cause"]
    assert wd["trace_id"] and wd["trace_id"] == ar["trace_id"], \
        "death and restart must share one trace id"
    assert wd["seq"] < ar["seq"], "causal order: death before restart"

    # the restarted incarnation serves again from a new process
    pid2 = None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            pid2 = rt_.get(a.pid.remote(), timeout=15)
            break
        except rt_.exceptions.ActorError:
            time.sleep(0.2)
    assert pid2 is not None and pid2 != pid1
    agree("death -> restart", rt_.__name__, (
        wd["type"], ar["type"], sorted(k for k in wd if k != "seq"),
        wd["exit_cause"].split(" ")[0]))
