"""The port's cluster-wide sampling profiler plane against ray_tpu's.

Units (both packages' ``util/stack_profiler.py``, the same program, the
values the JAX test asserts, and one table of stacks compared across the
packages): collapsed-stack folding, bounded-table overflow with exact drop
counts, self/cum frame attribution, speedscope export, the head-side
ProfileStore. The burst capture of a busy thread depends on timing and
runs on the port only.

E2E (the port only; these depend on timing, and the JAX package's run in
``tests/test_stack_profiler.py``): a two-node cluster where continuous
profiles from the head, both node daemons, workers and the driver land in
the head's store tagged with node and worker; the ``profile`` CLI; and
``profiles_record`` bursts cluster-wide.

One deliberate difference, pinned here: the port's continuous sampler is
off unless ``_system_config={"profile_enabled": True}`` (nothing in the
port reads the profiles yet, and its cost on a serving worker is not
measured), where the JAX package's is on; the e2e fixture turns it on.
"""

import importlib
import io
import json
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout

import pytest

from ray_tpu_torch.util import stack_profiler as port_sp

MiB = 1 << 20
PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def sp(request):
    return importlib.import_module(f"{request.param}.util.stack_profiler")


# ----------------------------------------------------------------- lints

def test_profiler_imports_without_jax_or_torch():
    code = (
        "import sys; from ray_tpu_torch.util import stack_profiler as sp; "
        "e = sp.burst_capture(0.05, hz=50); "
        "assert e['samples'] >= 0, e; "
        "p = sp.StackProfiler(hz=50); p.start(); p.stop(); "
        "print(sorted(m for m in ('jax', 'torch', 'ray_tpu') "
        "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sampler_is_off_by_default_in_the_port():
    from ray_tpu.core.config import _CONFIG_DEFS as jax_defaults
    from ray_tpu_torch.core.config import _CONFIG_DEFS as port_defaults
    assert port_defaults["profile_enabled"][1] is False
    assert jax_defaults["profile_enabled"][1] is True


# ----------------------------------------------------------------- units

def test_folded_tables_equal_across_packages():
    """Six threads parked in six functions, sampled by each package's
    ``_sample_once`` into a table of 4: the same stacks, counts and
    drops."""
    release = threading.Event()
    ns = {}
    parked = []
    for i in range(6):
        exec(f"def park_{i}(ev):\n    ev.wait()\n", ns)
        t = threading.Thread(target=ns[f"park_{i}"], args=(release,),
                             daemon=True)
        t.start()
        parked.append(t)
    try:
        time.sleep(0.1)
        ours = {t.ident for t in parked}
        skip = frozenset(tid for tid in sys._current_frames()
                         if tid not in ours)
        got = {}
        for pkg in PACKAGES:
            spm = importlib.import_module(f"{pkg}.util.stack_profiler")
            table = {}
            passes = [spm._sample_once(table, 6, skip) for _ in range(2)]
            # the sampling loop's own frames differ by package; the parked
            # threads' leaves do not
            got[pkg] = (passes, sorted(
                (s.split(";")[-1], n) for s, n in table.items()))
        assert got["ray_tpu"] == got["ray_tpu_torch"]
        assert got["ray_tpu_torch"][0] == [(6, 0), (6, 0)]
    finally:
        release.set()
        for t in parked:
            t.join(timeout=5)
            assert not t.is_alive()


def test_fold_frame_root_first(sp):
    """Collapsed stacks are root-first mod.fn:line joined by ';' —
    the flamegraph.pl contract."""
    marker = {}

    def inner():
        marker["folded"] = sp._fold_frame(sys._getframe())

    def outer():
        inner()

    outer()
    folded = marker["folded"]
    frames = folded.split(";")
    mod = __name__  # tests.test_stack_profiler
    i_outer = next(i for i, f in enumerate(frames)
                   if f.startswith(f"{mod}.outer:"))
    i_inner = next(i for i, f in enumerate(frames)
                   if f.startswith(f"{mod}.inner:"))
    assert i_outer < i_inner  # root-first: caller before callee
    assert frames[-1].startswith(f"{mod}.inner:")  # leaf is last
    for f in frames:
        name, _, line = f.rpartition(":")
        assert name and line.isdigit(), f


def _park(fn_event):
    fn_event.wait()


def test_table_overflow_drop_counts_exact(sp):
    """A full fold table drops samples on UNSEEN stacks and counts every
    drop exactly, so the profile's denominator stays honest."""
    release = threading.Event()

    # six threads parked in six distinct functions -> six distinct stacks
    parked = []
    ns = {}
    for i in range(6):
        exec(f"def park_{i}(ev):\n    ev.wait()\n", ns)  # distinct frames
        t = threading.Thread(target=ns[f"park_{i}"], args=(release,),
                             daemon=True)
        t.start()
        parked.append(t)
    try:
        time.sleep(0.1)  # let all six reach the wait
        ours = {t.ident for t in parked}
        # sample ONLY the six parked threads: skip every other live
        # thread (pytest main, any runtime background threads)
        skip = frozenset(tid for tid in sys._current_frames()
                         if tid not in ours)
        table = {}
        taken, dropped = sp._sample_once(table, 4, skip)
        assert taken == 6
        assert len(table) == 4
        assert dropped == 2  # exactly the two that didn't fit
        # second pass: the 4 resident stacks increment, same 2 drop again
        taken2, dropped2 = sp._sample_once(table, 4, skip)
        assert taken2 == 6 and dropped2 == 2
        assert sorted(table.values()) == [2, 2, 2, 2]
    finally:
        release.set()
        for t in parked:
            t.join(timeout=5)


def test_continuous_profiler_export_drains_atomically(sp):
    p = sp.StackProfiler(hz=100.0)
    p.start()
    try:
        time.sleep(0.4)
        first = p.export()
        assert first is not None and first["samples"] > 0
        assert sum(first["stacks"].values()) + first["dropped"] \
            == first["samples"]
        # the drain reset the window: an immediate re-export is empty-ish
        again = p.export()
        assert again is None or again["samples"] < first["samples"]
    finally:
        p.stop()
    assert not p.running


def test_top_frames_self_cum_recursion_dedup(sp):
    stacks = {"a;b;c": 3, "a;b": 2, "a;a;a": 5}
    rows = {r["frame"]: r for r in sp.top_frames(stacks, 0)}
    assert rows["c"]["self"] == 3 and rows["c"]["cum"] == 3
    assert rows["b"]["self"] == 2 and rows["b"]["cum"] == 5
    # recursion: 'a' appears 3x in one stack but its 5 samples count ONCE
    assert rows["a"]["self"] == 5 and rows["a"]["cum"] == 10
    # sorted by self desc
    ordered = sp.top_frames(stacks, 2)
    assert [r["frame"] for r in ordered] == ["a", "c"]


def test_speedscope_export_schema(sp):
    stacks = {"m.f:1;m.g:2": 4, "m.f:1": 6}
    ss = sp.to_speedscope(stacks, name="unit")
    assert ss["$schema"] == \
        "https://www.speedscope.app/file-format-schema.json"
    frames = ss["shared"]["frames"]
    prof = ss["profiles"][0]
    assert prof["type"] == "sampled" and prof["name"] == "unit"
    assert prof["endValue"] == sum(prof["weights"]) == 10
    assert len(prof["samples"]) == len(prof["weights"]) == 2
    for row in prof["samples"]:
        assert all(0 <= ix < len(frames) for ix in row)
    # frame interning: m.f:1 appears in both stacks but is stored once
    assert sum(1 for f in frames if f["name"] == "m.f:1") == 1
    json.dumps(ss)  # must be JSON-serializable as-is


def test_profile_store_rings_filters_and_lru(sp):
    store = sp.ProfileStore(ring=2, max_procs=4)
    mk = lambda n: {"stacks": {"a;b": n}, "samples": n, "dropped": 0,
                    "window_s": 1.0, "pid": 1, "ts": time.time()}
    # ring: three ingests for one proc keep only the last two windows
    for n in (1, 2, 4):
        store.ingest("w1", mk(n), role="worker", node="nodeA",
                     worker="w1")
    d = store.dump(worker="w1")
    assert len(d["procs"]) == 1
    assert d["procs"][0]["samples"] == 6  # 2 + 4; the 1-window evicted
    assert d["procs"][0]["stacks"] == {"a;b": 6}  # merge-on-read
    # filters: role / node substring match
    store.ingest("node:nodeB", mk(8), role="node", node="nodeB")
    assert len(store.dump()["procs"]) == 2
    assert [p["key"] for p in store.dump(role="node")["procs"]] \
        == ["node:nodeB"]
    assert store.dump(node="nodeA")["procs"][0]["key"] == "w1"
    assert store.dump(worker="zzz")["procs"] == []
    # LRU: a 5th proc evicts the least-recently-ingested (w1)
    store.ingest("w2", mk(1), role="worker")
    store.ingest("w3", mk(1), role="worker")
    store.ingest("w4", mk(1), role="worker")
    keys = {p["key"] for p in store.dump()["procs"]}
    assert len(keys) == 4 and "w1" not in keys
    # top truncation keeps the heaviest stacks
    store.ingest("w9", {"stacks": {"x": 9, "y": 1, "z": 5},
                        "samples": 15, "dropped": 0, "window_s": 1.0,
                        "pid": 2, "ts": time.time()})
    p = store.dump(worker="w9", top=2)["procs"][0]
    assert set(p["stacks"]) == {"x", "z"}


def test_burst_capture_sees_busy_thread():
    """The port only (timing). Burst mode must attribute a synthetic busy
    loop to its function, and samples == sum(stack counts) + dropped (no
    sample unaccounted)."""
    stop = threading.Event()

    def spin_hot():
        while not stop.is_set():
            sum(i * i for i in range(500))

    t = threading.Thread(target=spin_hot, daemon=True, name="spin-hot")
    t.start()
    try:
        e = port_sp.burst_capture(0.5, hz=199.0)
    finally:
        stop.set()
        t.join(timeout=5)
    assert e["burst"] is True and e["samples"] > 0
    assert sum(e["stacks"].values()) + e["dropped"] == e["samples"]
    assert 0.3 <= e["window_s"] <= 2.0
    hot = [s for s in e["stacks"] if "spin_hot" in s]
    assert hot, list(e["stacks"])[:5]
    # the busy thread is caught on (nearly) every sampling pass: its
    # stacks' combined count rivals the most-sampled parked thread.
    # (Do NOT assert top-N membership — leftover daemon threads from
    # earlier test modules park on a single line and each earn a full
    # per-pass count, while spin_hot's samples spread over several
    # line numbers, so rank alone is order-of-collection fragile.)
    hot_total = sum(e["stacks"][s] for s in hot)
    assert hot_total >= 0.5 * max(e["stacks"].values()), (
        hot_total, sorted(e["stacks"].items(), key=lambda kv: -kv[1])[:5])
    # and top_frames over only the busy thread's stacks names the loop
    top = port_sp.top_frames({s: e["stacks"][s] for s in hot}, 3)
    assert any("spin_hot" in r["frame"] or "<genexpr>" in r["frame"]
               for r in top), top


# ------------------------------------------------------------------- e2e

@pytest.fixture(scope="module")
def two_node_profiled():
    import ray_tpu_torch as rt
    # the port's sampler is off unless asked (pinned above)
    rt.init(num_cpus=1, _system_config={
        "object_store_memory_bytes": 64 * MiB,
        "metrics_export_period_s": 0.2,
        "hw_sampler_period_s": 0.5,
        "profile_enabled": True,
    })
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.runtime.cluster_backend import start_node
    backend = global_worker.backend
    session = backend.head.call("connect_driver", {})["session"]
    proc = start_node(backend.head_addr, session,
                      resources={"CPU": 1.0, "n2": 1.0})
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"second node exited rc={proc.returncode}")
        nodes = backend.head.call("list_nodes")
        if sum(1 for n in nodes if n["alive"]) >= 2:
            break
        time.sleep(0.2)
    else:
        raise RuntimeError("second node never registered")
    yield rt, backend
    proc.terminate()
    try:
        proc.wait(timeout=10)
    finally:
        rt.shutdown()


def _spin_workers(rt_, seconds=1.5):
    """Busy-loop one worker on each node so their profiles have heat."""
    @rt_.remote(num_cpus=1)
    def burn(s):
        t0 = time.monotonic()
        while time.monotonic() - t0 < s:
            sum(i * i for i in range(2000))
        return True

    return [burn.remote(seconds),
            burn.options(resources={"n2": 0.001}).remote(seconds)]


def test_profiles_aggregate_at_head_with_identity(two_node_profiled):
    """Continuous profiles from every role land in the head store tagged
    with node/worker ids; node filters narrow the dump (acceptance:
    head aggregation tags frames with node/worker ids, two nodes)."""
    rt_, backend = two_node_profiled
    head = backend.head
    refs = _spin_workers(rt_)
    assert all(rt_.get(refs, timeout=60))

    by_role, d = {}, {}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        d = head.call("profiles_dump", {}, timeout=10)
        by_role = {}
        for p in d["procs"]:
            by_role.setdefault(p["role"], []).append(p)
        if {"head", "node", "worker", "driver"} <= set(by_role):
            break
        time.sleep(0.3)
    assert {"head", "node", "worker", "driver"} <= set(by_role), \
        {r: len(v) for r, v in by_role.items()}

    # two node daemons, each tagged with its own node id
    node_ids = {p["node"] for p in by_role["node"]}
    assert len(by_role["node"]) >= 2 and len(node_ids) >= 2, by_role["node"]
    # workers are tagged with BOTH a worker id and the node they ran on
    for p in by_role["worker"]:
        assert p["worker"] and p["node"], p
    # every proc carries real samples and a nonzero aggregated window
    for p in d["procs"]:
        assert p["samples"] > 0 and p["stacks"], p["key"]
    # a node filter narrows to that node's procs only
    some_node = sorted(node_ids)[0]
    narrowed = head.call("profiles_dump", {"node": some_node}, timeout=10)
    assert narrowed["procs"]
    assert all(p["node"] == some_node for p in narrowed["procs"])
    # the head's own profile contains head-process frames (the head runs
    # as `python -m ray_tpu_torch.runtime.head`, so its module folds as
    # __main__; an in-process Head folds as ray_tpu_torch.runtime.head)
    head_stacks = port_sp.merge_stacks(
        [p["stacks"] for p in by_role["head"]])
    assert any("__main__" in s or "runtime.head" in s
               for s in head_stacks), list(head_stacks)[:3]


def test_profiles_record_burst_fans_out(two_node_profiled):
    """profiles_record bursts head + both node daemons (+ any live
    workers) at a caller-chosen rate and returns fresh captures."""
    rt_, backend = two_node_profiled
    refs = _spin_workers(rt_, seconds=3.0)
    d = backend.head.call(
        "profiles_record", {"seconds": 1.0, "hz": 150.0}, timeout=40)
    assert all(rt_.get(refs, timeout=60))
    roles = {}
    for p in d["procs"]:
        roles.setdefault(p["role"], []).append(p)
    assert "head" in roles and len(roles.get("node", [])) >= 2, \
        {r: len(v) for r, v in roles.items()}
    for p in d["procs"]:
        assert p["samples"] > 0, p["key"]
    # role filter: head only
    d2 = backend.head.call(
        "profiles_record", {"seconds": 0.3, "hz": 99.0, "role": "head"},
        timeout=30)
    assert {p["role"] for p in d2["procs"]} == {"head"}


def test_profile_cli_smoke(two_node_profiled):
    """`ray_tpu_torch profile` renders the top-frames table; --flame emits
    collapsed lines; --speedscope - emits schema-valid JSON."""
    from ray_tpu_torch.scripts import cli

    rt_, backend = two_node_profiled
    address = backend.head_addr
    refs = _spin_workers(rt_, seconds=1.0)
    assert all(rt_.get(refs, timeout=60))
    time.sleep(1.0)  # one more flush so the dump is non-empty

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["profile", "--address", address]) == 0
    out = buf.getvalue()
    assert "process(es)" in out and "[continuous]" in out
    assert "self" in out and "cum" in out and "frame" in out
    assert "node=" in out  # per-proc identity lines

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["profile", "--flame",
                         "--address", address]) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert lines
    for ln in lines[:20]:
        stack, _, count = ln.rpartition(" ")
        assert stack and ";" in stack or stack, ln
        assert count.isdigit(), ln

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["profile", "--speedscope", "-",
                         "--address", address]) == 0
    ss = json.loads(buf.getvalue())
    assert ss["$schema"] == \
        "https://www.speedscope.app/file-format-schema.json"
    assert ss["shared"]["frames"] and ss["profiles"]
    prof = ss["profiles"][0]
    assert {"type", "name", "unit", "startValue", "endValue", "samples",
            "weights"} <= set(prof)
    assert prof["endValue"] == sum(prof["weights"]) > 0

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["profile", "--record", "0.5", "--hz", "150",
                         "--head", "--address", address]) == 0
    out = buf.getvalue()
    assert "burst" in out and "process(es)" in out

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["profile", "--format", "json",
                         "--address", address]) == 0
    data = json.loads(buf.getvalue())
    assert data["procs"]
