"""The port's cluster-wide structured log plane against ray_tpu's.

Units (both packages, the same program, the values the JAX test asserts,
and the exported records compared field by field): ring overflow with
exact drop accounting, file-sink rotation, the head-side LogStore
(severity rings, cursor, filters, LRU), error fingerprints, storm
detection, the worker tee and shipper, the ambient request id.

Lints (the port): no bare ``print(`` in ``ray_tpu_torch/`` outside
``scripts/cli.py``, and the module imports without jax, torch or the JAX
package (it runs inside the head and node daemons).

E2E on a two-node cluster: task prints under an active trace land in the
head's LogStore stamped with the task's trace id, and request-scoped
records are queryable by request id, in both packages (the records'
fields compared); the overflow ledger, a SIGKILLed worker's tails in its
``worker_death`` record, every role's files and the ``logs`` CLI run on
the port only (they depend on timing; the JAX package's run in
``tests/test_log_plane.py``). The JAX package's cluster runs with the
cyclic collector paused.
"""

import ast
import gc
import importlib
import io
import json
import os
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

MiB = 1 << 20
PACKAGES = ["ray_tpu", "ray_tpu_torch"]
#: the e2e programs' records, by program and package
SEEN = {}


@pytest.fixture(params=PACKAGES)
def lp(request):
    return importlib.import_module(f"{request.param}.util.log_plane")


def sibling(lp, name):
    """The module ``name`` of ``lp``'s package."""
    return importlib.import_module(f"{lp.__name__.split('.')[0]}.{name}")


def agree(program, pkg, value):
    """Keep ``value`` for (program, package); once both packages ran the
    program, their values must be equal."""
    SEEN.setdefault(program, {})[pkg] = value
    if len(SEEN[program]) == len(PACKAGES):
        assert SEEN[program]["ray_tpu"] == SEEN[program]["ray_tpu_torch"]


# ----------------------------------------------------------------- lints

def test_log_plane_imports_without_jax_or_torch():
    code = (
        "import sys; from ray_tpu_torch.util import log_plane as lp; "
        "lg = lp.StructuredLogger(role='t'); "
        "lg.info('hello', k=1); e = lg.export(); "
        "assert e and e['emitted'] == 1, e; "
        "s = lp.LogStore(); s.ingest('t', e); "
        "assert s.dump()['records'], 'store empty'; "
        "print(sorted(m for m in ('jax', 'torch', 'ray_tpu') "
        "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_bare_print_outside_cli():
    """Daemon and runtime diagnostics go through the structured logger
    (or an explicit sys.<stream>.write); the CLI is the one print
    surface."""
    from ray_tpu_torch.util import log_plane
    pkg = os.path.abspath(os.path.join(os.path.dirname(log_plane.__file__),
                                       ".."))
    offenders = []
    for dirpath, _dirnames, filenames in os.walk(pkg):
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, pkg)
            if rel == os.path.join("scripts", "cli.py"):
                continue
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=rel)
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id == "print":
                    offenders.append(f"{rel}:{node.lineno}")
    assert not offenders, ", ".join(offenders)


# ----------------------------------------------------------------- units

def test_exported_records_equal_across_packages():
    """One program of records (levels, fields, a trace and a request
    scope, an overflow) through each package's logger: the exports agree
    field by field, timestamps and pids aside."""
    out = {}
    for pkg in PACKAGES:
        lpm = importlib.import_module(f"{pkg}.util.log_plane")
        tc = importlib.import_module(f"{pkg}.util.trace_context")
        lg = lpm.StructuredLogger(role="worker", node="n1", worker="w1",
                                  ring_size=8)
        tok = tc.activate("a" * 32, "b" * 16)
        try:
            with lpm.request_context("req-x-0"):
                lg.info("in both scopes", step=3)
        finally:
            tc.deactivate(tok)
        for i in range(10):
            lg.log(("debug", "info", "warning", "error", "bogus")[i % 5],
                   f"record {i}", i=i)
        e = lg.export()
        out[pkg] = {"emitted": e["emitted"], "dropped": e["dropped"],
                    "records": [{k: v for k, v in r.items()
                                 if k not in ("ts", "pid")}
                                for r in e["records"]],
                    "lines": [lpm.format_record(dict(r, ts=0.0, pid=1))
                              for r in e["records"]]}
    assert out["ray_tpu"] == out["ray_tpu_torch"]
    assert out["ray_tpu_torch"]["emitted"] == 11
    assert out["ray_tpu_torch"]["dropped"] == 3


def test_ring_overflow_exact_drop_accounting(lp):
    """The acceptance invariant: across any sequence of exports,
    sum(emitted) == sum(stored) + sum(dropped), to the record."""
    lg = lp.StructuredLogger(role="t", ring_size=8)
    for i in range(30):
        lg.info(f"burst {i}")
    e = lg.export()
    assert e["emitted"] == 30
    assert len(e["records"]) == 8
    assert e["dropped"] == 22
    assert e["emitted"] == len(e["records"]) + e["dropped"]
    # drained: an immediate re-export is empty
    assert lg.export() is None
    # multi-window: the invariant holds summed across windows too
    tot_emitted, tot_stored, tot_dropped = 30, 8, 22
    for n in (3, 20, 1):
        for i in range(n):
            lg.warning(f"w{i}")
        e = lg.export()
        tot_emitted += e["emitted"]
        tot_stored += len(e["records"])
        tot_dropped += e["dropped"]
    assert tot_emitted == tot_stored + tot_dropped
    assert lg.stats()["emitted_total"] == tot_emitted
    assert lg.stats()["dropped_total"] == tot_dropped


def test_export_levels_and_stamps(lp):
    lg = lp.StructuredLogger(role="worker", node="n1", worker="w1",
                             ring_size=64)
    tok = None
    trace_context = sibling(lp, "util.trace_context")
    tok = trace_context.activate("t" * 32, "s" * 16)
    try:
        with lp.request_context("req-abc-1"):
            rec = lg.info("hello", foo="bar")
    finally:
        trace_context.deactivate(tok)
    assert rec["level"] == "info" and rec["msg"] == "hello"
    assert rec["role"] == "worker" and rec["node"] == "n1"
    assert rec["worker"] == "w1" and rec["pid"] == os.getpid()
    assert rec["trace_id"] == "t" * 32
    assert rec["request_id"] == "req-abc-1"
    assert rec["fields"] == {"foo": "bar"}
    # outside the scopes: unstamped
    rec2 = lg.info("later")
    assert rec2["trace_id"] == "" and rec2["request_id"] == ""
    # unknown level degrades to info, JSON-serializable as-is
    rec3 = lg.log("nonsense", "x")
    assert rec3["level"] == "info"
    json.dumps(lg.export())


def test_file_sink_rotation(lp, tmp_path):
    path = str(tmp_path / "x.log")
    sink = lp._FileSink(path, max_bytes=4096, backups=2)
    line = "y" * 100
    for _ in range(200):  # ~20 KiB >> 4 KiB cap
        sink.write_line(line)
    sink.close()
    assert os.path.exists(path)
    assert os.path.exists(path + ".1")
    assert os.path.exists(path + ".2")
    assert os.path.getsize(path) <= 4096 + 128
    # rotation preserved whole lines
    with open(path + ".1") as f:
        for ln in f.read().splitlines():
            assert ln == line
    # a dead sink (unwritable dir) swallows, never raises
    bad = lp._FileSink(str(tmp_path / "x.log" / "nope.log"),
                       max_bytes=4096)
    bad.write_line("a")  # open fails -> dead
    bad.write_line("b")
    assert bad._dead


def test_error_fingerprint_normalizes_ids(lp):
    a = lp.error_fingerprint("worker 4f21ab9920ccd110 died rc=137")
    b = lp.error_fingerprint("worker 9ac3004cde1199ff died rc=1")
    assert a == b  # one bug, one fingerprint
    assert a != lp.error_fingerprint("lease rejected for worker 4f21")
    assert len(a) == 12 and all(c in "0123456789abcdef" for c in a)
    assert lp.error_fingerprint("oom at 0xDEADBEEF") == \
        lp.error_fingerprint("oom at 0x1234")


def test_error_storm_one_event_per_excursion(lp):
    lg = lp.StructuredLogger(role="t", ring_size=64,
                             storm_threshold=5, storm_window_s=0.2)
    for i in range(10):
        lg.error(f"boom {i}")
    evs = lg.drain_journal_events()
    assert len(evs) == 1, evs  # one event for the whole excursion
    ev = evs[0]
    assert ev["type"] == "log_error_storm"
    assert ev["errors"] >= 5 and ev["window_s"] == 0.2
    # still storming: no second event
    for i in range(5):
        lg.error(f"boom more {i}")
    assert lg.drain_journal_events() == []
    # recovery re-arms: window empties, then a fresh burst fires again
    time.sleep(0.3)
    lg.error("calm one")  # prunes the window; count < threshold/2
    for i in range(6):
        lg.error(f"boom again {i}")
    evs = lg.drain_journal_events()
    assert len(evs) == 1, evs
    # fingerprints accumulated under the normalized key
    fps = lg.stats()["fingerprints"]
    assert fps[lp.error_fingerprint("boom 1")] >= 10


def test_fingerprint_cap_folds_long_tail(lp):
    lg = lp.StructuredLogger(role="t", ring_size=8, storm_threshold=0)
    for i in range(lp._FINGERPRINT_CAP + 20):
        # non-hex letters (runs of hex chars normalize away), distinct
        # lengths: each message is a DISTINCT fingerprint
        lg.error("unique " + "xyz"[i % 3] * (i + 1))
    fps = lg.stats()["fingerprints"]
    assert len(fps) <= lp._FINGERPRINT_CAP + 1
    assert fps.get("other", 0) > 0  # tail folded, not dropped


def test_log_store_severity_rings_cursor_filters_lru(lp):
    store = lp.LogStore(ring=8, max_procs=4)  # 8 = the floor

    def mk(recs):
        return {"records": recs, "emitted": len(recs), "dropped": 0,
                "pid": 1, "ts": time.time()}

    def rec(level, msg, **kw):
        base = {"ts": time.time(), "level": level, "role": "worker",
                "node": "nodeA", "worker": "w1", "pid": 1,
                "trace_id": "", "request_id": "", "msg": msg,
                "fields": {}}
        base.update(kw)
        return base

    # an early error survives a later debug flood: severity-indexed rings
    store.ingest("w1", mk([rec("error", "the crash")]),
                 role="worker", node="nodeA", worker="w1")
    store.ingest("w1", mk([rec("debug", f"noise {i}") for i in range(20)]),
                 role="worker", node="nodeA", worker="w1")
    d = store.dump(worker="w1")
    msgs = [r["msg"] for r in d["records"]]
    assert "the crash" in msgs
    assert sum(1 for m in msgs if m.startswith("noise")) == 8  # ring=8
    # severity floor
    d = store.dump(level="error")
    assert [r["msg"] for r in d["records"]] == ["the crash"]
    # grep regex on msg
    d = store.dump(grep=r"^the cr\w+$")
    assert [r["msg"] for r in d["records"]] == ["the crash"]
    # cursor: seq is head-assigned and monotonic; after_seq follows
    all_recs = store.dump()["records"]
    seqs = [r["seq"] for r in all_recs]
    assert seqs == sorted(seqs)
    mid = seqs[len(seqs) // 2]
    d = store.dump(after_seq=mid)
    assert all(r["seq"] > mid for r in d["records"])
    assert d["last_seq"] >= seqs[-1]
    # limit keeps the NEWEST n
    d = store.dump(limit=2)
    assert [r["seq"] for r in d["records"]] == seqs[-2:]
    # trace/request correlation filters
    store.ingest("w2", mk([
        rec("info", "traced", trace_id="t" * 32, worker="w2"),
        rec("info", "requested", request_id="req-1-0", worker="w2"),
    ]), role="worker", node="nodeB", worker="w2")
    assert [r["msg"] for r in store.dump(trace="t" * 32)["records"]] \
        == ["traced"]
    assert [r["msg"] for r in store.dump(request="req-1-0")["records"]] \
        == ["requested"]
    # node / role filters (substring, same as profiles_dump)
    assert all(r["msg"] in ("traced", "requested")
               for r in store.dump(node="nodeB")["records"])
    assert store.dump(role="node")["records"] == []
    # drop ledger aggregates per-proc
    store.ingest("w2", {"records": [], "emitted": 7, "dropped": 7,
                        "pid": 1, "ts": time.time()},
                 role="worker", node="nodeB", worker="w2")
    assert store.dump(worker="w2")["dropped_total"] == 7
    # LRU: two more procs overflow max_procs=4 and evict the oldest (w1)
    for k in ("w3", "w4", "w5"):
        store.ingest(k, mk([rec("info", k, worker=k)]),
                     role="worker", worker=k)
    assert store.dump(worker="w1")["records"] == []
    assert store.stats()["procs"] == 4


def test_log_shipper_carries_drops_across_empty_flush(lp):
    """Satellite: drops recorded while the batch was empty must survive
    to the next non-empty flush — the '...N dropped' notice itself must
    never be dropped."""
    wm = sibling(lp, "runtime.worker_main")

    sent = []

    class _Client:
        def oneway(self, method, payload):
            sent.append(payload)

    class _Plane:
        def owner_client(self, owner):
            return _Client()

    class _Worker:
        class worker_id:
            @staticmethod
            def hex():
                return "ab" * 16

    class _Backend:
        object_plane = _Plane()
        worker = _Worker()

    shipper = _LogShipperNoThread(wm, _Backend())
    shipper.set_owner(b"o" * 16)
    # overflow: buffer fills, then keeps dropping the oldest
    for i in range(shipper.MAX_BUFFER + 5):
        shipper.emit("stdout", f"line {i}")
    # drain the buffer WITHOUT a flush (simulates the flush thread
    # racing production), leaving only the drop count behind
    with shipper._lock:
        shipper._buf.clear()
    shipper.flush()     # empty batch + pending drops: nothing sent...
    assert sent == []
    shipper.emit("stdout", "after")
    shipper.flush()     # ...but the count was carried, not lost
    assert len(sent) == 1
    lines = sent[0]["lines"]
    assert ("stdout", "after") in lines
    assert any("5 log lines dropped" in text for _s, text in lines), lines


def _LogShipperNoThread(wm, backend):
    """A _LogShipper without its background flush thread (deterministic
    flush timing for the drop-carry test)."""
    shipper = wm._LogShipper.__new__(wm._LogShipper)
    import collections
    import contextvars
    import threading
    shipper.backend = backend
    shipper._owner_var = contextvars.ContextVar("t_owner", default=None)
    shipper._lock = threading.Lock()
    shipper._buf = collections.deque()
    shipper._last_owner = None
    shipper._dropped = 0
    return shipper


def test_tee_stream_emits_trailing_partial_on_flush(lp):
    """Satellite: print(..., end='') then flush (or process exit via the
    atexit hooks) must emit the partial line — the last words before a
    crash are exactly the ones written without a newline."""
    wm = sibling(lp, "runtime.worker_main")

    got = []

    class _Shipper:
        def emit(self, stream, text):
            got.append((stream, text))

    real = io.StringIO()
    tee = wm._TeeStream(real, "stdout", _Shipper())
    tee.write("complete line\npartial")
    assert got == [("stdout", "complete line")]
    tee.flush()
    assert got == [("stdout", "complete line"), ("stdout", "partial")]
    assert real.getvalue() == "complete line\npartial"
    tee.flush()  # idempotent: nothing left to emit
    assert len(got) == 2


def test_tee_stream_feeds_log_plane_without_shipper(lp, tmp_path):
    """Satellite: pre-first-task (ownerless) output still reaches the
    local file sink + ring via the process logger, even with no shipper
    owner to attribute it to."""
    wm = sibling(lp, "runtime.worker_main")

    lp.stop_global()
    GlobalConfig = sibling(lp, "core.config").GlobalConfig
    assert GlobalConfig.log_plane_enabled
    try:
        lg = lp.ensure_started(role="worker", worker="wX",
                               log_dir=str(tmp_path), filename="wX.log")
        assert lg is not None
        tee = wm._TeeStream(io.StringIO(), "stderr", shipper=None)
        tee.write("early traceback\n")
        tee.write("dying words")
        tee.flush()
        e = lg.export()
        msgs = [(r["level"], r["msg"]) for r in e["records"]]
        assert ("error", "early traceback") in msgs  # stderr -> error
        assert ("error", "dying words") in msgs
        for r in e["records"]:
            assert r["fields"]["stream"] == "stderr"
        # and the durable sink has them as JSON lines
        with open(tmp_path / "wX.log") as f:
            on_disk = [json.loads(ln)["msg"] for ln in f]
        assert "early traceback" in on_disk and "dying words" in on_disk
    finally:
        lp.stop_global()


def test_null_logger_keeps_warnings_visible(lp):
    lp.stop_global()
    lg = lp.get_logger()
    assert isinstance(lg, lp._NullLogger)
    lg.debug("invisible")
    lg.info("invisible too")
    lg.warning("something odd")
    lg.error("something bad")
    assert lg.export() is None and lg.drain_journal_events() == []


def test_ensure_started_respects_disable(lp, tmp_path):
    GlobalConfig = sibling(lp, "core.config").GlobalConfig
    lp.stop_global()
    old = GlobalConfig.log_plane_enabled
    try:
        GlobalConfig.apply({"log_plane_enabled": False})
        assert lp.ensure_started(role="t") is None
        assert lp.get_global() is None
        assert lp.drain_export() is None
    finally:
        GlobalConfig.apply({"log_plane_enabled": old})
        lp.stop_global()


def test_tail_lines_bounded(lp, tmp_path):
    p = tmp_path / "t.err"
    p.write_text("".join(f"line {i}\n" for i in range(1000)))
    assert lp.tail_lines(str(p), 3) == ["line 997", "line 998",
                                        "line 999"]
    assert lp.tail_lines(str(p), 0) == []
    assert lp.tail_lines(str(tmp_path / "missing"), 5) == []
    assert lp.tail_lines(None, 5) == []
    # bounded read: a tiny max_bytes still returns the newest lines
    assert lp.tail_lines(str(p), 2, max_bytes=64)[-1] == "line 999"


def test_format_record_renders_correlation(lp):
    line = lp.format_record({
        "ts": time.time(), "level": "error", "role": "worker",
        "node": "nodeA", "worker": "w1", "pid": 7,
        "trace_id": "t" * 32, "request_id": "req-9",
        "msg": "boom", "fields": {"rc": 137}})
    assert "ERROR" in line and "boom" in line and "w1" in line
    assert "rc=137" in line
    assert f"trace={'t' * 12}" in line and "req=req-9" in line

# ------------------------------------------------------------------- e2e

@pytest.fixture(scope="module", params=PACKAGES)
def two_node_logged(request):
    pkg = request.param
    rt = importlib.import_module(pkg)
    if pkg == "ray_tpu":
        gc.disable()
    rt.init(num_cpus=1, _system_config={
        "object_store_memory_bytes": 64 * MiB,
        "metrics_export_period_s": 0.2,
        "hw_sampler_period_s": 0.5,
        "log_ring_records": 64,       # small ring: overflow is testable
        "log_death_tail_lines": 20,
    })
    worker = importlib.import_module(f"{pkg}.core.worker").global_worker
    start_node = importlib.import_module(
        f"{pkg}.runtime.cluster_backend").start_node
    backend = worker.backend
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
        yield rt, backend, session
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        finally:
            rt.shutdown()
            gc.enable()
            gc.collect()


PORT_ONLY = pytest.mark.parametrize("two_node_logged", ["ray_tpu_torch"],
                                    indirect=True)


def _dump_until(head, payload, pred, timeout=30):
    deadline = time.monotonic() + timeout
    d = {"records": []}
    while time.monotonic() < deadline:
        d = head.call("logs_dump", dict(payload), timeout=10)
        if pred(d):
            return d
        time.sleep(0.3)
    return d


def test_task_logs_reach_head_trace_stamped(two_node_logged):
    """A task's prints (tee'd) and logger records land in the head's
    LogStore stamped with the task's ambient trace id; `logs --trace`
    returns exactly the correlated lines."""
    rt_, backend, _session = two_node_logged
    head = backend.head

    @rt_.remote(num_cpus=1)
    def chatty(pkg):
        import importlib as _il
        log_plane = _il.import_module(f"{pkg}.util.log_plane")
        trace_context = _il.import_module(f"{pkg}.util.trace_context")
        print("marker-stdout-line")
        log_plane.get_logger().info("marker-structured-line", step=3)
        ctx = trace_context.current()
        return ctx[0] if ctx else ""

    tid = rt_.get(chatty.remote(rt_.__name__), timeout=60)
    assert tid
    d = _dump_until(
        head, {"trace": tid},
        lambda d: {"marker-stdout-line", "marker-structured-line"}
        <= {r["msg"] for r in d["records"]})
    msgs = {r["msg"] for r in d["records"]}
    assert {"marker-stdout-line", "marker-structured-line"} <= msgs, msgs
    for r in d["records"]:
        assert r["trace_id"] == tid
        assert r["role"] == "worker" and r["worker"], r
    # the structured record kept its fields
    rec = next(r for r in d["records"]
               if r["msg"] == "marker-structured-line")
    assert rec["fields"]["step"] == 3
    # grep narrows within the trace
    d2 = head.call("logs_dump", {"trace": tid, "grep": "stdout"},
                   timeout=10)
    assert {r["msg"] for r in d2["records"]} == {"marker-stdout-line"}
    # the records' fields, ids aside, equal across the packages
    agree("trace-stamped", rt_.__name__, sorted(
        (r["msg"], r["level"], r["role"], json.dumps(r["fields"],
                                                     sort_keys=True),
         sorted(r)) for r in d["records"]))


def test_request_scoped_logs_queryable(two_node_logged):
    """Records emitted inside a request_context (the Serve/LLM wrapper's
    mechanism) are queryable by request id at the head."""
    rt_, backend, _session = two_node_logged
    head = backend.head
    rid = "req-e2etest-0"

    @rt_.remote(num_cpus=1)
    def serve_like(pkg, rid):
        import importlib as _il
        log_plane = _il.import_module(f"{pkg}.util.log_plane")
        with log_plane.request_context(rid):
            log_plane.get_logger().info("llm request start")
            log_plane.get_logger().info("llm request finished")
        return True

    assert rt_.get(serve_like.remote(rt_.__name__, rid), timeout=60)
    d = _dump_until(head, {"request": rid},
                    lambda d: len(d["records"]) >= 2)
    msgs = [r["msg"] for r in d["records"]]
    assert "llm request start" in msgs and "llm request finished" in msgs
    assert all(r["request_id"] == rid for r in d["records"])
    agree("request-scoped", rt_.__name__, sorted(
        (r["msg"], r["level"], r["request_id"], r["role"])
        for r in d["records"]))


@PORT_ONLY
def test_overflow_burst_exact_ledger(two_node_logged):
    """Forced overflow: a tight burst past the (shrunken) ring drops
    records at the source, and the head's ledger stays exact —
    emitted == stored-at-head + dropped, to the record."""
    rt_, backend, _session = two_node_logged
    head = backend.head
    n_burst = 300

    @rt_.remote(num_cpus=1)
    def burst(n):
        from ray_tpu_torch.util import log_plane
        lg = log_plane.get_global()
        before = lg.stats()
        for i in range(n):
            lg.warning(f"ledger-burst {i}")
        after = lg.stats()
        return {"emitted": after["emitted_total"] - before["emitted_total"],
                "dropped_delta": after["dropped_total"]
                - before["dropped_total"],
                "worker": lg.worker}

    r = rt_.get(burst.remote(n_burst), timeout=60)
    assert r["emitted"] == n_burst
    assert r["dropped_delta"] > 0  # the 64-slot ring really overflowed

    def settled(d):
        stored = sum(1 for rec in d["records"]
                     if rec["msg"].startswith("ledger-burst"))
        return stored + d["dropped_total"] >= n_burst

    d = _dump_until(head, {"worker": r["worker"], "grep": "ledger-burst"},
                    settled)
    stored = len(d["records"])
    assert stored + d["dropped_total"] == n_burst, \
        (stored, d["dropped_total"])


@PORT_ONLY
def test_worker_sigkill_forensics_in_journal(two_node_logged, tmp_path):
    """SIGKILL a worker mid-task: the node daemon tails the dead
    worker's durable .err stream and .log records into the
    worker_death journal record (bounded)."""
    rt_, backend, _session = two_node_logged
    head = backend.head
    sentinel = str(tmp_path / "released")

    @rt_.remote(num_cpus=1)
    def doomed(sentinel):
        import os as _os
        import sys as _sys
        import time as _time
        from ray_tpu_torch.util import log_plane
        log_plane.get_logger().error("fatal: about to be killed")
        print("last words before sigkill", file=_sys.stderr)
        _sys.stderr.flush()
        # park until killed; a post-kill RETRY of this task sees the
        # sentinel and returns fast instead of hogging a cpu slot
        for _ in range(600):
            if _os.path.exists(sentinel):
                return 0
            _time.sleep(0.1)
        return _os.getpid()

    ref = doomed.remote(sentinel)
    # find the victim: the worker that emitted the marker
    deadline = time.monotonic() + 30
    victim = None
    while time.monotonic() < deadline and victim is None:
        d = head.call("logs_dump", {"grep": "about to be killed"},
                      timeout=10)
        for rec in d["records"]:
            victim = (rec["worker"], rec["pid"])
        time.sleep(0.3)
    assert victim, "marker record never reached the head"
    os.kill(victim[1], signal.SIGKILL)
    with open(sentinel, "w"):
        pass
    try:  # dead-worker failure or a successful retry: both acceptable
        rt_.get(ref, timeout=60)
    except Exception:
        pass
    ev = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and ev is None:
        for e in head.call("events_dump", {"type": "worker_death"},
                           timeout=10):
            if str(e.get("worker_id", "")).startswith(victim[0]) \
                    and e.get("stderr_tail"):
                ev = e
        time.sleep(0.3)
    assert ev is not None, "worker_death with tails never journaled"
    assert any("last words before sigkill" in ln
               for ln in ev["stderr_tail"]), ev["stderr_tail"]
    assert ev.get("log_tail"), ev
    assert any("about to be killed" in ln for ln in ev["log_tail"]), \
        ev["log_tail"]
    # bounded: the config cap (20) held, after head-side re-bounding
    assert len(ev["stderr_tail"]) <= 50
    assert len(ev["log_tail"]) <= 50


@PORT_ONLY
def test_every_role_reports_and_files_exist(two_node_logged):
    """Every role's logger reports into the store, and the durable
    session log directory has the per-process files."""
    rt_, backend, session = two_node_logged
    head = backend.head
    from ray_tpu_torch.util import log_plane

    # drive one task so workers exist and have logged something
    @rt_.remote(num_cpus=1)
    def touch():
        print("role-check line")
        return True

    assert rt_.get(touch.remote(), timeout=60)
    log_plane.get_logger().info("driver marker record")

    roles = set()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        d = head.call("logs_dump", {}, timeout=10)
        roles = {r["role"] for r in d["records"]}
        if {"head", "worker", "driver"} <= roles:
            break
        time.sleep(0.3)
    assert {"head", "worker", "driver"} <= roles, roles

    log_dir = log_plane.session_log_dir(session)
    names = os.listdir(log_dir)
    assert "head.log" in names, names
    assert any(n.startswith("node-") and n.endswith(".log")
               for n in names), names
    assert any(n.startswith("worker-") and n.endswith(".log")
               for n in names), names
    assert any(n.startswith("worker-") and n.endswith(".err")
               for n in names), names
    assert any(n.startswith("worker-") and n.endswith(".out")
               for n in names), names
    # head.log is JSON-lines structured records
    with open(os.path.join(log_dir, "head.log")) as f:
        first = f.readline()
    rec = json.loads(first)
    assert rec["role"] == "head" and "ts" in rec and "level" in rec


@PORT_ONLY
def test_logs_cli_smoke(two_node_logged):
    """`ray_tpu_torch logs` renders records; filters and --follow work."""
    from ray_tpu_torch.scripts import cli

    rt_, backend, _session = two_node_logged
    address = backend.head_addr

    @rt_.remote(num_cpus=1)
    def emit():
        from ray_tpu_torch.util import log_plane, trace_context
        print("cli-smoke-line")
        ctx = trace_context.current()
        return ctx[0] if ctx else ""

    tid = rt_.get(emit.remote(), timeout=60)
    _dump_until(backend.head, {"grep": "cli-smoke-line"},
                lambda d: d["records"])

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["logs", "--address", address]) == 0
    out = buf.getvalue()
    assert "cli-smoke-line" in out

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["logs", "--grep", "cli-smoke",
                         "--trace", tid, "--address", address]) == 0
    out = buf.getvalue()
    assert "cli-smoke-line" in out and f"trace={tid[:12]}" in out

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["logs", "--level", "error", "--grep",
                         "cli-smoke-line", "--address", address]) == 0
    assert "cli-smoke-line" not in buf.getvalue()  # it was info-level

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["logs", "--format", "json",
                         "--limit", "5", "--address", address]) == 0
    data = json.loads(buf.getvalue())
    assert len(data["records"]) <= 5 and "last_seq" in data

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["logs", "--follow", "--interval", "0.05",
                         "--frames", "2", "--address", address]) == 0
    assert buf.getvalue()  # follow rendered at least something
