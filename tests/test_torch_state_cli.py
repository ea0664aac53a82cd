"""The port's state API, CLI and job submission against the JAX package's.

The CLI's renderers (``scripts/cli.py`` ``_render_top``,
``_render_requests``, ``_render_compiles``, ``format_request_timeline``,
``_fmt_event``) get the same head dumps in both packages and must print
the same text, apart from the card memory keys: the port's ``top`` reads
``gpu_memory_*`` where the JAX package's reads ``tpu_hbm_*``. Then the
programs of ``tests/test_state_cli.py`` and the jobs part of
``tests/test_jobs_dag_workflow.py`` run through both packages' clusters
(``python -m ray_tpu_torch`` in place of ``python -m ray_tpu``) and must
reach that file's gates in each. A port job's entrypoint sees
``RTPT_ADDRESS`` and ``RTPT_JOB_ID``, never the JAX package's ``RTPU_*``.
"""

import importlib
import io
import json
import os
import subprocess
import sys
import uuid
from contextlib import redirect_stdout

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: each package's environment prefix (the job's address variable)
PREFIX = {"ray_tpu": "RTPU", "ray_tpu_torch": "RTPT"}


def _cli_mod(name):
    return importlib.import_module(f"{name}.scripts.cli")


def _run(cli, *argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, buf.getvalue()


# ------------------------------------------------------ renderers, no cluster


class _FakeClient:
    def __init__(self, replies):
        self.replies = replies

    def call(self, op, payload=None, timeout=None):
        return self.replies[op]


def _metrics():
    return {
        "llm_ttft_seconds": {
            "type": "histogram", "boundaries": (0.01, 0.05, 0.1),
            "values": {
                "a": {"counts": [6, 2, 1, 1], "sum": 0.3, "n": 10},
                "b": {"counts": [4, 1, 0, 0], "sum": 0.05, "n": 5}}},
        "llm_tpot_seconds": {
            "type": "histogram", "boundaries": (0.005, 0.01),
            "values": {"a": {"counts": [3, 1, 0], "sum": 0.02, "n": 4}}},
        "llm_decode_tokens_per_s": {"type": "gauge",
                                    "values": {"w0": 120.0}},
        "llm_slo_ttft_attainment": {"type": "gauge",
                                    "values": {"w0": 0.9, "w1": 0.7}},
        "llm_slo_tpot_attainment": {"type": "gauge",
                                    "values": {"w0": 1.0, "w1": 0.5}},
        "queue_depth": {"type": "gauge", "values": {"x": 3.0}},
        "object_store_spill_write_total": {"type": "counter",
                                           "values": {"": 2.0}},
    }


def _top_dump(memory):
    """A head dump of two nodes: node_gauges, two workers, and card (or
    TPU) memory of two processes on node A, named by ``memory``'s used
    and limit metric names."""
    used, limit = memory
    a, b = "a" * 32, "b" * 32
    latest = [
        {"node": a, "metric": "node_cpu_percent", "tags": {}, "value": 12.5},
        {"node": a, "metric": "node_mem_used_bytes", "tags": {},
         "value": 4 << 30},
        {"node": a, "metric": "node_mem_total_bytes", "tags": {},
         "value": 16 << 30},
        {"node": a, "metric": "object_store_used_bytes", "tags": {},
         "value": 1 << 20},
        {"node": a, "metric": "object_store_capacity_bytes", "tags": {},
         "value": 64 << 20},
        {"node": a, "metric": "worker_cpu_percent",
         "tags": {"worker": "w1", "state": "actor"}, "value": 99.0},
        {"node": a, "metric": "worker_rss_bytes",
         "tags": {"worker": "w1", "state": "actor"}, "value": 3 << 30},
        {"node": b, "metric": "node_cpu_percent", "tags": {}, "value": 1.0},
    ]
    for worker, u in (("w1", 17 << 30), ("w2", 1 << 30)):
        tags = {"worker": worker, "device": "0"}
        latest.append({"node": a, "metric": used, "tags": tags, "value": u})
        latest.append({"node": a, "metric": limit, "tags": tags,
                       "value": 80 << 30})
    state = {"nodes": [{"node_id": a, "alive": True},
                       {"node_id": b, "alive": False}], "leases": 2}
    return {"state_dump": state, "timeseries_dump": latest,
            "metrics_dump": _metrics()}


MEMORY_KEYS = {"ray_tpu": ("tpu_hbm_used_bytes", "tpu_hbm_limit_bytes"),
               "ray_tpu_torch": ("gpu_memory_used_bytes",
                                 "gpu_memory_limit_bytes")}


def test_top_renders_as_jax_with_the_cards_memory():
    want = _cli_mod("ray_tpu")._render_top(
        _FakeClient(_top_dump(MEMORY_KEYS["ray_tpu"])), "127.0.0.1:1")
    dump = _top_dump(MEMORY_KEYS["ray_tpu_torch"])
    # the allocator's reserved pool rides the same flush; `top` shows the
    # memory in use
    dump["timeseries_dump"].append(
        {"node": "a" * 32, "metric": "gpu_memory_reserved_bytes",
         "tags": {"worker": "w1", "device": "0"}, "value": 30 << 30})
    got = _cli_mod("ray_tpu_torch")._render_top(_FakeClient(dump),
                                                 "127.0.0.1:1")
    assert got == want.replace("ray_tpu top", "ray_tpu_torch top") \
        .replace(f"{'HBM':>19}", f"{'GPU MEM':>19}")
    row = next(ln for ln in got.splitlines() if ln.startswith("a" * 12))
    # both processes' card 0 summed: 18 of 160 GiB
    assert row.endswith("18.0GiB/160.0GiB")
    assert "llm: decode 120 tok/s" in got
    assert "ttft p50<=10ms p99<=100ms" in got
    assert "tpot p50<=5.0ms" in got
    assert "slo ttft 80% tpot 75%" in got


def test_hist_quantile_matches_jax():
    metrics = _metrics()
    for name in ("ray_tpu", "ray_tpu_torch"):
        cli = _cli_mod(name)
        assert cli._hist_quantile(metrics, "llm_ttft_seconds", 0.5) == 0.01
        assert cli._hist_quantile(metrics, "llm_ttft_seconds", 0.99) == 0.1
        assert cli._hist_quantile(metrics, "absent", 0.5) is None
    jcli, tcli = _cli_mod("ray_tpu"), _cli_mod("ray_tpu_torch")
    for q in (0.1, 0.5, 0.9, 0.99, 1.0):
        for name in ("llm_ttft_seconds", "llm_tpot_seconds"):
            assert tcli._hist_quantile(metrics, name, q) == \
                jcli._hist_quantile(metrics, name, q)


def _records(name, trace_id="feedc0de" * 4):
    """Two finished flight-recorder records built by package ``name``'s
    recorder at fixed offsets (the wire shape is the recorder's own)."""
    FlightRecorder = importlib.import_module(
        f"{name}.llm.request_log").FlightRecorder
    fr = FlightRecorder(capacity=8, observe_metrics=False)
    fast = fr.start("req-clifast-0", 8, 4, trace_id="")
    fast.note_admit(fast.t0 + 0.001, 0)
    fast.note_chunk(fast.t0 + 0.003, 8, 11)
    t = fast.t0 + 0.005
    fast.note_decode(t, 1)
    for _ in range(3):
        t += 0.002
        fast.note_decode(t, 1)
    fr.finish(fast, t + 0.001, "length")

    slow = fr.start("req-clislow-0", 16, 8, trace_id=trace_id)
    slow.note_admit(slow.t0 + 0.010, 4)
    slow.note_chunk(slow.t0 + 0.040, 16, 12)
    slow.note_stall(slow.t0 + 0.050)
    slow.note_preempt(slow.t0 + 0.055)
    slow.note_admit(slow.t0 + 0.060, 0)
    t = slow.t0 + 0.100
    slow.note_decode(t, 1)
    for _ in range(7):
        t += 0.020
        slow.note_decode(t, 1)
    fr.finish(slow, t + 0.001, "stop")
    return fr.drain_export()


def _rounded(recs):
    """Records with their times rounded to 0.1 ms: two recorders stamp
    their own clocks, the renderers print to 0.1 ms."""
    def r(v):
        if isinstance(v, float):
            return round(v, 4)
        if isinstance(v, (list, tuple)):
            return type(v)(r(x) for x in v)
        if isinstance(v, dict):
            return {k: r(x) for k, x in v.items()}
        return v
    out = []
    for rec in recs:
        rec = r(dict(rec))
        for k in ("t0", "wall_t0", "ts", "start_wall"):
            rec.pop(k, None)
        out.append(rec)
    return out


def test_request_and_event_renderers_match_jax():
    jcli, tcli = _cli_mod("ray_tpu"), _cli_mod("ray_tpu_torch")
    jrecs = _rounded(_records("ray_tpu"))
    trecs = _rounded(_records("ray_tpu_torch"))
    assert [sorted(r) for r in trecs] == [sorted(r) for r in jrecs]
    for jr, tr in zip(jrecs, trecs):
        assert tcli.format_request_timeline(jr) == \
            jcli.format_request_timeline(jr)
        assert tcli.format_request_timeline(tr, indent="  ") == \
            jcli.format_request_timeline(tr, indent="  ")

    class Args:
        slowest = 0
        format = "plain"
    assert tcli._render_requests(_FakeClient({"requests_dump": jrecs}),
                                 Args) == \
        jcli._render_requests(_FakeClient({"requests_dump": jrecs}), Args)

    ev = {"seq": 7, "ts": 1.7e9 + 0.25, "type": "instance_running",
          "node_id": "n1", "node_type": "h100", "trace_id": "ab" * 16}
    assert tcli._fmt_event(ev) == jcli._fmt_event(ev)


def _compile_window(name):
    CompileTracker = importlib.import_module(
        f"{name}.util.compile_tracker").CompileTracker
    tr = CompileTracker(role="worker", node="clinode", worker="cliworker",
                        ring_records=16, storm_threshold=2,
                        storm_window_s=60.0)
    tr.note_compile("llm.ragged_step", ["f32[8,128]", "i32[8]"],
                    wall_s=0.5)
    tr.note_compile("llm.ragged_step", ["f32[9,128]", "i32[8]"],
                    wall_s=0.4)
    tr.note_compile("llm.ragged_step", ["f32[10,128]", "i32[8]"],
                    wall_s=0.3)
    tr.note_compile("train.full_step", ["f32[16,64]"], wall_s=1.0)
    return tr


def test_compile_renderers_match_jax():
    jcli, tcli = _cli_mod("ray_tpu"), _cli_mod("ray_tpu_torch")
    recs = _compile_window("ray_tpu").export()["records"]
    for rec in recs:
        assert tcli._fmt_compile_record(rec) == \
            jcli._fmt_compile_record(rec)

    class Args:
        node = worker = callable = ""
        recompiles = False
        by_callable = False
        limit = 0
        format = "plain"
    data = {"records": recs, "procs": 1, "dropped_total": 0}
    for by_callable in (False, True):
        Args.by_callable = by_callable
        data["by_callable"] = {"llm.ragged_step": {
            "compiles": 3, "recompiles": 2, "seconds": 1.2, "procs": 1,
            "last_sig": ["f32[10,128]", "i32[8]"],
            "last_diff": ["arg[0]: f32[9,128] -> f32[10,128]"]}}
        assert tcli._render_compiles(_FakeClient({"compiles_dump": data}),
                                     Args) == \
            jcli._render_compiles(_FakeClient({"compiles_dump": data}),
                                  Args)
    # the empty message names what feeds the port's tracker
    empty = tcli._render_compiles(
        _FakeClient({"compiles_dump": {"records": []}}), Args)
    assert "CompiledDAG" in empty and "jax" not in empty


def test_help_lists_the_jax_subcommands():
    def commands(name):
        out = subprocess.run([sys.executable, "-m", name, "--help"],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=60)
        assert out.returncode == 0, out.stderr
        line = next(ln for ln in out.stdout.splitlines() if "{" in ln)
        return line.strip()
    assert commands("ray_tpu_torch") == commands("ray_tpu")


METRIC_FACTORIES = [
    "object_store_spill_write_total_counter",
    "object_store_spill_write_bytes_counter",
    "object_store_spill_restore_total_counter",
    "object_store_spill_restore_bytes_counter",
    "object_store_pull_in_bytes_counter",
    "object_store_pull_out_bytes_counter",
    "object_store_pull_seconds_histogram",
    "object_store_fetch_inflight_count_gauge",
    "object_store_primary_count_gauge",
    "object_store_secondary_count_gauge",
    "object_store_spilled_count_gauge",
    "train_checkpoint_write_seconds_histogram",
    "train_checkpoint_write_bytes_counter",
    "train_checkpoint_queue_depth_count",
    "train_checkpoint_step_hiccup_seconds_gauge",
    "storage_retry_total_counter", "storage_op_seconds_histogram",
    "storage_put_bytes_counter", "profile_samples_total_counter",
    "profile_dropped_samples_total_counter", "train_phase_skew_gauge",
    "log_records_total_counter", "log_dropped_records_total_counter",
    "log_errors_total_counter", "xla_compile_seconds_histogram",
    "xla_compiles_total_counter", "xla_recompiles_total_counter",
]


def test_metric_families_named_as_jax():
    """The series `top`, `metrics` and ``/metrics`` read: the same names,
    types and tag keys in both packages (the JAX file's naming lints)."""
    import re
    jm = importlib.import_module("ray_tpu.util.metrics")
    tm = importlib.import_module("ray_tpu_torch.util.metrics")
    pat = re.compile(
        r"^[a-z][a-z0-9]*(?:_[a-z0-9]+)*_(bytes|seconds|total|count|s)$")
    for f in METRIC_FACTORIES:
        want, got = getattr(jm, f)(), getattr(tm, f)()
        assert (type(got).__name__, got.name, tuple(got.tag_keys)) == \
            (type(want).__name__, want.name, tuple(want.tag_keys)), f
        assert pat.match(got.name), got.name


def test_task_event_buffer_ring_eviction_matches_jax():
    def drained(name):
        TaskEventBuffer = importlib.import_module(
            f"{name}.runtime.events").TaskEventBuffer
        buf = TaskEventBuffer()
        for i in range(TaskEventBuffer.MAX_BUFFER + 10):
            buf.record(name=f"t{i}", task_id=f"id{i}", kind="task",
                       start=float(i), end=float(i) + 0.5, ok=True)
        # the eviction marker is stamped with the drain's wall clock
        return [{k: v for k, v in e.items() if e["name"] != "__dropped__"
                 or k not in ("start", "end")} for e in buf.drain()], \
            buf.drain()
    got = drained("ray_tpu_torch")
    assert got == drained("ray_tpu")
    marker = [e for e in got[0] if e["name"] == "__dropped__"]
    assert len(marker) == 1 and marker[0]["dropped"] == 10
    assert got[1] == []


@pytest.mark.parametrize("name", PACKAGES)
def test_local_mode_dump_synthesis(name):
    code = f"""
import {name} as rt
rt.init(local_mode=True)
from {name}.util import state
d = state._dump()
assert d["nodes"][0]["node_id"] == "local" and d["nodes"][0]["alive"]
assert d["objects_dir"] == []
assert d["events"] == {{"recorded": 0, "kept": 0}}
assert d["objects"][0]["owner"] == "local"
objs = state.list_objects()
assert objs and objs[0]["owner"] == "local"
s = state.summarize()
assert s["tasks"] == 0 and s["events_recorded"] == 0
assert s["objects_in_directory"] == 0
assert s["nodes_alive"] == 1
print(sorted(s))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "nodes_alive" in out.stdout


# ------------------------------------------------------------ live clusters


@pytest.fixture(scope="module", params=PACKAGES)
def srt(request):
    rt = importlib.import_module(request.param)
    rt.init(num_cpus=3, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024})
    yield rt, request.param
    rt.shutdown()


def _head(name):
    backend = importlib.import_module(
        f"{name}.core.worker").global_worker.backend
    return backend.head, backend.head_addr


def _subcli(name, *args, address):
    return subprocess.run([sys.executable, "-m", name, *args,
                           "--address", address], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)


def test_state_api_lists(srt):
    rt, name = srt
    state = importlib.import_module(f"{name}.util.state")

    @rt.remote
    class Marker:
        def ping(self):
            return "pong"

    marker = f"m-{uuid.uuid4().hex[:6]}"
    a = Marker.options(name=marker).remote()
    rt.get(a.ping.remote(), timeout=60)
    nodes = state.list_nodes()
    assert len(nodes) == 1 and nodes[0]["alive"]
    assert any(x["name"].endswith(marker)
               for x in state.list_actors(state="ALIVE"))
    s = state.summarize()
    assert s["nodes_alive"] == 1 and s["actors_alive"] >= 1


def test_requests_cli_and_trace_request_merge(srt):
    rt, name = srt
    cli = _cli_mod(name)
    head, address = _head(name)
    trace_id = "feedc0de" * 4
    import time
    now = time.time()
    head.call("telemetry_push", {
        "worker": "cliworker" + "0" * 23, "node": "clinode" + "0" * 25,
        "llm_requests": _records(name, trace_id),
        "events": [{"name": "serve.router::llm.__call__",
                    "kind": "serve_router", "task_id": "",
                    "start": now - 0.2, "end": now, "ok": True,
                    "trace_id": trace_id, "span_id": "a1" * 8,
                    "parent_span_id": ""}],
    }, timeout=10)

    rc, out = _run(cli, "requests", "--address", address)
    assert rc == 0
    assert "req-clifast-0" in out and "req-clislow-0" in out
    assert "(TTFT)" in out and "enqueue" in out and "tpot" in out
    assert "reason=length" in out and "reason=stop" in out
    assert "admit #1" in out and "admit #2" in out
    assert "preempts 1" in out and "stalls" in out and "@cliworker" in out

    rc, out = _run(cli, "requests", "--slowest", "1", "--address", address)
    assert rc == 0
    assert "req-clislow-0" in out and "req-clifast-0" not in out

    rc, out = _run(cli, "requests", "--format", "json", "--address",
                   address)
    by_rid = {r["rid"]: r for r in json.loads(out)}
    assert by_rid["req-clislow-0"]["trace_id"] == trace_id
    assert by_rid["req-clislow-0"]["preempts"] == 1

    rc, out = _run(cli, "trace", "--request", "req-clislow-0", "--address",
                   address)
    assert rc == 0
    assert f"request req-clislow-0  trace {trace_id}" in out
    assert "serve.router::llm.__call__" in out
    assert "first tok" in out and "reason=stop" in out
    assert cli.main(["trace", "--request", "req-missing",
                     "--address", address]) == 1


def _seed_object_directory(head):
    head.call("telemetry_push", {
        "worker": "memworker" + "0" * 23, "node": "memnode" + "0" * 25,
        "role": "worker",
        "objects": {
            "tracked": 2, "sample": [],
            "dir": [
                {"object_id": "aa" * 14, "size": 1048576,
                 "role": "primary", "owner": "memworker000",
                 "age_s": 999.0,
                 "pins": {"local": 0, "submitted": 0, "borrowers": 0,
                          "owned": True}},
                {"object_id": "bb" * 14, "size": 4096,
                 "role": "secondary", "owner": "elsewhere000",
                 "age_s": 1.0, "pins": None},
            ],
            "dir_totals": {
                "primary": {"count": 1, "bytes": 1048576,
                            "arena_bytes": 1048576},
                "secondary": {"count": 1, "bytes": 4096,
                              "arena_bytes": 4096}},
        },
        "journal": [{"type": "spill_overflow", "object_id": "cc" * 14,
                     "bytes": 2048, "node": "memnode" + "0" * 25}],
    }, timeout=10)


def test_memory_and_events_cli(srt):
    rt, name = srt
    cli = _cli_mod(name)
    head, address = _head(name)
    _seed_object_directory(head)

    rc, out = _run(cli, "memory", "--address", address)
    assert rc == 0
    assert "memnode00000" in out and "primary" in out
    assert "LEAK?" in out and "1 LEAK suspect(s)" in out
    assert "pins=l0/s0/b0" in out
    rc, out = _run(cli, "memory", "--format", "json", "--address", address)
    t = json.loads(out)["totals"]["memnode" + "0" * 25]
    assert t["primary"] == {"count": 1, "bytes": 1048576,
                            "arena_bytes": 1048576}
    rc, out = _run(cli, "memory", "--group-by", "owner", "--address",
                   address)
    assert "owner memworker000" in out and "owner elsewhere000" in out

    rc, out = _run(cli, "events", "--address", address)
    assert rc == 0
    assert "node_register" in out and "spill_overflow" in out
    rc, out = _run(cli, "events", "--type", "spill_overflow", "--address",
                   address)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert lines and all("spill_overflow" in ln for ln in lines)
    rc, out = _run(cli, "events", "--format", "json", "--address", address)
    seqs = [e["seq"] for e in json.loads(out)]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    rc, out = _run(cli, "events", "--follow", "--interval", "0.05",
                   "--frames", "2", "--address", address)
    assert rc == 0 and "spill_overflow" in out


def test_compiles_and_perfetto_cli(srt, tmp_path):
    rt, name = srt
    cli = _cli_mod(name)
    head, address = _head(name)
    tr = _compile_window(name)
    head.call("telemetry_push", {
        "worker": "cliworker" + "0" * 23, "node": "clinode" + "0" * 25,
        "role": "worker", "compiles": tr.export(),
        "journal": tr.drain_journal_events()}, timeout=10)

    rc, out = _run(cli, "compiles", "--address", address)
    assert rc == 0
    assert "RECOMPILE llm.ragged_step" in out
    assert "diff arg[0]: f32[8,128] -> f32[9,128]" in out
    assert "train.full_step" in out and "process(es)" in out
    rc, out = _run(cli, "compiles", "--by-callable", "--address", address)
    assert "llm.ragged_step" in out and "recompiles" in out
    rc, out = _run(cli, "compiles", "--storms", "--format", "json",
                   "--address", address)
    storms = json.loads(out)
    assert len(storms) == 1 and storms[0]["callable"] == "llm.ragged_step"

    path = tmp_path / "cluster.perfetto.json"
    rc, out = _run(cli, "trace", "--perfetto", str(path), "--address",
                   address)
    assert rc == 0 and "lanes" in out
    evs = json.loads(path.read_text())["traceEvents"]
    lanes = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert "xla: compiles" in lanes, lanes
    assert any(e.get("ph") == "X"
               and str(e.get("name", "")).startswith("RECOMPILE")
               for e in evs)


def test_cli_status_list_and_logs(srt):
    rt, name = srt
    _, address = _head(name)
    out = _subcli(name, "status", address=address)
    assert out.returncode == 0, out.stderr
    assert "nodes alive" in out.stdout and "CPU" in out.stdout
    out = _subcli(name, "list", "nodes", address=address)
    assert out.returncode == 0 and "node_id=" in out.stdout
    out = _subcli(name, "list", "actors", "--format", "json",
                  address=address)
    assert out.returncode == 0 and isinstance(json.loads(out.stdout), list)
    out = _subcli(name, "list", "objects", address=address)
    assert out.returncode == 0 and "capacity=" in out.stdout
    out = _subcli(name, "logs", "--limit", "5", address=address)
    assert out.returncode == 0, out.stderr
    assert "record(s)" in out.stderr


def test_job_submit_success_and_logs(srt, tmp_path):
    rt, name = srt
    jobs = importlib.import_module(f"{name}.jobs")
    prefix = PREFIX[name]
    other = PREFIX["ray_tpu" if name == "ray_tpu_torch" else "ray_tpu_torch"]
    script = tmp_path / "job_ok.py"
    script.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"import {name} as rt\n"
        f"rt.init(address=os.environ['{prefix}_ADDRESS'])\n"
        "@rt.remote\n"
        "def sq(x):\n"
        "    return x * x\n"
        "print('RESULT', sum(rt.get([sq.remote(i) for i in range(5)],"
        " timeout=60)))\n"
        f"print('JOB', os.environ['{prefix}_JOB_ID'],"
        f" os.environ.get('{other}_ADDRESS'))\n"
        "rt.shutdown()\n")
    client = jobs.JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"{sys.executable} {script}")
    assert client.wait(job_id, timeout=240) == jobs.SUCCEEDED
    logs = client.get_job_logs(job_id)
    assert "RESULT 30" in logs
    assert f"JOB {job_id} None" in logs
    assert any(j["job_id"] == job_id and j["status"] == jobs.SUCCEEDED
               for j in client.list_jobs())


def test_job_failure_surfaces(srt):
    rt, name = srt
    jobs = importlib.import_module(f"{name}.jobs")
    client = jobs.JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import sys; sys.exit(3)'")
    assert client.wait(job_id, timeout=120) == jobs.FAILED
    assert "exit code 3" in client.get_job_info(job_id)["message"]
