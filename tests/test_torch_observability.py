"""The port's metrics, task timeline and state listings against
ray_tpu's.

Each program of ``tests/test_observability.py`` runs through both
packages and must give the values the JAX test asserts: metric snapshots
and their aggregation, old-format wire frames, and on a cluster (one per
package; the JAX package's with the cyclic collector paused) worker
metrics at the head, task spans and their Chrome export, one trace across
a nested submit with its OTLP export and assembly, the scheduler's phase
spans and queue metrics, and the state API's task and object listings.
The fields of the spans and listings are compared across the packages.
"""

import gc
import importlib
import time

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
#: each e2e program's fields, by program and package
SEEN = {}


def sub(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def agree(program, pkg, value):
    """Keep ``value`` for (program, package); once both packages ran the
    program, their values must be equal."""
    SEEN.setdefault(program, {})[pkg] = value
    if len(SEEN[program]) == len(PACKAGES):
        assert SEEN[program]["ray_tpu"] == SEEN[program]["ray_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


@pytest.fixture(scope="module", params=PACKAGES)
def cluster_rt(request):
    pkg = request.param
    rt = importlib.import_module(pkg)
    metrics_mod = sub(pkg, "util.metrics")
    metrics_mod.clear_registry()
    if pkg == "ray_tpu":
        gc.disable()
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024,
        "metrics_export_period_s": 0.2,
    })
    try:
        yield rt, pkg
    finally:
        rt.shutdown()
        metrics_mod.clear_registry()
        gc.enable()
        gc.collect()


def test_metric_types_and_snapshot(pkg):
    metrics_mod = sub(pkg, "util.metrics")
    Counter, Gauge, Histogram = (metrics_mod.Counter, metrics_mod.Gauge,
                                 metrics_mod.Histogram)
    metrics_mod.clear_registry()
    c = Counter("req_total", tag_keys=("route",))
    c.inc(1, tags={"route": "/a"})
    c.inc(2, tags={"route": "/a"})
    g = Gauge("queue_depth")
    g.set(7)
    h = Histogram("latency_s", boundaries=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    snap = metrics_mod.snapshot()
    assert snap["req_total"]["values"][("/a",)] == 3
    assert snap["queue_depth"]["values"][()] == 7
    assert snap["latency_s"]["values"][()]["counts"] == [1, 1, 1]
    assert snap["latency_s"]["values"][()]["n"] == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    agree("snapshot", pkg, {name: {k: v for k, v in m.items()}
                            for name, m in snap.items()})
    metrics_mod.clear_registry()


def test_aggregate_across_workers(pkg):
    aggregate = sub(pkg, "util.metrics").aggregate
    w1 = {"c": {"type": "counter", "desc": "", "tag_keys": (),
                "values": {(): 2.0}}}
    w2 = {"c": {"type": "counter", "desc": "", "tag_keys": (),
                "values": {(): 3.0}},
          "g": {"type": "gauge", "desc": "", "tag_keys": (),
                "values": {(): 9.0}}}
    agg = aggregate({"w1": w1, "w2": w2})
    assert agg["c"]["values"][()] == 5.0
    assert agg["g"]["values"][()] == 9.0
    agree("aggregate", pkg, agg)


def test_worker_metrics_flow_to_head(cluster_rt):
    rt, pkg = cluster_rt
    global_worker = sub(pkg, "core.worker").global_worker
    @rt.remote
    def work(i):
        import importlib as _il
        _il.import_module(f"{pkg}.util.metrics").Counter(
            "tasks_done_test").inc()
        return i

    assert sorted(rt.get([work.remote(i) for i in range(4)],
                         timeout=60)) == [0, 1, 2, 3]
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        agg = global_worker.backend.head.call("metrics_dump")
        got = agg.get("tasks_done_test", {}).get("values", {})
        if sum(got.values()) >= 4:
            return
        time.sleep(0.3)
    pytest.fail(f"metrics never aggregated at head: {agg}")


def test_task_timeline_records_spans(cluster_rt):
    rt, pkg = cluster_rt
    global_worker = sub(pkg, "core.worker").global_worker
    @rt.remote
    def slow():
        time.sleep(0.05)
        return 1

    rt.get([slow.remote() for _ in range(3)], timeout=60)
    deadline = time.monotonic() + 15
    events = []
    while time.monotonic() < deadline:
        events = global_worker.backend.head.call("timeline_dump")
        if sum(1 for e in events if e["name"].endswith("slow")) >= 3:
            break
        time.sleep(0.3)
    spans = [e for e in events if e["name"].endswith("slow")]
    assert len(spans) >= 3, events
    assert all(e["end"] >= e["start"] + 0.04 for e in spans)
    to_chrome_trace = sub(pkg, "runtime.events").to_chrome_trace
    trace = to_chrome_trace(spans)
    assert all(t["ph"] == "X" and t["dur"] > 0 for t in trace)
    agree("task spans", pkg, (sorted({k for e in spans for k in e}),
                              sorted({k for t in trace for k in t}),
                              sorted({e["kind"] for e in spans})))


def test_nested_submit_single_trace(cluster_rt):
    rt, pkg = cluster_rt
    global_worker = sub(pkg, "core.worker").global_worker
    """Cross-process tracing: driver → outer task → nested inner task
    (two worker processes) must export ONE trace whose spans link via
    parent_span_id — the wire-propagated context, not name matching."""
    @rt.remote
    def trc_inner():
        return 1

    @rt.remote
    def trc_outer():
        return rt.get(trc_inner.remote()) + 1

    assert rt.get(trc_outer.remote(), timeout=60) == 2
    deadline = time.monotonic() + 20
    events, outer, inner = [], None, None
    while time.monotonic() < deadline:
        events = global_worker.backend.head.call("timeline_dump")
        outer = next((e for e in events if "trc_outer" in e["name"]
                      and e.get("kind") == "task"), None)
        inner = next((e for e in events if "trc_inner" in e["name"]
                      and e.get("kind") == "task"), None)
        if outer is not None and inner is not None:
            break
        time.sleep(0.3)
    assert outer is not None and inner is not None, events
    # one trace: the nested submit inherited the outer task's ambient
    # context, across a separate worker process
    assert outer.get("trace_id")
    assert inner.get("trace_id") == outer["trace_id"]
    assert inner["parent_span_id"] == outer["span_id"]
    assert not outer.get("parent_span_id")  # driver-rooted
    mine = [e for e in events if e.get("trace_id") == outer["trace_id"]]
    assert sum(1 for e in mine if e.get("parent_span_id")) >= 3

    # OTLP export carries the linkage verbatim
    tracing = sub(pkg, "util.tracing")
    doc = tracing.events_to_otlp(mine)
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert {s["traceId"] for s in spans} == {outer["trace_id"]}
    assert sum(1 for s in spans if s.get("parentSpanId")) >= 3

    # head-side assembly: one root (the outer exec span), inner beneath it
    roots = tracing.assemble_trace(events, trace_id=outer["trace_id"])
    assert len(roots) == 1, roots
    assert "trc_outer" in roots[0]["name"]

    def names(span):
        yield span["name"]
        for c in span["children"]:
            yield from names(c)
    assert any("trc_inner" in n for n in names(roots[0]))
    # selection by task_id resolves to the same trace
    by_task = tracing.assemble_trace(events, task_id=inner["task_id"])
    assert by_task and by_task[0]["trace_id"] == outer["trace_id"]
    agree("one trace", pkg, (sorted(outer), sorted({k for x in spans
                                                    for k in x}),
                             sorted(n.rsplit(".", 1)[-1]
                                    for n in names(roots[0]))))


def test_scheduler_phase_spans_and_queue_metrics(cluster_rt):
    rt, pkg = cluster_rt
    global_worker = sub(pkg, "core.worker").global_worker
    """Queueing delay is separable from execution: every exec span gets a
    ::sched companion (submit→start, child of the exec span), the head
    stamps lease:: phase events, and submit_to_start/queue_depth
    aggregate in metrics_dump."""
    @rt.remote
    def phased():
        time.sleep(0.02)
        return 1

    assert rt.get(phased.remote(), timeout=60) == 1
    deadline = time.monotonic() + 20
    events, ex, sched = [], None, None
    while time.monotonic() < deadline:
        events = global_worker.backend.head.call("timeline_dump")
        ex = next((e for e in events if "phased" in e["name"]
                   and e.get("kind") == "task"), None)
        sched = next((e for e in events if "phased" in e["name"]
                      and e.get("kind") == "sched"), None)
        if ex is not None and sched is not None:
            break
        time.sleep(0.3)
    assert ex is not None and sched is not None, events
    # the sched span ends where execution begins: queue time vs run time
    assert sched["end"] <= ex["start"] + 1e-6
    assert sched["start"] <= sched["end"]
    assert sched["trace_id"] == ex["trace_id"]
    assert sched["parent_span_id"] == ex["span_id"]
    # head-side scheduler-phase events (lease grant path)
    assert any(e.get("kind") == "sched" and e["name"].startswith("lease::")
               and e.get("worker") == "head" for e in events), \
        [e["name"] for e in events if e.get("kind") == "sched"]
    # aggregate view at the head
    agg = {}
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        agg = global_worker.backend.head.call("metrics_dump")
        h = agg.get("submit_to_start")
        if h and sum(v["n"] for v in h["values"].values()) >= 1:
            break
        time.sleep(0.3)
    assert agg.get("submit_to_start", {}).get("type") == "histogram", \
        sorted(agg)
    assert "queue_depth" in agg
    agree("scheduler phases", pkg, (sorted(sched), sorted(
        e["name"].split("::")[0] for e in events
        if e.get("kind") == "sched" and e.get("worker") == "head")[:1],
        agg["submit_to_start"]["type"], agg["queue_depth"]["type"]))


def test_old_format_wire_frames_accepted(pkg):
    """Mixed-version compat: a submit payload from a peer that predates
    trace propagation (no trace/span/submit_ts fields) still parses, and
    its events still export with the deterministic fabricated ids."""
    TaskID = sub(pkg, "core.ids").TaskID
    TaskSpec = sub(pkg, "core.task_spec").TaskSpec
    wire = sub(pkg, "runtime.wire")
    tracing = sub(pkg, "util.tracing")

    spec = TaskSpec(task_id=TaskID.from_random(), name="legacy",
                    function_key=b"fn:x", resources={"CPU": 1.0})
    payload, _ = wire.task_to_wire(spec, function_key="fn:x")
    # new stamps present on the modern frame...
    assert len(payload["trace_id"]) == 32
    assert len(payload["span_id"]) == 16
    # ...and absent on an old peer's frame — which must still be accepted
    for k in ("trace_id", "span_id", "parent_span_id", "submit_ts",
              "lease_ts"):
        payload.pop(k, None)
    back = wire.task_from_wire(payload)
    assert back.name == "legacy"
    assert back.task_id == spec.task_id
    # OTLP export of a traceless event fabricates deterministic ids
    e = {"name": "legacy", "task_id": "ab" * 8, "kind": "task",
         "start": 1.0, "end": 2.0, "ok": True}
    doc = tracing.events_to_otlp([e])
    span = doc["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    assert len(span["traceId"]) == 32 and len(span["spanId"]) == 16
    assert "parentSpanId" not in span


def test_state_api_lists_tasks_and_objects(cluster_rt):
    rt, pkg = cluster_rt
    global_worker = sub(pkg, "core.worker").global_worker
    """`list tasks` / `list objects` (reference: util/state/api.py:1011
    list_tasks, list_objects) — task spans from the head's event buffer,
    object summaries from owner telemetry."""
    import time as _t

    state_api = sub(pkg, "util.state")

    @rt.remote
    def traced(x):
        return x + 1

    ref = traced.remote(1)
    keep = rt.put(list(range(2000)))  # a tracked object  # noqa: F841
    assert rt.get(ref, timeout=60) == 2
    # telemetry flushes every metrics_export_period_s; poll until visible
    deadline = _t.monotonic() + 30
    tasks, objects = [], []
    while _t.monotonic() < deadline:
        tasks = state_api.list_tasks()
        objects = state_api.list_objects()
        if any("traced" in (t.get("name") or "") for t in tasks) \
                and objects:
            break
        _t.sleep(0.5)
    names = [t.get("name") for t in tasks]
    assert any("traced" in n for n in names), names
    span = next(t for t in tasks if "traced" in (t.get("name") or ""))
    assert span.get("ok") is True and "worker" in span
    assert any(o.get("tracked", 0) > 0 for o in objects), objects
    agree("state listings", pkg, (sorted(span), sorted(
        {k for o in objects for k in o})))
