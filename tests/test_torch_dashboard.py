"""The port's dashboard, Prometheus exposition and hardware telemetry
against the JAX package's.

``util/prometheus.py`` renders the same aggregated metrics and hardware
samples to the same text in both packages; the node sampler
(``runtime/hw_sampler.py``) reads the same fake ``/proc`` tree to the
same samples; the time-series rings keep the same points. Then the
programs of ``tests/test_dashboard.py`` and ``tests/test_telemetry.py``
run through both packages' clusters (the dashboard's endpoints,
``/metrics``, ``/api/timeseries``, and ``top`` over two node daemons) and
must reach those files' gates in each. The port's own case: card memory
samples pushed by a worker (``gpu_memory_*``) reach ``/metrics`` and
``top``.
"""

import importlib
import io
import json
import os
import subprocess
import time
import urllib.request
from contextlib import redirect_stdout

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def _mod(name, sub):
    return importlib.import_module(f"{name}.{sub}")


# ---------------------------------------------------------------- sampler


def _write(path, text):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _fake_proc(tmp_path, busy, total, pid_ticks):
    idle = total - busy
    _write(tmp_path / "proc" / "stat",
           f"cpu  {busy} 0 0 {idle} 0 0 0 0 0 0\n"
           "cpu0 0 0 0 0 0 0 0 0 0 0\n")
    _write(tmp_path / "proc" / "meminfo",
           "MemTotal:       16384 kB\n"
           "MemFree:         4096 kB\n"
           "MemAvailable:    8192 kB\n")
    half = pid_ticks // 2
    _write(tmp_path / "proc" / "4242" / "stat",
           f"4242 (worker main) S 1 1 1 0 -1 4194304 0 0 0 0 "
           f"{half} {pid_ticks - half} 0 0 20 0 1 0 0 0 0\n")
    _write(tmp_path / "proc" / "4242" / "statm",
           "10000 2500 500 1 0 9000 0\n")


def _fake_cgroup(tmp_path, usage_usec):
    cg = tmp_path / "cg"
    _write(cg / "cpu.stat",
           f"usage_usec {usage_usec}\nuser_usec 1\nsystem_usec 1\n")
    _write(cg / "memory.current", "123456\n")
    _write(cg / "cpu.pressure",
           "some avg10=1.50 avg60=0.80 avg300=0.10 total=12345\n")
    _write(cg / "memory.pressure",
           "some avg10=0.25 avg60=0.10 avg300=0.00 total=99\n")
    return str(cg)


def _passes(name, tmp_path, ticks, workers=True, cgroup=True):
    """Samples (without their wall time) of one sampler over passes at
    2 s apart, the fake tree rewritten before each: ``ticks`` lists
    (node busy, node total, worker ticks, cgroup usec)."""
    HardwareSampler = _mod(name, "runtime.hw_sampler").HardwareSampler
    root = tmp_path / name
    clock = [100.0]
    busy, total, pid_ticks, usec = ticks[0]
    _fake_proc(root, busy, total, pid_ticks)
    cg = _fake_cgroup(root, usec) if cgroup else None
    sampler = HardwareSampler(
        procfs=str(root / "proc"), cgroup_dir=cg,
        workers=(lambda: [{"worker_id": "deadbeef" * 4, "pid": 4242,
                           "state": "actor"}]) if workers else None,
        arena_stats=lambda: {"bytes_used": 10, "capacity": 100,
                             "num_objects": 2, "total_evicted": 1},
        clock=lambda: clock[0])
    out = []
    for busy, total, pid_ticks, usec in ticks:
        _fake_proc(root, busy, total, pid_ticks)
        if cgroup:
            _fake_cgroup(root, usec)
        out.append(sorted(
            (s["metric"], round(s["value"], 6),
             tuple(sorted((s.get("tags") or {}).items())))
            for s in sampler.sample()))
        clock[0] += 2.0
    return out, sampler


def test_hw_sampler_reads_as_jax(tmp_path):
    hz = os.sysconf("SC_CLK_TCK")
    page = os.sysconf("SC_PAGE_SIZE")
    cases = {
        "fake_proc_tree": [(200, 1000, 0, 1_000_000),
                           (400, 1800, 2 * hz, 2_000_000)],
        "pid_reuse": [(200, 1000, 50 * hz, 0), (400, 1800, 1 * hz, 0),
                      (600, 2600, 3 * hz, 0)],
        "clamped": [(200, 1000, 0, 0), (400, 1800, 1000 * hz, 0)],
    }
    for case, ticks in cases.items():
        got, sampler = _passes("ray_tpu_torch", tmp_path / case, ticks,
                               cgroup=case == "fake_proc_tree")
        want, _ = _passes("ray_tpu", tmp_path / case, ticks,
                          cgroup=case == "fake_proc_tree")
        assert got == want, case
    first = {m: v for m, v, _ in
             _passes("ray_tpu_torch", tmp_path / "again",
                     cases["fake_proc_tree"])[0][0]}
    assert "node_cpu_percent" not in first
    assert first["node_mem_used_bytes"] == (16384 - 8192) * 1024
    assert first["worker_rss_bytes"] == 2500 * page
    assert first["cgroup_cpu_pressure_avg10"] == 1.5
    passes, sampler = _passes("ray_tpu_torch", tmp_path / "clamp2",
                              cases["clamped"], cgroup=False)
    cpu = [v for m, v, _ in passes[1] if m == "worker_cpu_percent"]
    assert cpu and cpu[0] <= 100.0 * sampler._ncpu


def test_hw_sampler_probe_isolation(tmp_path, caplog):
    import logging
    _fake_proc(tmp_path, busy=200, total=1000, pid_ticks=0)
    HardwareSampler = _mod("ray_tpu_torch",
                           "runtime.hw_sampler").HardwareSampler
    sampler = HardwareSampler(procfs=str(tmp_path / "proc"))

    def boom():
        raise RuntimeError("probe exploded")

    sampler._node_cpu = boom
    with caplog.at_level(logging.WARNING,
                         "ray_tpu_torch.runtime.hw_sampler"):
        first = {s["metric"] for s in sampler.sample()}
        second = {s["metric"] for s in sampler.sample()}
    assert "node_mem_total_bytes" in first
    assert "node_mem_total_bytes" in second
    warnings = [r for r in caplog.records if "node_cpu" in r.getMessage()]
    assert len(warnings) == 1


def test_timeseries_rings_match_jax():
    def run(name):
        store = _mod(name, "util.timeseries").TimeSeriesStore(
            maxlen=4, max_series=3)
        for i in range(10):
            store.append("nodeA", "cpu", float(i), ts=1000.0 + i)
        out = [store.dump()]
        store.append("nodeB", "cpu", 1.0, ts=2000.0)
        store.append("nodeB", "mem", 2.0, ts=2000.0)
        store.append("nodeB", "cpu", 3.0, ts=2001.0, tags={"worker": "w1"})
        store.append("nodeB", "cpu", 4.0, ts=2002.0)
        out += [store.num_series(), store.dump(node="nodeA"),
                store.dump(node="nodeB", metric="cpu", last=1),
                sorted((s["metric"], s["value"]) for s in store.latest()),
                store.latest(max_age_s=0.001),
                store.ingest("nodeC", [{"metric": "ok", "value": 1.0},
                                       {"value": 2.0}, "junk", None,
                                       {"metric": "bad",
                                        "value": "NaNsense"}])]
        return out
    got = run("ray_tpu_torch")
    assert got == run("ray_tpu")
    assert [v for _, v in got[0][0]["points"]] == [6.0, 7.0, 8.0, 9.0]


# ------------------------------------------------------------- prometheus


def _aggregate(name, nasty=False):
    m = _mod(name, "util.metrics")
    m.clear_registry()
    try:
        if nasty:
            h = m.Histogram("probe_latency_seconds",
                            description="escape probe",
                            boundaries=(0.1, 1.0),
                            tag_keys=("deployment", "outcome"))
            tags = {"deployment": 'llm "v2"\\canary\nblue',
                    "outcome": 'time\\out "hard"'}
            h.observe(0.05, tags=tags)
            h.observe(5.0, tags=tags)
            return m.aggregate({"w0": m.snapshot()})
        c = m.Counter("reqs_total", description="total requests",
                      tag_keys=("route",))
        c.inc(3, tags={"route": "/a"})
        c.inc(2, tags={"route": '/b "quoted"\nline'})
        g = m.Gauge("temp", description="temperature")
        g.set(36.6)
        h = m.Histogram("lat", description="latency",
                        boundaries=(0.1, 1.0, 10.0), tag_keys=("op",))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v, tags={"op": "get"})
        return m.aggregate({"w0": m.snapshot(), "w1": m.snapshot()})
    finally:
        m.clear_registry()


HW = [{"node": "a" * 32, "metric": "node_cpu_percent", "tags": {},
       "ts": 1.0, "value": 12.5},
      {"node": "a" * 32, "metric": "worker_rss_bytes",
       "tags": {"worker": "w12", "state": "idle"}, "ts": 1.0,
       "value": 4096.0},
      {"node": "b" * 32, "metric": "gpu_memory_used_bytes",
       "tags": {"worker": "w13", "device": "0"}, "ts": 1.0,
       "value": 17179869184.0}]


@pytest.mark.parametrize("nasty", [False, True], ids=["golden", "escaping"])
def test_prometheus_exposition_matches_jax(nasty):
    jp = _mod("ray_tpu", "util.prometheus")
    tp = _mod("ray_tpu_torch", "util.prometheus")
    agg = _aggregate("ray_tpu_torch", nasty)
    assert agg == _aggregate("ray_tpu", nasty)
    hw = None if nasty else HW
    text = tp.render(agg, hw)
    assert text == jp.render(agg, hw)
    assert tp.parse(text) == jp.parse(text)
    fams = tp.parse(text)
    if nasty:
        buckets = {s[1]["le"]: s[2]
                   for s in fams["probe_latency_seconds"]["samples"]
                   if s[0] == "probe_latency_seconds_bucket"}
        assert buckets == {"0.1": 1.0, "1": 1.0, "+Inf": 2.0}
        return
    buckets = {s[1]["le"]: s[2] for s in fams["lat"]["samples"]
               if s[0] == "lat_bucket"}
    assert buckets == {"0.1": 2.0, "1": 6.0, "10": 8.0, "+Inf": 10.0}
    assert fams["gpu_memory_used_bytes"]["samples"] == [
        ("gpu_memory_used_bytes",
         {"node": "b" * 12, "worker": "w13", "device": "0"},
         17179869184.0)]
    assert tp.sanitize_name("serve latency (s)") == "serve_latency__s_"


# ------------------------------------------------- live cluster surfaces


@pytest.fixture(scope="module", params=PACKAGES)
def crt(request):
    rt = importlib.import_module(request.param)
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024,
        "metrics_export_period_s": 0.2,
        "hw_sampler_period_s": 0.3,
    })
    yield rt, request.param
    rt.shutdown()


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.headers.get("Content-Type", ""), r.read()


def _dashboard(name):
    head_addr = _mod(name, "core.worker").global_worker.backend.head_addr
    return _mod(name, "dashboard").Dashboard(head_addr), head_addr


def test_dashboard_endpoints(crt):
    rt, name = crt

    @rt.remote
    class Pinger:
        def ping(self):
            return "pong"

    p = Pinger.remote()
    assert rt.get(p.ping.remote(), timeout=60) == "pong"
    dash, _ = _dashboard(name)
    base = f"http://127.0.0.1:{dash.port}"
    try:
        state = json.loads(_get(f"{base}/api/state")[1])
        assert state["nodes"] and any(a["class"] == "Pinger"
                                      for a in state["actors"])
        json.loads(_get(f"{base}/api/metrics")[1])
        json.loads(_get(f"{base}/api/timeline")[1])
        assert name.encode() in _get(f"{base}/")[1]
        assert json.loads(_get(f"{base}/api/jobs")[1]) == []
    finally:
        dash.stop()


def test_metrics_endpoint_smoke(crt):
    rt, name = crt
    prometheus = _mod(name, "util.prometheus")

    @rt.remote
    def work(i):
        return i * 2

    assert rt.get([work.remote(i) for i in range(8)], timeout=60) == \
        [i * 2 for i in range(8)]
    dash, _ = _dashboard(name)
    base = f"http://127.0.0.1:{dash.port}"
    try:
        deadline = time.monotonic() + 30
        fams = {}
        while time.monotonic() < deadline:
            ctype, body = _get(f"{base}/metrics")
            assert "text/plain" in ctype and "version=0.0.4" in ctype
            fams = prometheus.parse(body.decode())
            # the tasks of the module's earlier programs are counted
            # too: wait for these eight to land (a worker flushes every
            # metrics_export_period_s)
            counts = [s[2] for s in fams.get("submit_to_start", {})
                      .get("samples", ()) if s[0] == "submit_to_start_count"]
            if counts and counts[0] >= 8 and any(
                    f in fams for f in ("node_cpu_percent",
                                        "worker_rss_bytes",
                                        "node_mem_used_bytes")):
                break
            time.sleep(0.3)
        assert fams.get("submit_to_start", {}).get("type") == "histogram"
        samples = fams["submit_to_start"]["samples"]
        buckets = [(s[1]["le"], s[2]) for s in samples
                   if s[0] == "submit_to_start_bucket"]
        vals = [v for _, v in buckets]
        assert buckets and vals == sorted(vals)
        assert buckets[-1][0] == "+Inf"
        (n,) = [s[2] for s in samples if s[0] == "submit_to_start_count"]
        assert n >= 8 and buckets[-1][1] == n

        series = json.loads(_get(f"{base}/api/timeseries")[1])
        assert series and {"node", "metric", "tags", "points"} <= \
            set(series[0])
        metric = series[0]["metric"]
        filtered = json.loads(
            _get(f"{base}/api/timeseries?metric={metric}&last=1")[1])
        assert filtered and all(r["metric"] == metric
                                and len(r["points"]) == 1 for r in filtered)
        latest = json.loads(_get(f"{base}/api/timeseries?latest=1")[1])
        assert latest and all("value" in r and "ts" in r for r in latest)
    finally:
        dash.stop()


@pytest.mark.parametrize("crt", ["ray_tpu_torch"], indirect=True)
def test_card_memory_reaches_metrics_and_top(crt):
    """A worker's card memory samples (what ``gpu_memory_samples`` gives
    once a process holds a CUDA context) reach ``/metrics`` and ``top``
    for their node."""
    rt, name = crt
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.scripts import cli
    from ray_tpu_torch.util import prometheus

    backend = global_worker.backend
    node = backend.local_node_id
    tags = {"worker": "cardworker00", "device": "0"}
    backend.head.call("telemetry_push", {
        "worker": "cardworker" + "0" * 22, "node": node,
        "samples": [
            {"metric": "gpu_memory_used_bytes", "value": 17179869184.0,
             "tags": tags},
            {"metric": "gpu_memory_reserved_bytes", "value": 2.0 ** 35,
             "tags": tags},
            {"metric": "gpu_memory_limit_bytes", "value": 85899345920.0,
             "tags": tags}]}, timeout=10)
    dash, address = _dashboard(name)
    try:
        fams = prometheus.parse(_get(
            f"http://127.0.0.1:{dash.port}/metrics")[1].decode())
    finally:
        dash.stop()
    (used,) = fams["gpu_memory_used_bytes"]["samples"]
    assert used[1]["node"] == node[:12] and used[2] == 17179869184.0
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["top", "--address", address]) == 0
    row = next(ln for ln in buf.getvalue().splitlines()
               if ln.startswith(node[:12]))
    assert row.endswith("16.0GiB/80.0GiB"), row


@pytest.mark.parametrize("crt", ["ray_tpu_torch"], indirect=True)
def test_node_stats_and_profile(crt):
    rt, name = crt

    @rt.remote
    class Sleeper:
        def busy_wait(self, s):
            time.sleep(s)
            return "done"

    a = Sleeper.remote()
    assert rt.get(a.busy_wait.remote(0.0), timeout=60) == "done"
    ref = a.busy_wait.remote(4.0)
    dash, _ = _dashboard(name)
    base = f"http://127.0.0.1:{dash.port}"
    try:
        rows = json.loads(_get(f"{base}/api/nodes")[1])
        live = [r for r in rows if r["alive"]]
        st = live[0]["stats"]
        assert st["cpus"] >= 1 and st["mem_total"] > 0
        assert "store" in st and "capacity" in st["store"]
        assert [w for w in st["workers"] if w["rss"]], st["workers"]
        actor_workers = [w for w in st["workers"] if w["state"] == "actor"]
        assert actor_workers, st["workers"]
        found = False
        for w in actor_workers:
            prof = json.loads(_get(
                f"{base}/api/profile?node_id={live[0]['node_id']}"
                f"&worker_id={w['worker_id']}")[1])
            assert prof["num_threads"] >= 1
            if "busy_wait" in "\n".join(prof["stacks"].values()):
                found = True
        assert found, "no actor worker stack showed busy_wait"
    finally:
        dash.stop()
    assert rt.get(ref, timeout=60) == "done"


@pytest.mark.parametrize("name", PACKAGES)
def test_timeseries_dump_and_top_two_node_e2e(name):
    config_mod = _mod(name, "core.config")
    backend = _mod(name, "runtime.cluster_backend")
    RpcClient = _mod(name, "runtime.protocol").RpcClient
    RpcError = _mod(name, "runtime.protocol").RpcError
    cli = _mod(name, "scripts.cli")
    session = os.urandom(4).hex()
    head_proc, address = backend.start_head(session)
    old = config_mod.GlobalConfig.hw_sampler_period_s
    config_mod.GlobalConfig.hw_sampler_period_s = 0.3
    try:
        nodes = [backend.start_node(address, session,
                                    resources={"CPU": 1.0})
                 for _ in range(2)]
    finally:
        config_mod.GlobalConfig.hw_sampler_period_s = old
    probe = RpcClient(address, name="telemetry-e2e")
    try:
        deadline = time.monotonic() + 60
        sampled = set()
        while time.monotonic() < deadline and len(sampled) < 2:
            try:
                rows = probe.call("timeseries_dump",
                                  {"metric": "node_mem_used_bytes"},
                                  timeout=5)
                sampled = {r["node"] for r in rows}
            except RpcError:
                pass
            time.sleep(0.3)
        assert len(sampled) >= 2, sampled
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(["top", "--address", address]) == 0
        out = buf.getvalue()
        assert "NODE" in out and "MEM" in out and "nodes 2/2" in out
        for nid in sampled:
            assert nid[:12] in out, out
    finally:
        probe.close()
        for p in nodes + [head_proc]:
            p.terminate()
        for p in nodes + [head_proc]:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:   # slow to stop under load
                p.kill()
                p.wait(timeout=10)
