"""`python -m ray_tpu_torch` — cluster CLI.

The port of ``ray_tpu/scripts/cli.py``. Role-equivalent to the
reference's `ray` CLI (reference:
python/ray/scripts/scripts.py:89 — start/stop/status and the state-API
`ray list ...` family, python/ray/util/state/api.py:110). argparse instead
of click; the head's state_dump RPC is the single aggregation point
(reference: dashboard/state_aggregator.py collapses GCS+raylet sources the
same way).

Commands:
  start --head [--num-cpus N] [--num-gpus N] [--port P]
                                             boot a head (+ 1 node daemon)
  start --address H:P [--num-cpus N] [--num-gpus N]
                                             add a node daemon to a cluster
  status [--address H:P]                     cluster resources + nodes
  list {nodes,actors,workers,placement-groups,objects} [--address H:P]
  top [--watch] [--interval S]               node/worker hardware table
                                             (card memory per node)
  memory [--group-by node|owner] [--top N]   object-store directory + totals
  events [--follow] [--type T]               cluster event journal
  requests [--slowest N] [--live]            LLM request timelines
  trace [--request RID | --trace-id T]       span tree / request timeline
  stop [--address H:P]                       stop node daemons + head
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

ADDRESS_FILE = "head_address"


def _session_dir() -> str:
    from ray_tpu_torch.core.config import GlobalConfig
    return GlobalConfig.session_dir


def save_address(address: str) -> None:
    os.makedirs(_session_dir(), exist_ok=True)
    with open(os.path.join(_session_dir(), ADDRESS_FILE), "w") as f:
        f.write(address)


def load_address(explicit: Optional[str]) -> str:
    if explicit:
        return explicit
    env = os.environ.get("RTPT_ADDRESS")
    if env:
        return env
    path = os.path.join(_session_dir(), ADDRESS_FILE)
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        raise SystemExit(
            "no cluster address: pass --address, set RTPT_ADDRESS, or "
            "run `python -m ray_tpu_torch start --head` first") from None


def _client(address: str):
    from ray_tpu_torch.runtime.protocol import RpcClient
    return RpcClient(address, name="cli")


def cmd_start(args) -> int:
    from ray_tpu_torch.runtime.cluster_backend import start_head, start_node
    resources = {"CPU": float(args.num_cpus if args.num_cpus is not None
                              else (os.cpu_count() or 1))}
    # without --num-gpus the node daemon counts the machine's cards
    if args.num_gpus is not None:
        resources["GPU"] = float(args.num_gpus)
    if args.head:
        session = os.urandom(4).hex()
        head_proc, address = start_head(session, port=args.port or None)
        node_proc = start_node(address, session, resources=resources)
        save_address(address)
        print(f"head started at {address} "
              f"(head pid {head_proc.pid}, node pid {node_proc.pid})")
        print(f"connect with: ray_tpu_torch.init(address={address!r})")
        return 0
    address = load_address(args.address)
    client = _client(address)
    session = client.call("connect_driver", {}).get("session", "")
    from ray_tpu_torch.runtime.cluster_backend import start_node as _sn
    proc = _sn(address, session, resources=resources)
    deadline = time.monotonic() + 30
    known = time.monotonic()
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            print(f"node daemon exited rc={proc.returncode}",
                  file=sys.stderr)
            return 1
        time.sleep(0.2)
        nodes = client.call("list_nodes")
        if any(n["alive"] for n in nodes):
            break
    print(f"node daemon pid {proc.pid} joined {address}")
    return 0


def cmd_status(args) -> int:
    address = load_address(args.address)
    client = _client(address)
    total = client.call("cluster_resources")
    avail = client.call("available_resources")
    nodes = client.call("list_nodes")
    alive = [n for n in nodes if n["alive"]]
    print(f"cluster at {address}: {len(alive)}/{len(nodes)} nodes alive")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0.0):g}/{total[k]:g} available")
    return 0


def cmd_list(args) -> int:
    address = load_address(args.address)
    client = _client(address)
    dump = client.call("state_dump")
    if args.what == "nodes":
        rows = dump["nodes"]
    elif args.what == "actors":
        rows = dump["actors"]
    elif args.what == "placement-groups":
        rows = dump["placement_groups"]
    elif args.what == "workers":
        rows = []
        for n in dump["nodes"]:
            if not n["alive"]:
                continue
            try:
                for w in _client(n["address"]).call("list_workers"):
                    rows.append({"node_id": n["node_id"], **w})
            except Exception:
                pass
    elif args.what == "objects":
        # per-owner object tables (ownership model) + per-node arena stats
        rows = list(dump.get("objects", []))
        for n in dump["nodes"]:
            if not n["alive"]:
                continue
            try:
                st = _client(n["address"]).call("store_stats")
                rows.append({"node_id": n["node_id"], **st})
            except Exception:
                pass
    elif args.what == "tasks":
        rows = dump.get("tasks", [])
    else:
        raise SystemExit(f"unknown list target {args.what}")
    if args.format == "json":
        print(json.dumps(rows, indent=2, default=str))
    else:
        for r in rows:
            print("  ".join(f"{k}={v}" for k, v in r.items()))
    print(f"({len(rows)} {args.what})", file=sys.stderr)
    return 0


def cmd_metrics(args) -> int:
    address = load_address(args.address)
    agg = _client(address).call("metrics_dump")
    if args.format == "json":
        print(json.dumps(agg, indent=2, default=str))
        return 0
    for name, m in sorted(agg.items()):
        if m["type"] == "histogram":
            for k, v in m["values"].items():
                mean = v["sum"] / v["n"] if v["n"] else 0.0
                print(f"{name}{{{k}}}  n={v['n']} mean={mean:.6g}")
        else:
            for k, v in m["values"].items():
                print(f"{name}{{{k}}}  {v:g}")
    print(f"({len(agg)} metrics)", file=sys.stderr)
    return 0


def _hist_quantile(metrics: dict, name: str, q: float):
    """Quantile estimate from an aggregated histogram dump: counts sum
    across tag values, the answer is the UPPER BOUND of the bucket the
    quantile lands in (conservative; exact values aren't on the wire).
    None when the histogram is absent or empty."""
    m = metrics.get(name)
    if not m or m.get("type") != "histogram" or not m.get("values"):
        return None
    bounds = list(m.get("boundaries") or ())
    if not bounds:
        return None
    total = [0] * (len(bounds) + 1)
    for v in m["values"].values():
        for i, c in enumerate(v.get("counts") or ()):
            if i < len(total):
                total[i] += c
    n = sum(total)
    if n == 0:
        return None
    run = 0
    for i, c in enumerate(total):
        run += c
        if run >= q * n:
            # +Inf bucket: report the largest finite bound we know
            return bounds[min(i, len(bounds) - 1)]
    return bounds[-1]


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _render_top(client, address: str) -> str:
    """One frame of `top`: nodes with hardware gauges, worker rows under
    each node (data: state_dump + the newest hardware time-series point
    per series + aggregated app metrics)."""
    dump = client.call("state_dump", timeout=10)
    latest = client.call("timeseries_dump",
                         {"latest": True, "max_age_s": 30.0}, timeout=10)
    metrics = client.call("metrics_dump", timeout=10)

    node_gauges = {}   # node_id -> {metric: value}      (untagged series)
    workers = {}       # node_id -> {wid: {cpu, rss, state}}
    gpu_mem = {}       # node_id -> {device: {used, limit}}
    for s in latest:
        nid, metric, tags = s["node"], s["metric"], s.get("tags") or {}
        if metric in ("worker_cpu_percent", "worker_rss_bytes"):
            w = workers.setdefault(nid, {}).setdefault(
                tags.get("worker", "?"), {"state": tags.get("state", "")})
            w["cpu" if metric == "worker_cpu_percent" else "rss"] = \
                s["value"]
            if tags.get("state"):
                w["state"] = tags["state"]
        elif metric in ("gpu_memory_used_bytes", "gpu_memory_limit_bytes"):
            # device indices are process-local: key per (worker, device)
            # so two workers' card 0 don't collide in the per-node sum
            d = gpu_mem.setdefault(nid, {}).setdefault(
                (tags.get("worker", ""), tags.get("device", "?")), {})
            d["used" if metric == "gpu_memory_used_bytes" else "limit"] = \
                s["value"]
        elif metric == "gpu_memory_reserved_bytes":
            pass   # the caching allocator's pool: not what `top` shows
        elif not tags:
            node_gauges.setdefault(nid, {})[metric] = s["value"]

    qd = metrics.get("queue_depth", {}).get("values", {})
    queue_depth = sum(qd.values()) if qd else 0
    inflight = metrics.get("serve_inflight_requests", {}).get("values", {})

    def _gauge(name):
        vals = metrics.get(name, {}).get("values", {})
        return sum(vals.values()) if vals else None

    def _gauge_mean(name):
        # fraction-valued gauges (SLO attainment) MEAN across workers —
        # summing fractions over engines would overshoot 1.0
        vals = metrics.get(name, {}).get("values", {})
        return sum(vals.values()) / len(vals) if vals else None

    # LLM engine gauges (present when an InferenceEngine runs anywhere
    # on the cluster): one summary line mirroring what vLLM logs per step
    llm_decode = _gauge("llm_decode_tokens_per_s")
    llm_line = ""
    if llm_decode is not None:
        kv = _gauge("llm_kv_page_utilization") or 0.0
        hit = _gauge("llm_prefix_cache_hit_rate") or 0.0
        pf = _gauge("llm_prefill_tokens_per_s") or 0.0
        lq = _gauge("llm_queue_depth") or 0
        llm_line = (f"llm: decode {llm_decode:.0f} tok/s  "
                    f"prefill {pf:.0f} tok/s  kv_util {kv:.0%}  "
                    f"prefix_hit {hit:.0%}  queued {lq:g}")
        # request-level serving latencies from the flight-recorder
        # histograms (bucket upper bounds, hence the <=)
        ttft50 = _hist_quantile(metrics, "llm_ttft_seconds", 0.5)
        ttft99 = _hist_quantile(metrics, "llm_ttft_seconds", 0.99)
        tpot50 = _hist_quantile(metrics, "llm_tpot_seconds", 0.5)
        if ttft50 is not None and ttft99 is not None:
            llm_line += (f"  ttft p50<={ttft50 * 1e3:.0f}ms "
                         f"p99<={ttft99 * 1e3:.0f}ms")
        if tpot50 is not None:
            llm_line += f"  tpot p50<={tpot50 * 1e3:.1f}ms"
        slo_ttft = _gauge_mean("llm_slo_ttft_attainment")
        slo_tpot = _gauge_mean("llm_slo_tpot_attainment")
        if slo_ttft is not None and slo_tpot is not None:
            llm_line += (f"  slo ttft {slo_ttft:.0%} "
                         f"tpot {slo_tpot:.0%}")

    # object-store summary: used/cap from the hardware series, spill and
    # pull rates from the accounting counters (object_accounting=True)
    store_line = ""
    st_used = sum(v.get("object_store_used_bytes", 0)
                  for v in node_gauges.values())
    st_cap = sum(v.get("object_store_capacity_bytes", 0)
                 for v in node_gauges.values())
    spill_n = _gauge("object_store_spill_write_total")
    spill_b = _gauge("object_store_spill_write_bytes")
    pull_in = _gauge("object_store_pull_in_bytes")
    pull_out = _gauge("object_store_pull_out_bytes")
    infl = _gauge("object_store_fetch_inflight_count")
    if st_cap or spill_n is not None or pull_in is not None:
        store_line = (f"store: {_fmt_bytes(st_used)}/{_fmt_bytes(st_cap)}"
                      f"  spills {spill_n or 0:g}"
                      f" ({_fmt_bytes(spill_b or 0)})"
                      f"  pull in/out {_fmt_bytes(pull_in or 0)}/"
                      f"{_fmt_bytes(pull_out or 0)}"
                      f"  fetches {infl or 0:g}")
        p50 = _hist_quantile(metrics, "object_store_pull_seconds", 0.5)
        if p50 is not None:
            store_line += f"  pull p50<={p50 * 1e3:.0f}ms"
    nodes = dump["nodes"]
    alive = [n for n in nodes if n["alive"]]
    lines = [
        f"ray_tpu_torch top — {address}  "
        f"nodes {len(alive)}/{len(nodes)}  leases {dump.get('leases', 0)}  "
        f"queue_depth {queue_depth:g}"
        + (f"  serve_inflight {sum(inflight.values()):g}" if inflight
           else ""),
    ] + ([llm_line] if llm_line else []) \
      + ([store_line] if store_line else []) + [
        "",
        f"{'NODE':<14}{'ALIVE':<7}{'CPU%':>6}  {'MEM':>19}  "
        f"{'STORE':>19}  {'OBJS':>6}  {'GPU MEM':>19}",
    ]
    # series are keyed by the daemon's full node_id; state rows carry the
    # same id, but match by prefix so either side may be truncated
    def _series_for(table, node_id):
        for nid, v in table.items():
            if node_id.startswith(nid) or nid.startswith(node_id):
                return v
        return {}

    for n in sorted(nodes, key=lambda r: r["node_id"]):
        g = _series_for(node_gauges, n["node_id"])
        mem_u, mem_t = g.get("node_mem_used_bytes"), \
            g.get("node_mem_total_bytes")
        st_u, st_c = g.get("object_store_used_bytes"), \
            g.get("object_store_capacity_bytes")
        cpu = g.get("node_cpu_percent")
        devs = _series_for(gpu_mem, n["node_id"])
        if devs:
            used = sum(d.get("used", 0) for d in devs.values())
            limit = sum(d.get("limit", 0) for d in devs.values())
            mem_s = f"{_fmt_bytes(used)}/{_fmt_bytes(limit)}"
        else:
            mem_s = "-"
        lines.append(
            f"{n['node_id'][:12]:<14}"
            f"{('yes' if n['alive'] else 'NO'):<7}"
            f"{(f'{cpu:.1f}' if cpu is not None else '-'):>6}  "
            f"{(f'{_fmt_bytes(mem_u)}/{_fmt_bytes(mem_t)}' if mem_u is not None and mem_t else '-'):>19}  "
            f"{(f'{_fmt_bytes(st_u)}/{_fmt_bytes(st_c)}' if st_u is not None and st_c else '-'):>19}  "
            f"{g.get('object_store_num_objects', 0):>6g}  "
            f"{mem_s:>19}")
        rows = _series_for(workers, n["node_id"])
        for wid in sorted(rows):
            w = rows[wid]
            cpu_s = f"{w['cpu']:.1f}" if "cpu" in w else "-"
            rss_s = _fmt_bytes(w["rss"]) if "rss" in w else "-"
            lines.append(f"  {wid:<12}  {w.get('state', ''):<8}"
                         f"cpu {cpu_s:>6}  rss {rss_s:>9}")
    return "\n".join(lines)


def cmd_top(args) -> int:
    """Live node/worker hardware table (reference: `ray status` + the
    dashboard node view, as a terminal table over the head's hardware
    time-series rings)."""
    address = load_address(args.address)
    client = _client(address)
    if not args.watch:
        print(_render_top(client, address))
        return 0
    try:
        while True:
            frame = _render_top(client, address)
            # clear + home, then the frame — repaint without scrollback spam
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_profile(args) -> int:
    """Cluster-wide sampling profiles: merged collapsed stacks from the
    head's ProfileStore (continuous, every process at profile_hz), or a
    --record burst fanned out to head + node daemons + workers. Renders
    a self/cumulative top-frames table, --flame collapsed output
    (flamegraph.pl / speedscope paste), or --speedscope JSON."""
    from ray_tpu_torch.util.stack_profiler import (merge_stacks, to_speedscope,
                                             top_frames)
    address = load_address(args.address)
    payload = {"role": "head" if args.head else "",
               "node": args.node or "", "worker": args.worker or ""}
    client = _client(address)
    if args.record:
        payload.update({"seconds": args.record, "hz": args.hz})
        data = client.call("profiles_record", payload,
                           timeout=args.record + 30.0)
    else:
        data = client.call("profiles_dump", payload, timeout=10)
    procs = (data or {}).get("procs") or []
    if args.format == "json":
        print(json.dumps(data, indent=2, default=str))
        return 0
    stacks = merge_stacks([p.get("stacks") for p in procs])
    samples = sum(int(p.get("samples") or 0) for p in procs)
    dropped = sum(int(p.get("dropped") or 0) for p in procs)
    if args.flame:
        for stack, count in sorted(stacks.items(),
                                   key=lambda kv: (-kv[1], kv[0])):
            print(f"{stack} {count}")
        return 0
    if args.speedscope is not None:
        name = "ray_tpu_torch burst" if args.record else "ray_tpu_torch continuous"
        out = json.dumps(to_speedscope(stacks, name=name))
        if args.speedscope == "-":
            print(out)
        else:
            with open(args.speedscope, "w") as f:
                f.write(out)
            print(f"wrote {args.speedscope} ({len(stacks)} stacks, "
                  f"{samples} samples)", file=sys.stderr)
        return 0
    if not procs:
        print("no profiles yet — is profile_enabled on, and has a "
              "telemetry flush landed? (try --record 2)")
        return 1
    mode = (f"burst {args.record:g}s @ {args.hz:g}Hz" if args.record
            else "continuous")
    print(f"{len(procs)} process(es), {samples} samples"
          + (f" ({dropped} dropped on table overflow)" if dropped else "")
          + f"  [{mode}]")
    for r in sorted(procs, key=lambda r: -(r.get("samples") or 0)):
        where = r.get("node") or ""
        label = r.get("role") or "?"
        ident = r.get("worker") or r.get("key", "")[:12]
        print(f"  {label:<7}{ident:<14}node={where or '-':<14}"
              f"samples={r.get('samples', 0):<8}"
              f"window={r.get('window_s', 0.0):g}s")
    print()
    print(f"{'self':>7} {'self%':>6} {'cum':>7} {'cum%':>6}  frame")
    for row in top_frames(stacks, args.top):
        sp = 100.0 * row["self"] / max(1, samples)
        cp = 100.0 * row["cum"] / max(1, samples)
        print(f"{row['self']:>7} {sp:>5.1f}% {row['cum']:>7} "
              f"{cp:>5.1f}%  {row['frame']}")
    return 0


def cmd_memory(args) -> int:
    """Cluster object-store directory: every tracked object with size,
    role (primary/secondary/spilled), owner, age and pin counts, grouped
    per node or per owner, plus exact per-node arena totals (reference:
    `ray memory`, python/ray/util/state/memory_utils.py — theirs walks
    core-worker ref tables; ours rides the owners' telemetry_push)."""
    address = load_address(args.address)
    client = _client(address)
    od = client.call("objects_dump", timeout=10) or {}
    rows = list(od.get("rows", ()))
    totals = od.get("totals", {})
    if args.format == "json":
        print(json.dumps({"rows": rows, "totals": totals},
                         indent=2, default=str))
        return 0
    # leak heuristic: a PRIMARY that has sat in the arena past --leak-age
    # with no live references at its owner (or whose owner process no
    # longer reports at all) is probably a leaked ObjectRef. Heuristic
    # only: drivers legitimately hold old pinned results.
    reporters = {r.get("reporter", "") for r in rows}
    leaks = 0
    for r in rows:
        pins = r.get("pins")
        unreferenced = (pins is not None
                        and not (pins.get("local") or pins.get("submitted")
                                 or pins.get("borrowers")))
        orphaned = pins is None and r.get("owner", "") not in reporters
        r["_leak"] = bool(r.get("role") == "primary"
                          and r.get("age_s", 0) > args.leak_age
                          and (unreferenced or orphaned))
        leaks += r["_leak"]
    key = "node" if args.group_by == "node" else "owner"
    groups = {}
    for r in rows:
        groups.setdefault(str(r.get(key, "?")), []).append(r)
    n_bytes = sum(r.get("size", 0) for r in rows)
    print(f"object store @ {address}: {len(rows)} object(s), "
          f"{_fmt_bytes(n_bytes)} tracked"
          + (f", {leaks} LEAK suspect(s)" if leaks else ""))
    for gid in sorted(groups):
        rs = sorted(groups[gid], key=lambda r: -r.get("size", 0))
        gb = sum(r.get("size", 0) for r in rs)
        print(f"\n{key} {gid[:12]}  "
              f"({len(rs)} object(s), {_fmt_bytes(gb)})")
        if key == "node":
            for role, t in sorted((totals.get(gid) or {}).items()):
                print(f"  {role:<10} count={t['count']} "
                      f"bytes={t['bytes']} arena_bytes={t['arena_bytes']}")
        for r in rs[:args.top]:
            pins = r.get("pins")
            pin_s = (f"l{pins['local']}/s{pins['submitted']}"
                     f"/b{pins['borrowers']}" if pins else "-")
            print(f"  {str(r.get('object_id', '?'))[:16]:<18}"
                  f"{_fmt_bytes(r.get('size', 0)):>10}  "
                  f"{r.get('role', '?'):<10}"
                  f"owner={str(r.get('owner', '?')):<14}"
                  f"age={r.get('age_s', 0):>7.1f}s  pins={pin_s}"
                  + ("  LEAK?" if r.get("_leak") else ""))
        if len(rs) > args.top:
            print(f"  ... {len(rs) - args.top} more")
    if not rows:
        print("(no object directory rows at the head yet — owners flush "
              "every metrics_export_period_s; object_accounting on?)")
    return 0


def _fmt_event(ev: dict) -> str:
    ts = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
    ms = int((ev.get("ts", 0) % 1) * 1000)
    extras = "  ".join(
        f"{k}={v}" for k, v in sorted(ev.items())
        if k not in ("seq", "ts", "type", "trace_id"))
    trace = f"  trace={ev['trace_id']}" if ev.get("trace_id") else ""
    return (f"#{ev.get('seq', 0):<6} {ts}.{ms:03d}  "
            f"{ev.get('type', '?'):<22} {extras}{trace}")


def cmd_events(args) -> int:
    """Head's cluster event journal: node register/dead, worker death
    (exit cause), actor restart/dead, spill overflow, lease-grant
    failures, autoscaler decisions — monotonically sequenced and
    trace-id stamped (reference: `ray list cluster_events` over the GCS
    event journal; src/ray/gcs keeps the same bounded ring)."""
    address = load_address(args.address)
    client = _client(address)
    if not args.follow:
        evs = client.call("events_dump",
                          {"type": args.type or "",
                           "limit": int(args.limit or 0)}, timeout=10)
        if args.format == "json":
            print(json.dumps(evs, indent=2, default=str))
            return 0
        for ev in evs:
            print(_fmt_event(ev))
        print(f"({len(evs)} event(s))", file=sys.stderr)
        return 0
    after = 0
    frames = args.frames  # hidden test hook: bounded poll count
    try:
        while True:
            evs = client.call("events_dump",
                              {"after_seq": after,
                               "type": args.type or ""}, timeout=10)
            for ev in evs:
                print(_fmt_event(ev))
                after = max(after, int(ev.get("seq", 0)))
            sys.stdout.flush()
            if frames is not None:
                frames -= 1
                if frames <= 0:
                    break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def _logs_payload(args) -> dict:
    return {
        "role": "head" if getattr(args, "head", False) else "",
        "node": args.node or "",
        "worker": args.worker or "",
        "level": args.level or "",
        "since": float(args.since or 0.0),
        "grep": args.grep or "",
        "trace": args.trace or "",
        "request": args.request or "",
    }


def cmd_logs(args) -> int:
    """Search (or follow) the head's cluster-wide structured log store:
    every process's recent records, severity-ring bounded, filterable by
    node/worker/role/level/regex and correlated by trace or request id
    (reference: `ray logs` over the per-session log directory; here the
    records also ride telemetry_push into a head-side ring so the CLI
    works without reaching into each node's filesystem)."""
    from ray_tpu_torch.util.log_plane import format_record
    address = load_address(args.address)
    client = _client(address)
    if not args.follow:
        payload = _logs_payload(args)
        payload["limit"] = int(args.limit or 0)
        data = client.call("logs_dump", payload, timeout=10)
        if args.format == "json":
            print(json.dumps(data, indent=2, default=str))
            return 0
        recs = data.get("records", [])
        for rec in recs:
            print(format_record(rec))
        dropped = data.get("dropped_total", 0)
        note = f", {dropped} dropped at sources" if dropped else ""
        print(f"({len(recs)} record(s){note})", file=sys.stderr)
        return 0
    after = 0
    frames = args.frames  # hidden test hook: bounded poll count
    try:
        while True:
            payload = _logs_payload(args)
            payload["after_seq"] = after
            data = client.call("logs_dump", payload, timeout=10)
            for rec in data.get("records", []):
                print(format_record(rec))
                after = max(after, int(rec.get("seq", 0)))
            after = max(after, int(data.get("last_seq", 0)))
            sys.stdout.flush()
            if frames is not None:
                frames -= 1
                if frames <= 0:
                    break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def _compiles_payload(args) -> dict:
    return {
        "role": "",
        "node": args.node or "",
        "worker": args.worker or "",
        "callable": args.callable or "",
        "recompiles_only": bool(args.recompiles),
        "by_callable": bool(args.by_callable),
        "limit": int(args.limit or 0),
    }


def _fmt_compile_record(rec: dict) -> str:
    ts = time.strftime("%H:%M:%S", time.localtime(rec.get("ts", 0)))
    dur = rec.get("measured_s") or rec.get("duration_s") or 0.0
    name = rec.get("name") or "<unattributed>"
    mark = "RECOMPILE " if rec.get("recompile") else ""
    sig = rec.get("signature") or []
    sig_s = ", ".join(sig[:6]) + (", ..." if len(sig) > 6 else "")
    line = (f"{ts}  {rec.get('role', '?'):<7}"
            f"{(rec.get('worker') or '')[:12]:<13}"
            f"{mark}{name}  [{rec.get('kind', '?')}] {dur * 1e3:.1f}ms"
            f"  ({sig_s})")
    for d in rec.get("diff") or []:
        line += f"\n           diff {d}"
    return line


#: what `compiles` prints before any record reached the head
_NO_COMPILES = ("no compile records at the head (the engine's step "
                "functions and CompiledDAG flush every "
                "metrics_export_period_s; is compile_tracker_enabled on?)")


def _render_compiles(client, args) -> str:
    data = client.call("compiles_dump", _compiles_payload(args),
                       timeout=10)
    if args.format == "json":
        return json.dumps(data, indent=2, default=str)
    lines = []
    if args.by_callable:
        agg = data.get("by_callable") or {}
        if not agg:
            return _NO_COMPILES
        lines.append(f"{'callable':<28} {'compiles':>8} {'recompiles':>10}"
                     f" {'seconds':>9} {'procs':>6}  last signature")
        rows = sorted(agg.items(),
                      key=lambda kv: (-kv[1]["recompiles"],
                                      -kv[1]["seconds"]))
        for name, a in rows:
            sig = a.get("last_sig") or []
            sig_s = ", ".join(sig[:4]) + (", ..." if len(sig) > 4 else "")
            lines.append(f"{name:<28} {a['compiles']:>8}"
                         f" {a['recompiles']:>10} {a['seconds']:>9.3f}"
                         f" {a['procs']:>6}  ({sig_s})")
            for d in a.get("last_diff") or []:
                lines.append(f"{'':<28} diff {d}")
    else:
        recs = data.get("records", [])
        if not recs:
            return _NO_COMPILES
        for rec in recs:
            lines.append(_fmt_compile_record(rec))
    dropped = data.get("dropped_total", 0)
    note = f", {dropped} dropped" if dropped else ""
    lines.append(f"({data.get('procs', 0)} process(es){note})")
    return "\n".join(lines)


def cmd_compiles(args) -> int:
    """Compile records aggregated at the head (per-process rings fed by
    telemetry_push; util/compile_tracker.py, fed by the engine's step
    functions and ``CompiledDAG``'s graph captures): every compile with
    its callable, arg shape/dtype signature and duration — recompiles
    flagged with the exact signature diff that caused them. --storms
    lists the journal's once-per-excursion compile_storm events."""
    address = load_address(args.address)
    client = _client(address)
    if args.storms:
        evs = client.call("events_dump",
                          {"type": "compile_storm",
                           "limit": int(args.limit or 0)}, timeout=10)
        if args.format == "json":
            print(json.dumps(evs, indent=2, default=str))
            return 0
        for ev in evs:
            print(_fmt_event(ev))
        print(f"({len(evs)} storm(s))", file=sys.stderr)
        return 0
    if not args.watch:
        print(_render_compiles(client, args))
        return 0
    frames = args.frames  # hidden test hook: bounded repaint count
    try:
        while True:
            frame = _render_compiles(client, args)
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            if frames is not None:
                frames -= 1
                if frames <= 0:
                    break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def _fmt_ms(v) -> str:
    return f"{v * 1e3:.1f}ms" if v is not None else "-"


def format_request_timeline(r: dict, indent: str = "") -> str:
    """Render one flight-recorder record (wire dict) as a lifecycle
    timeline: enqueue -> admit (queue wait, cached tokens) -> prefill
    chunks -> first token (TTFT) -> decode -> finish reason."""
    p = indent
    where = ""
    if r.get("worker") or r.get("node"):
        where = f"  @{r.get('worker', '')}" \
                + (f"/{r['node'][:12]}" if r.get("node") else "")
    trace = f"  trace {r['trace_id']}" if r.get("trace_id") else ""
    status = r.get("finish_reason") or "in-flight"
    lines = [f"{p}{r.get('rid', '?')}  [{status}]{where}{trace}"]
    lines.append(f"{p}  enqueue   +0.0ms  "
                 f"(prompt {r.get('prompt_tokens', 0)} tok, "
                 f"max_new {r.get('max_new_tokens', 0)})")
    admits = r.get("admits") or []
    for i, (ts, cached) in enumerate(admits):
        tag = "" if len(admits) == 1 else f" #{i + 1}"
        lines.append(f"{p}  admit{tag}     +{ts * 1e3:.1f}ms  "
                     f"(queue wait {_fmt_ms(r.get('queue_wait')) if i == 0 else _fmt_ms(ts)}, "
                     f"cached {cached} tok)")
    chunks = r.get("chunks") or []
    if chunks:
        toks = "+".join(str(c[1]) for c in chunks[:8]) \
            + ("+..." if len(chunks) > 8 else "")
        disp = sorted({c[2] for c in chunks})
        disp_s = f"{disp[0]}..{disp[-1]}" if len(disp) > 1 else f"{disp[0]}"
        lines.append(f"{p}  prefill   {len(chunks)} chunk(s) "
                     f"[{toks} tok]  dispatch {disp_s}  "
                     f"last +{chunks[-1][0] * 1e3:.1f}ms")
    if r.get("ttft") is not None:
        lines.append(f"{p}  first tok +{r['ttft'] * 1e3:.1f}ms  (TTFT)")
    n_out = r.get("n_generated", 0)
    if n_out > 1 and r.get("tpot"):
        tpot = r["tpot"]
        lines.append(f"{p}  decode    {n_out} tok in "
                     f"{len(r.get('decode') or [])} dispatch(es)  "
                     f"tpot {tpot * 1e3:.2f}ms  "
                     f"({1.0 / tpot:.0f} tok/s)")
    extras = []
    if r.get("stalls"):
        extras.append(f"stalls {r['stalls']}")
    if r.get("preempts"):
        extras.append(f"preempts {r['preempts']} "
                      f"(at {', '.join(f'+{t * 1e3:.1f}ms' for t in r.get('preempt_ts', []))})")
    if extras:
        lines.append(f"{p}  pressure  " + "  ".join(extras))
    if r.get("e2e") is not None:
        lines.append(f"{p}  finish    +{r['e2e'] * 1e3:.1f}ms  "
                     f"reason={r.get('finish_reason')}")
    return "\n".join(lines)


def _render_requests(client, args) -> str:
    payload = {"slowest": int(getattr(args, "slowest", 0) or 0)}
    recs = client.call("requests_dump", payload, timeout=10)
    if not recs:
        return ("no request records at the head (engines flush every "
                "metrics_export_period_s; is the recorder enabled?)")
    if getattr(args, "format", "plain") == "json":
        return json.dumps(recs, indent=2, default=str)
    head = "slowest " if payload["slowest"] else ""
    out = [f"{len(recs)} {head}request(s)", ""]
    out += [format_request_timeline(r) + "\n" for r in recs]
    return "\n".join(out).rstrip("\n")


def cmd_requests(args) -> int:
    """Per-request serving timelines from the engines' flight recorders,
    aggregated at the head (requests_dump RPC over telemetry_push)."""
    address = load_address(args.address)
    client = _client(address)
    if not args.live:
        print(_render_requests(client, args))
        return 0
    frames = args.frames  # hidden test hook: bounded repaint count
    try:
        while True:
            frame = _render_requests(client, args)
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            if frames is not None:
                frames -= 1
                if frames <= 0:
                    break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_timeline(args) -> int:
    from ray_tpu_torch.runtime.events import to_chrome_trace
    address = load_address(args.address)
    events = _client(address).call("timeline_dump")
    trace = to_chrome_trace(events)
    out = args.out or "ray_tpu_torch_timeline.json"
    with open(out, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace)} events to {out} "
          "(load in chrome://tracing or ui.perfetto.dev)")
    return 0


def _render_train_step(step: dict, fmt: str) -> int:
    """Phase table for one profiled train step (trace --train-step)."""
    total_ms = max(0.0, step["end"] - step["start"]) * 1e3
    if fmt == "json":
        print(json.dumps(step, indent=2, default=str))
        return 0
    print(f"train step  {total_ms:.2f}ms  (trace {step['trace_id']})")
    print(f"  {'phase':<16} {'ms':>10} {'% of step':>10}")
    for c in step.get("children", []):
        dur_ms = max(0.0, c["end"] - c["start"]) * 1e3
        pct = 100.0 * dur_ms / total_ms if total_ms else 0.0
        print(f"  {c['name']:<16} {dur_ms:>10.2f} {pct:>9.1f}%")
    return 0


def cmd_trace(args) -> int:
    """Assemble one distributed trace from the head's timeline and print
    it as an indented span tree (or JSON)."""
    from ray_tpu_torch.util.tracing import assemble_trace, latest_train_step
    address = load_address(args.address)
    client = _client(address)
    events = client.call("timeline_dump")
    if getattr(args, "perfetto", ""):
        # multi-plane export: task spans + train phases + LLM request
        # timelines + compile events + journal markers as named
        # lanes on one wall clock (runtime/events.to_perfetto)
        from ray_tpu_torch.runtime.events import to_perfetto
        compiles = []
        requests = []
        journal = []
        try:
            compiles = client.call("compiles_dump", {},
                                   timeout=10).get("records", [])
        except Exception:  # noqa: BLE001 — lane degrades to empty
            pass
        try:
            requests = client.call("requests_dump", {}, timeout=10) or []
        except Exception:  # noqa: BLE001
            pass
        try:
            journal = client.call("events_dump", {}, timeout=10) or []
        except Exception:  # noqa: BLE001
            pass
        trace = to_perfetto(events, compiles=compiles,
                            requests=requests, journal=journal)
        with open(args.perfetto, "w") as f:
            json.dump(trace, f)
        n = len(trace["traceEvents"])
        lanes = sum(1 for e in trace["traceEvents"]
                    if e.get("ph") == "M"
                    and e.get("name") == "process_name")
        print(f"wrote {n} events across {lanes} lanes to "
              f"{args.perfetto} (load in ui.perfetto.dev)")
        return 0
    if getattr(args, "request", ""):
        # merged view for one LLM request: the router/replica span tree
        # (via the trace_id the record carries) + the engine's
        # flight-recorder timeline under it
        recs = client.call("requests_dump", {"request": args.request},
                           timeout=10)
        if not recs:
            print(f"no request record for {args.request!r} (records "
                  "reach the head on the engine worker's next telemetry "
                  "flush)", file=sys.stderr)
            return 1
        rec = recs[0]
        tid = rec.get("trace_id") or args.trace_id
        roots = assemble_trace(events, trace_id=tid) if tid else []
        # log lines stamped with this request id (or its trace id) from
        # the head's structured log store, interleaved under the render
        logs = []
        try:
            data = client.call("logs_dump", {"request": args.request},
                               timeout=10)
            logs = data.get("records", [])
            if tid:
                data = client.call("logs_dump", {"trace": tid},
                                   timeout=10)
                have = {(r.get("seq"), r.get("pid")) for r in logs}
                logs += [r for r in data.get("records", [])
                         if (r.get("seq"), r.get("pid")) not in have]
            logs.sort(key=lambda r: r.get("ts", 0))
        except Exception:
            logs = []
        if args.format == "json":
            print(json.dumps({"record": rec, "spans": roots,
                              "logs": logs}, indent=2, default=str))
            return 0
        print(f"request {rec['rid']}  trace {tid or '-'}")
        for r in roots:
            _show_span(r, 1)
        if not roots:
            print("  (no spans for this trace yet — the router's "
                  "telemetry flush may still be pending)")
        print(format_request_timeline(rec, indent="  "))
        if logs:
            from ray_tpu_torch.util.log_plane import format_record
            print(f"  logs ({len(logs)} correlated line(s)):")
            for lrec in logs:
                print(f"    {format_record(lrec)}")
        return 0
    if getattr(args, "train_step", False):
        step = latest_train_step(events)
        if step is None:
            print("no train_step spans in the timeline (run "
                  "train.profile_train_step, then wait for the worker's "
                  "telemetry flush)", file=sys.stderr)
            return 1
        return _render_train_step(step, args.format)
    roots = assemble_trace(events, trace_id=args.trace_id or "",
                           task_id=args.task_id or "")
    if not roots:
        hint = args.trace_id or args.task_id or "<missing selector>"
        print(f"no spans found for {hint} "
              "(pass --trace-id or --task-id; spans appear after the "
              "owners' next telemetry flush)", file=sys.stderr)
        return 1
    if args.format == "json":
        print(json.dumps(roots, indent=2, default=str))
        return 0
    print(f"trace {roots[0]['trace_id']}")

    n = 0

    def count(span):
        nonlocal n
        n += 1
        for c in span["children"]:
            count(c)
    for r in roots:
        _show_span(r, 0)
        count(r)
    print(f"({n} spans)", file=sys.stderr)
    return 0


def _show_span(span, depth) -> None:
    dur_ms = max(0.0, span["end"] - span["start"]) * 1e3
    mark = "" if span.get("ok", True) else "  [FAILED]"
    where = span.get("worker", "")
    where = f" @{where}" if where else ""
    print(f"{'  ' * depth}- {span['name']}  {dur_ms:.2f}ms"
          f"{where}{mark}  span={span['span_id']}")
    for c in span["children"]:
        _show_span(c, depth + 1)


def cmd_dashboard(args) -> int:
    from ray_tpu_torch.dashboard import Dashboard
    address = load_address(args.address)
    dash = Dashboard(address, port=args.port)
    print(f"dashboard at http://127.0.0.1:{dash.port} (ctrl-c to stop)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        dash.stop()
    return 0


def cmd_stop(args) -> int:
    address = load_address(args.address)
    client = _client(address)
    nodes = client.call("list_nodes")
    for n in nodes:
        if not n["alive"]:
            continue
        try:
            _client(n["address"]).call("shutdown", timeout=5.0)
        except Exception:
            pass
    print(f"stopped {sum(1 for n in nodes if n['alive'])} node daemon(s); "
          "head left running (kill its pid to stop fully)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="boot a head or join a cluster")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address")
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.add_argument("--num-gpus", type=int, default=None,
                    help="cards the node advertises (default: the "
                         "machine's, from CUDA_VISIBLE_DEVICES or the "
                         "driver)")
    sp.add_argument("--port", type=int, default=None)
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("status", help="cluster resources and nodes")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("what", choices=["nodes", "actors", "workers",
                                     "placement-groups", "objects",
                                     "tasks"])
    sp.add_argument("--address")
    sp.add_argument("--format", choices=["plain", "json"], default="plain")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("metrics", help="aggregated application metrics")
    sp.add_argument("--address")
    sp.add_argument("--format", choices=["plain", "json"], default="plain")
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser("top", help="node/worker hardware table "
                                    "(cpu/rss/card memory/store)")
    sp.add_argument("--address")
    sp.add_argument("--watch", action="store_true",
                    help="repaint continuously until ctrl-c")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser("profile",
                        help="cluster-wide sampling profiles: top hot "
                             "frames, --flame collapsed stacks, or "
                             "--speedscope JSON (continuous, or an "
                             "on-demand --record burst)")
    sp.add_argument("--address")
    sp.add_argument("--head", action="store_true",
                    help="only the head process")
    sp.add_argument("--node", help="only processes on this node id "
                                   "(prefix match)")
    sp.add_argument("--worker", help="only this worker id (prefix match)")
    sp.add_argument("--record", type=float, default=0.0,
                    metavar="SECONDS",
                    help="burst-capture for SECONDS at --hz across the "
                         "selected processes instead of reading the "
                         "continuous profile")
    sp.add_argument("--hz", type=float, default=99.0,
                    help="burst sampling rate (with --record)")
    sp.add_argument("--top", type=int, default=20,
                    help="rows in the frame table")
    sp.add_argument("--flame", action="store_true",
                    help="print merged collapsed stacks ('stack N' "
                         "lines; flamegraph.pl / speedscope input)")
    sp.add_argument("--speedscope", metavar="FILE",
                    help="write speedscope JSON to FILE ('-' = stdout)")
    sp.add_argument("--format", choices=["plain", "json"],
                    default="plain")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("memory",
                        help="object-store directory: per-object rows "
                             "(size, role, owner, pins) + per-node arena "
                             "totals and a leak heuristic")
    sp.add_argument("--address")
    sp.add_argument("--group-by", choices=["node", "owner"],
                    default="node", dest="group_by")
    sp.add_argument("--top", type=int, default=10,
                    help="largest N objects per group")
    sp.add_argument("--leak-age", type=float, default=300.0,
                    help="flag unreferenced primaries older than this (s)")
    sp.add_argument("--format", choices=["plain", "json"], default="plain")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("events",
                        help="cluster event journal (node/worker/actor "
                             "lifecycle, spill overflow, lease failures, "
                             "autoscaler decisions)")
    sp.add_argument("--address")
    sp.add_argument("--type", default="",
                    help="only events of this type (e.g. worker_death)")
    sp.add_argument("--limit", type=int, default=0,
                    help="newest N events only")
    sp.add_argument("--follow", action="store_true",
                    help="poll for new events until ctrl-c")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--frames", type=int, default=None,
                    help=argparse.SUPPRESS)  # test hook: bounded polls
    sp.add_argument("--format", choices=["plain", "json"], default="plain")
    sp.set_defaults(fn=cmd_events)

    sp = sub.add_parser("logs",
                        help="search the cluster-wide structured log "
                             "store (per-process rings at the head): "
                             "filter by node/worker/level/regex, "
                             "correlate by --trace / --request, or "
                             "--follow live")
    sp.add_argument("--address")
    sp.add_argument("--follow", action="store_true",
                    help="poll for new records until ctrl-c")
    sp.add_argument("--grep", default="",
                    help="only records whose message matches this regex")
    sp.add_argument("--level", default="",
                    help="severity floor (debug/info/warning/error)")
    sp.add_argument("--node", default="",
                    help="only processes on this node id (prefix match)")
    sp.add_argument("--worker", default="",
                    help="only this worker id (prefix match)")
    sp.add_argument("--head", action="store_true",
                    help="only the head process")
    sp.add_argument("--trace", default="",
                    help="only records stamped with this trace id")
    sp.add_argument("--request", default="",
                    help="only records stamped with this LLM request id")
    sp.add_argument("--since", type=float, default=0.0,
                    help="only records newer than this unix timestamp")
    sp.add_argument("--limit", type=int, default=0,
                    help="newest N records only")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--frames", type=int, default=None,
                    help=argparse.SUPPRESS)  # test hook: bounded polls
    sp.add_argument("--format", choices=["plain", "json"], default="plain")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser("compiles",
                        help="compile records aggregated at the "
                             "head: callable, arg signature, duration; "
                             "recompiles carry the signature diff that "
                             "caused them (util/compile_tracker.py)")
    sp.add_argument("--address")
    sp.add_argument("--node", default="",
                    help="only processes on this node id (prefix match)")
    sp.add_argument("--worker", default="",
                    help="only this worker id (prefix match)")
    sp.add_argument("--callable", default="",
                    help="only compiles of callables matching this "
                         "substring (e.g. llm. or train.)")
    sp.add_argument("--recompiles", action="store_true",
                    help="only recompiles (same callable, new arg "
                         "signature — each carries its diff)")
    sp.add_argument("--by-callable", action="store_true",
                    dest="by_callable",
                    help="aggregate per callable: compiles, recompiles, "
                         "total seconds, processes")
    sp.add_argument("--storms", action="store_true",
                    help="list compile_storm journal events (one per "
                         "recompile-rate excursion)")
    sp.add_argument("--watch", action="store_true",
                    help="repaint continuously until ctrl-c")
    sp.add_argument("--limit", type=int, default=0,
                    help="newest N records only")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--frames", type=int, default=None,
                    help=argparse.SUPPRESS)  # test hook: bounded repaints
    sp.add_argument("--format", choices=["plain", "json"], default="plain")
    sp.set_defaults(fn=cmd_compiles)

    sp = sub.add_parser("timeline", help="export task timeline "
                                         "(chrome trace)")
    sp.add_argument("--address")
    sp.add_argument("--out")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("trace", help="assemble one distributed trace "
                                      "as a span tree")
    sp.add_argument("--address")
    sp.add_argument("--trace-id", default="")
    sp.add_argument("--task-id", default="",
                    help="resolve the trace via this task's exec span")
    sp.add_argument("--train-step", action="store_true",
                    help="show the latest profiled train step's phase "
                         "breakdown (train.profile_train_step)")
    sp.add_argument("--request", default="",
                    help="merged timeline for one LLM request id: router/"
                         "replica spans + the engine's flight-recorder "
                         "lifecycle events")
    sp.add_argument("--perfetto", default="", metavar="OUT",
                    help="write a unified multi-plane Perfetto trace to "
                         "OUT: task spans, train phases, LLM request "
                         "timelines, compiles and journal markers "
                         "as named lanes on one clock")
    sp.add_argument("--format", choices=["plain", "json"], default="plain")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("requests",
                        help="per-request LLM serving timelines (queue "
                             "wait, prefill chunks, TTFT, decode tok/s, "
                             "finish reason)")
    sp.add_argument("--address")
    sp.add_argument("--slowest", type=int, default=0,
                    help="only the N worst end-to-end latencies")
    sp.add_argument("--live", action="store_true",
                    help="repaint continuously until ctrl-c")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--frames", type=int, default=None,
                    help=argparse.SUPPRESS)  # test hook: bounded repaints
    sp.add_argument("--format", choices=["plain", "json"], default="plain")
    sp.set_defaults(fn=cmd_requests)

    sp = sub.add_parser("dashboard", help="serve the HTTP dashboard")
    sp.add_argument("--address")
    sp.add_argument("--port", type=int, default=8265)
    sp.set_defaults(fn=cmd_dashboard)

    sp = sub.add_parser("stop", help="stop node daemons")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_stop)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
