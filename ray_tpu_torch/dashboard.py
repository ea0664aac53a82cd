"""Dashboard — HTTP view over cluster state.

Role-equivalent (minimal) to the reference's dashboard head (reference:
dashboard/head.py + http_server_head.py + state_aggregator.py): a JSON
REST server over the head's state/metrics/timeline/jobs tables plus a
single-page HTML summary, plus the reference's per-node agent surface
(node stats from /proc, on-demand worker stack profiles) served by the
node daemons directly instead of separate agent processes. The React
frontend and Grafana integration are out of scope — the data surface is
what the `ray list`/state-API parity needs.

The port of ``ray_tpu/dashboard.py`` (stdlib ``http.server``, no client
package). ``/metrics`` carries each card's memory (``gpu_memory_*``, from
the workers that hold a CUDA context) beside the node gauges.

Endpoints:
  GET /            html summary
  GET /metrics     Prometheus text exposition (application metrics with
                   cumulative-le histogram buckets + the newest hardware
                   gauges per node — scrape this)
  GET /api/state   state_dump (nodes, actors, leases, placement groups)
  GET /api/metrics aggregated metrics
  GET /api/timeseries?node=N&metric=M&last=K&latest=1
                   hardware time-series rings (per node x metric; fed by
                   the node daemons' 2s samplers)
  GET /api/requests?live=1&slowest=N&request=RID
                   LLM request flight-recorder records (per-request
                   lifecycle timelines aggregated at the head)
  GET /api/objects  per-object directory rows + exact per-node arena
                   totals (`ray memory` parity; fed by owners'
                   telemetry_push when object_accounting is on)
  GET /api/events?after_seq=N&type=T&limit=K
                   cluster event journal (node/worker/actor lifecycle,
                   spill overflow, lease failures, autoscaler decisions)
  GET /api/logs?after_seq=N&role=R&node=N&worker=W&level=L&since=T
               &grep=RE&trace=TID&request=RID&limit=K
                   cluster-wide structured log search over the head's
                   LogStore (per-process severity rings fed by
                   telemetry_push; util/log_plane.py)
  GET /api/compiles?after_seq=N&role=R&node=N&worker=W&callable=C
                   &recompiles_only=1&by_callable=1&limit=K
                   compile records aggregated at the head
                   (per-process rings fed by telemetry_push;
                   util/compile_tracker.py, fed by the engine's step
                   functions and CompiledDAG — recompiles carry the arg
                   signature diff that caused them)
  GET /api/timeline task spans (chrome-trace convertible)
  GET /api/jobs    submitted jobs
  GET /api/nodes   per-node agent stats (cpu/mem/disk/store/worker RSS —
                   the reference's reporter-agent surface)
  GET /api/profile?node_id=N&worker_id=W
                   on-demand stack dump of one worker (the reference's
                   py-spy role, served by the worker in-process)
  GET /api/profile[?role=head|node|worker&node=N&worker=W&top=K]
                   without node_id+worker_id: aggregated continuous
                   collapsed-stack profiles from the head's ProfileStore
                   (util/stack_profiler.py; every process samples at
                   profile_hz and ships windows over telemetry_push)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ray_tpu_torch.runtime.protocol import ClientPool, RpcClient

_PAGE = """<!doctype html><title>ray_tpu_torch dashboard</title>
<style>body{font-family:monospace;margin:2em}td,th{padding:2px 8px;
text-align:left}</style>
<h2>ray_tpu_torch cluster</h2><div id=o>loading…</div>
<script>
fetch('/api/state').then(r=>r.json()).then(s=>{
 let h='<h3>nodes</h3><table><tr><th>id</th><th>alive</th><th>resources'
 +'</th></tr>';
 for(const n of s.nodes)h+=`<tr><td>${n.node_id.slice(0,12)}</td>`
 +`<td>${n.alive}</td><td>${JSON.stringify(n.resources)}</td></tr>`;
 h+='</table><h3>actors</h3><table><tr><th>id</th><th>class</th>'
 +'<th>state</th><th>restarts</th></tr>';
 for(const a of s.actors)h+=`<tr><td>${a.actor_id.slice(0,12)}</td>`
 +`<td>${a.class}</td><td>${a.state}</td><td>${a.restarts}</td></tr>`;
 h+=`</table><p>${s.placement_groups.length} placement groups, `
 +`${s.leases} active leases</p>`;
 document.getElementById('o').innerHTML=h;});
</script>"""


class Dashboard:
    def __init__(self, head_addr: str, port: int = 0):
        client = RpcClient(head_addr, name="dashboard")
        self._client = client
        pool = ClientPool(name="dash->node")   # persistent per-node conns
        self._pool = pool

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _node_addr(self, node_id: str):
                nodes = client.call("list_nodes", timeout=10)
                for n in nodes:
                    if n["node_id"].startswith(node_id) and n["alive"]:
                        return n["address"]
                raise ValueError(f"no live node matching {node_id!r}")

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse
                try:
                    if self.path in ("/", "/index.html"):
                        self._send(200, _PAGE.encode(), "text/html")
                        return
                    parsed = urlparse(self.path)
                    if parsed.path == "/metrics":
                        # Prometheus scrape: app metrics (raw tag tuples)
                        # + the newest hardware gauge of each live series
                        from ray_tpu_torch.util import prometheus
                        agg = client.call("metrics_dump", {"raw": True},
                                          timeout=10)
                        hw = client.call("timeseries_dump",
                                         {"latest": True,
                                          "max_age_s": 120.0}, timeout=10)
                        body = prometheus.render(agg, hw).encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                        return
                    if parsed.path == "/api/timeseries":
                        q = parse_qs(parsed.query)
                        payload = {
                            "node": q.get("node", [""])[0],
                            "metric": q.get("metric", [""])[0],
                            "last": int(q.get("last", ["0"])[0] or 0),
                        }
                        if q.get("latest", [""])[0]:
                            payload = {"latest": True,
                                       "max_age_s": 120.0}
                        data = client.call("timeseries_dump", payload,
                                           timeout=10)
                        self._send(200, json.dumps(
                            data, default=str).encode(), "application/json")
                        return
                    if parsed.path == "/api/requests":
                        q = parse_qs(parsed.query)
                        payload = {
                            "live": bool(q.get("live", [""])[0]),
                            "slowest": q.get("slowest", ["0"])[0],
                            "request": q.get("request", [""])[0],
                        }
                        data = client.call("requests_dump", payload,
                                           timeout=10)
                        self._send(200, json.dumps(
                            data, default=str).encode(), "application/json")
                        return
                    if parsed.path == "/api/objects":
                        data = client.call("objects_dump", timeout=10)
                        self._send(200, json.dumps(
                            data, default=str).encode(), "application/json")
                        return
                    if parsed.path == "/api/events":
                        q = parse_qs(parsed.query)
                        payload = {
                            "after_seq": int(
                                q.get("after_seq", ["0"])[0] or 0),
                            "type": q.get("type", [""])[0],
                            "limit": int(q.get("limit", ["0"])[0] or 0),
                        }
                        data = client.call("events_dump", payload,
                                           timeout=10)
                        self._send(200, json.dumps(
                            data, default=str).encode(), "application/json")
                        return
                    if parsed.path == "/api/logs":
                        q = parse_qs(parsed.query)
                        payload = {
                            "after_seq": int(
                                q.get("after_seq", ["0"])[0] or 0),
                            "role": q.get("role", [""])[0],
                            "node": q.get("node", [""])[0],
                            "worker": q.get("worker", [""])[0],
                            "level": q.get("level", [""])[0],
                            "since": float(
                                q.get("since", ["0"])[0] or 0.0),
                            "grep": q.get("grep", [""])[0],
                            "trace": q.get("trace", [""])[0],
                            "request": q.get("request", [""])[0],
                            "limit": int(q.get("limit", ["0"])[0] or 0),
                        }
                        data = client.call("logs_dump", payload,
                                           timeout=10)
                        self._send(200, json.dumps(
                            data, default=str).encode(), "application/json")
                        return
                    if parsed.path == "/api/compiles":
                        q = parse_qs(parsed.query)
                        payload = {
                            "after_seq": int(
                                q.get("after_seq", ["0"])[0] or 0),
                            "role": q.get("role", [""])[0],
                            "node": q.get("node", [""])[0],
                            "worker": q.get("worker", [""])[0],
                            "callable": q.get("callable", [""])[0],
                            "recompiles_only": bool(int(
                                q.get("recompiles_only", ["0"])[0]
                                or 0)),
                            "by_callable": bool(int(
                                q.get("by_callable", ["0"])[0] or 0)),
                            "limit": int(q.get("limit", ["0"])[0] or 0),
                        }
                        data = client.call("compiles_dump", payload,
                                           timeout=10)
                        self._send(200, json.dumps(
                            data, default=str).encode(), "application/json")
                        return
                    if parsed.path == "/api/nodes":
                        # fan out: one hung-but-alive node must not
                        # stall the endpoint for 10s x N
                        nodes = client.call("list_nodes", timeout=10)
                        futs = {}
                        for n in nodes:
                            if n["alive"]:
                                try:
                                    futs[n["node_id"]] = pool.get(
                                        n["address"]).call_async(
                                            "node_stats")
                                except Exception as e:  # noqa: BLE001
                                    futs[n["node_id"]] = e
                        data = []
                        for n in nodes:
                            row = dict(n)
                            fut = futs.get(n["node_id"])
                            if fut is not None:
                                try:
                                    row["stats"] = fut.result(timeout=10) \
                                        if not isinstance(fut, Exception) \
                                        else {"error": repr(fut)}
                                except Exception as e:  # noqa: BLE001
                                    row["stats"] = {"error": repr(e)}
                            data.append(row)
                        self._send(200, json.dumps(
                            data, default=str).encode(), "application/json")
                        return
                    if parsed.path == "/api/profile":
                        q = parse_qs(parsed.query)
                        if q.get("node_id") and q.get("worker_id"):
                            # legacy surface: on-demand formatted stack
                            # dump of ONE worker via its node daemon
                            addr = self._node_addr(q["node_id"][0])
                            data = pool.get(addr).call(
                                "profile_worker",
                                {"worker_id": q["worker_id"][0]},
                                timeout=15)
                        else:
                            # aggregated continuous profiles from the
                            # head's ProfileStore (collapsed stacks per
                            # process, tagged role/node/worker)
                            data = client.call("profiles_dump", {
                                "role": q.get("role", [""])[0],
                                "node": q.get("node", [""])[0],
                                "worker": q.get("worker", [""])[0],
                                "top": int(q.get("top", ["0"])[0] or 0),
                            }, timeout=10)
                        self._send(200, json.dumps(
                            data, default=str).encode(), "application/json")
                        return
                    if self.path == "/api/state":
                        data = client.call("state_dump", timeout=10)
                    elif self.path == "/api/metrics":
                        data = client.call("metrics_dump", timeout=10)
                    elif self.path == "/api/timeline":
                        data = client.call("timeline_dump", timeout=10)
                    elif self.path == "/api/jobs":
                        keys = client.call(
                            "kv_keys", {"prefix": "job:"}, timeout=10)
                        ids = sorted({k.split(":")[1] for k in keys})
                        data = []
                        for j in ids:
                            raw = client.call(
                                "kv_get", {"key": f"job:{j}:status"},
                                timeout=10)
                            if raw:
                                data.append({"job_id": j,
                                             **json.loads(raw)})
                    else:
                        self._send(404, b'{"error":"not found"}',
                                   "application/json")
                        return
                    self._send(200, json.dumps(data, default=str).encode(),
                               "application/json")
                except Exception as e:  # noqa: BLE001 — head unreachable
                    self._send(503, json.dumps(
                        {"error": repr(e)}).encode(), "application/json")

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="dashboard")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._client.close()
        self._pool.close_all()
