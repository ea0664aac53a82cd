"""LLM serving through the port's Serve against ray_tpu's: a
replica-hosted engine batching concurrent requests, the router's trace id
in the engine's flight-recorder record and that record at the head, the
port's deployment giving the JAX engine's greedy tokens from converted
weights, and ``placement_for_engine``/``build_llm_app`` with the TPU
mapped to the GPU.

The programs of ``tests/test_llm_serve.py`` (bar the tp=2 deployment,
in tests/test_torch_llm_serve_tp.py) run once through each package's
cluster runtime; the port's ``LLMServer`` gets
``{"device": "cpu"}`` in its ``engine_config``. The port's cluster is told
of one card (``init(num_gpus=1)``): no CUDA runs, the replica only reads
its environment.
"""

import importlib
import os
import time

import jax
import pytest
from test_torch_serve import stop_serve

from ray_tpu.llm.engine import InferenceEngine as JEngine
from ray_tpu.llm.serve_llm import placement_for_engine as jax_placement
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm.serve_llm import build_llm_app, placement_for_engine

PACKAGES = ["ray_tpu", "ray_tpu_torch"]

ENGINE = {"page_size": 8, "total_pages": 64, "max_batch": 4,
          "max_seq_len": 128, "seed": 7}


@pytest.fixture(scope="module", params=PACKAGES)
def serve_rt(request):
    rt = importlib.import_module(request.param)
    # the JAX test's 8 TPU resources; one card for the port; the fast
    # telemetry period lets the head-aggregation test poll quickly
    accel = ({"num_gpus": 1} if request.param == "ray_tpu_torch"
             else {"resources": {"TPU": 8}})
    rt.init(num_cpus=4, **accel, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "metrics_export_period_s": 1.0,
        "worker_pool_prestart": 2,
    })
    serve = importlib.import_module(f"{request.param}.serve")
    yield rt, serve
    stop_serve(serve)
    rt.shutdown()


def engine_config(rt, **kw):
    """The JAX test's engine config; the port's engine on the CPU."""
    cfg = dict(ENGINE, **kw)
    return dict(cfg, device="cpu") if rt.__name__ == "ray_tpu_torch" \
        else cfg


def llm_server(rt):
    return importlib.import_module(f"{rt.__name__}.llm.serve_llm").LLMServer


def test_llm_deployment_concurrent_requests(serve_rt):
    rt, serve = serve_rt
    dep = serve.deployment(name="llm", max_ongoing_requests=8)(
        llm_server(rt))
    h = serve.run(dep.bind({"n_layers": 2}, engine_config(rt)),
                  timeout_s=240)

    prompts = [[5, 17, 42], [5, 17, 42], [9, 9, 1, 2]]
    resps = [h.remote({"prompt_ids": p, "max_tokens": 6}) for p in prompts]
    outs = [r.result(timeout=300) for r in resps]
    assert all(len(o["token_ids"]) == 6 for o in outs)
    # same prompt -> same greedy tokens (engine must be deterministic)
    assert outs[0]["token_ids"] == outs[1]["token_ids"]
    stats = h.stats.remote().result(timeout=60)
    # continuous batching + chunking: 18 tokens in a handful of dispatches
    assert stats["decode_dispatches"] < 9, stats
    serve.delete("llm")


def test_llm_request_record_links_router_trace(serve_rt):
    """The trace_id the serve router stamps on the wire is the one in the
    engine's flight-recorder record, and the record ships to the head
    (requests_dump) over the telemetry plane."""
    rt, serve = serve_rt
    trace_context = importlib.import_module(
        f"{rt.__name__}.util.trace_context")
    head = importlib.import_module(
        f"{rt.__name__}.core.worker").global_worker.backend.head

    dep = serve.deployment(name="llm-obs", max_ongoing_requests=8)(
        llm_server(rt))
    h = serve.run(dep.bind({"n_layers": 2}, engine_config(rt)),
                  timeout_s=240)

    tid = trace_context.new_trace_id()
    tok = trace_context.activate(tid, trace_context.new_span_id())
    try:
        out = h.remote({"prompt_ids": [5, 17, 42, 9],
                        "max_tokens": 4}).result(timeout=300)
    finally:
        trace_context.deactivate(tok)
    rid = out["request_id"]

    # replica-local view: the record carries the router's trace_id
    recs = h.request_records.remote().result(timeout=60)
    rec = {r["rid"]: r for r in recs}[rid]
    assert rec["trace_id"] == tid
    assert rec["done"] and rec["finish_reason"] == "length"
    assert rec["n_generated"] == 4 and rec["ttft"] > 0

    # head-side view: telemetry_push ships the finished record
    deadline = time.monotonic() + 60
    got = []
    while time.monotonic() < deadline:
        got = head.call("requests_dump", {"request": rid}, timeout=10)
        if got and got[0].get("done"):
            break
        time.sleep(0.5)
    assert got, "record never reached the head"
    assert got[0]["rid"] == rid and got[0]["trace_id"] == tid
    assert got[0]["worker"] and got[0]["node"]
    slowest = head.call("requests_dump", {"slowest": 5}, timeout=10)
    assert any(r["rid"] == rid for r in slowest)
    serve.delete("llm-obs")


def test_streamed_request_record_links_router_trace(serve_rt):
    """A request streamed through the handle: the replica's generator runs
    as the worker drains it, after the task body returned. The port's
    worker keeps the caller's trace ambient while it drains, so the
    engine's record carries the router's trace id; the JAX worker
    restores the trace for the task body only, so its record has none."""
    rt, serve = serve_rt
    trace_context = importlib.import_module(
        f"{rt.__name__}.util.trace_context")
    dep = serve.deployment(name="llm-stream-obs", max_ongoing_requests=8)(
        llm_server(rt))
    h = serve.run(dep.bind({"n_layers": 2}, engine_config(rt)),
                  timeout_s=240)
    tid = trace_context.new_trace_id()
    tok = trace_context.activate(tid, trace_context.new_span_id())
    try:
        items = list(h.stream.options(stream=True).remote(
            {"prompt_ids": [5, 17, 42, 9], "max_tokens": 4}))
    finally:
        trace_context.deactivate(tok)
    assert items[-1]["done"] and len(items[-1]["token_ids"]) == 4
    recs = {r["rid"]: r for r in
            h.request_records.remote().result(timeout=60)}
    rec = recs[items[-1]["request_id"]]
    assert rec["done"] and rec["n_generated"] == 4
    assert rec["trace_id"] == (tid if rt.__name__ == "ray_tpu_torch"
                               else "")
    serve.delete("llm-stream-obs")


PARITY_PROMPTS = ([5, 17, 42], [9, 9, 1, 2, 200, 31],
                  [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9])
PARITY_TOKENS = 8


@pytest.fixture(scope="module")
def jax_greedy():
    """The JAX engine's greedy tokens for each parity prompt, sent one at
    a time, in this process, from ``init_params(tiny(n_layers=2),
    PRNGKey(7))`` in fp32."""
    cfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jax.numpy.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(7))
    eng = JEngine(cfg, params, **ENGINE)
    out = []
    for p in PARITY_PROMPTS:
        rid = eng.add_request(list(p), PARITY_TOKENS)
        done = {}
        while eng.has_work():
            done.update(eng.step())
        out.append(done[rid])
    return params, out


def test_llm_deployment_matches_jax_engine_greedy(serve_rt, jax_greedy):
    """Requests sent one at a time through each package's handle give the
    JAX engine's greedy tokens: the JAX deployment from its own seed, the
    port's from the JAX weights converted (fp32 on both sides)."""
    rt, serve = serve_rt
    params, want = jax_greedy
    if rt.__name__ == "ray_tpu_torch":
        model = {"n_layers": 2, "dtype": "float32"}
        eng = engine_config(rt, params=convert.from_jax(params,
                                                        device="cpu"))
    else:
        model = {"n_layers": 2, "dtype": jax.numpy.float32}
        eng = engine_config(rt)
    dep = serve.deployment(name="llm-parity", max_ongoing_requests=8)(
        llm_server(rt))
    h = serve.run(dep.bind(model, eng), timeout_s=240)
    got = [h.remote({"prompt_ids": list(p), "max_tokens": PARITY_TOKENS})
           .result(timeout=300)["token_ids"] for p in PARITY_PROMPTS]
    assert got == want
    serve.delete("llm-parity")


# ------------------------------------------------- placement (TPU -> GPU)


@pytest.mark.parametrize("tp,pp", [(1, 1), (2, 1), (8, 1), (8, 2),
                                   (4, 4), (2, 3)])
def test_placement_for_engine_matches_jax(tp, pp):
    bundles, strategy = placement_for_engine(tp, pp)
    jb, js = jax_placement(tp, pp)
    assert strategy == js
    assert bundles == [{"GPU": b["TPU"]} for b in jb]
    if (tp, pp) == (2, 1):
        assert bundles == [{"GPU": 2.0}] and strategy == "STRICT_PACK"
    if (tp, pp) == (8, 2):
        assert bundles == [{"GPU": 8.0}] * 2 and strategy == "PACK"


@pytest.mark.parametrize("tp,pp,per_host", [(12, 1, 8), (3, 3, 4)])
def test_placement_uneven_across_hosts_raises(tp, pp, per_host):
    with pytest.raises(ValueError):
        jax_placement(tp, pp, chips_per_host=per_host)
    with pytest.raises(ValueError):
        placement_for_engine(tp, pp, gpus_per_host=per_host)


def leased_workers():
    """CUDA_VISIBLE_DEVICES of every worker process of this driver's
    session that was started with the variable set (a GPU lease's
    dedicated worker)."""
    session = os.environ["RTPT_SESSION"]
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if b"ray_tpu_torch.runtime.worker_main" not in f.read():
                    continue
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                           if b"=" in kv)
        except OSError:
            continue
        if env.get(b"RTPT_SESSION") == session.encode() and \
                b"CUDA_VISIBLE_DEVICES" in env:
            out.append(env[b"CUDA_VISIBLE_DEVICES"].decode())
    return out


def test_build_llm_app_books_the_card(serve_rt):
    """The port's ``build_llm_app`` books {"GPU": 1} for a tp=1 engine on
    the card (the replica gets the card's dedicated worker), nothing when
    told not to, {"GPU": 2} for a tp=2 gang, and refuses a gang spanning
    hosts; the JAX package's books chips only for a tp > 1 gang, so its
    tp=1 replica books nothing."""
    rt, serve = serve_rt
    prompt = {"prompt_ids": [5, 17, 42, 9], "max_tokens": 4}
    if rt.__name__ == "ray_tpu":
        jax_app = importlib.import_module("ray_tpu.llm").build_llm_app(
            {"n_layers": 2}, ENGINE, name="llm-app")
        assert jax_app.deployment._config["resources"] == {"CPU": 0.1}
        h = serve.run(jax_app, timeout_s=240)
        assert len(h.remote(prompt).result(timeout=300)["token_ids"]) == 4
        assert rt.available_resources().get("TPU") == 8.0
        serve.delete("llm-app")
        return

    # the default engine runs on the card: the replica books it
    app = build_llm_app({"n_layers": 2}, {k: v for k, v in ENGINE.items()})
    assert app.deployment._config["resources"] == {"GPU": 1.0}
    # here the engine runs on the CPU in the card's worker
    app = build_llm_app({"n_layers": 2}, engine_config(rt), name="llm-app",
                        use_gpu_resources=True)
    assert app.deployment._config["resources"] == {"GPU": 1.0}
    h = serve.run(app, timeout_s=240)
    assert len(h.remote(prompt).result(timeout=300)["token_ids"]) == 4
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    assert leased_workers() == ["0"]
    serve.delete("llm-app")
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU", 0.0) != 1.0:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.2)

    # a CPU engine books nothing by default, nor when told not to
    for kw in ({}, {"use_gpu_resources": False}):
        app = build_llm_app({"n_layers": 2}, engine_config(rt), **kw)
        assert app.deployment._config["resources"] == {"CPU": 0.1}
    app = build_llm_app({"n_layers": 2}, dict(ENGINE),
                        name="llm-unbooked", use_gpu_resources=False)
    assert app.deployment._config["resources"] == {"CPU": 0.1}

    app = build_llm_app({"n_layers": 2}, engine_config(rt, tp=2),
                        use_gpu_resources=True)
    assert app.deployment._config["resources"] == {"GPU": 2.0}
    with pytest.raises(NotImplementedError):
        build_llm_app({"n_layers": 2}, engine_config(rt, tp=16),
                      use_gpu_resources=True)
