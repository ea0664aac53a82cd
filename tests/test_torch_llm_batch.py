"""The port's ``LLMBatchPredictor``, ``batch_inference`` and the server's
telemetry hooks against the JAX package's, on the CPU.

The predictors run the JAX package's parameters (carried across with
``convert``) with an EOS token that one row's greedy stream reaches, so
the rows carry both finish reasons; their rows must be equal to the JAX
predictor's, key by key. The server's ``request_records()`` must carry the
caller's ambient trace id, its log records the request id (and the trace
id where one is ambient), and ``set_overload_level`` must set the token
budget the JAX server sets. ``batch_inference`` runs through both
packages' local modes, in one block and in several through a pool of two
actors, and its rows must equal the JAX package's, key by key; the JAX
package's side runs with the cyclic collector paused, as in
tests/test_torch_data.py (its local-mode memory store deadlocks when the
collector frees an ObjectRef inside the store's lock). chip_smoke.py's
phase 12a and 12b run here at a small size.
"""

import contextlib
import gc
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu.llm.batch import LLMBatchPredictor as JPredictor
from ray_tpu.llm.batch import batch_inference as jbatch_inference
from ray_tpu.llm.serve_llm import LLMServer as JServer
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch import data as tdata
from ray_tpu_torch.llm.batch import LLMBatchPredictor, batch_inference
from ray_tpu_torch.llm.serve_llm import LLMServer
from ray_tpu_torch.util import log_plane, trace_context

torch.set_num_threads(1)

MODEL = {"n_layers": 2}
ENGINE = dict(page_size=8, total_pages=64, max_batch=4, max_seq_len=128,
              eos_token=220)
DICT_ROWS = [{"prompt": "hello world", "id": 1},
             {"prompt": [5, 17, 42, 9], "id": 2},
             {"prompt": "a much longer prompt that spans pages", "id": 3}]
PLAIN_ROWS = ["plain text", "x", "hello world"]


@pytest.fixture(scope="module")
def params():
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **MODEL)
    jp = jl.init_params(cfg, jax.random.PRNGKey(7))
    return jp, convert.from_jax(jp, device="cpu")


def _predictors(params, **kw):
    jp, tp = params
    jpred = JPredictor(dict(MODEL, dtype=jnp.float32),
                       dict(ENGINE, params=jp), **kw)
    tpred = LLMBatchPredictor(dict(MODEL, dtype="float32"),
                              dict(ENGINE, params=tp, device="cpu"), **kw)
    return jpred, tpred


@pytest.mark.parametrize("rows", ["dict", "plain"])
def test_batch_predictor_rows_match_jax(params, rows):
    batch = DICT_ROWS if rows == "dict" else PLAIN_ROWS
    jpred, tpred = _predictors(params, max_new_tokens=10)
    want = jpred(list(batch))
    got = tpred(list(batch))
    assert got == want
    assert all(set(r) >= {"generated", "generated_text", "finish_reason"}
               for r in got)
    if rows == "dict":
        assert {r["finish_reason"] for r in got} == {"stop", "length"}
        assert [r["id"] for r in got] == [1, 2, 3]


def test_batch_predictor_columns_match_jax(params):
    kw = dict(max_new_tokens=6, prompt_column="text",
              output_column="out", detokenize=False)
    jpred, tpred = _predictors(params, **kw)
    batch = [{"text": "abc"}, {"text": [1, 2, 3, 4]}]
    got = tpred(batch)
    assert got == jpred(batch)
    assert all("out" in r and "out_text" not in r for r in got)
    # the predictor's engine serves a second batch after the first
    assert tpred(["again"]) == jpred(["again"])


def test_default_predictor_raises_at_construction_on_a_card(monkeypatch):
    """The default model config ("tiny", head dim 8) is not a geometry
    the card's kernels take: on a CUDA device the constructor raises
    before it allocates anything. The device is stood in for here, as in
    tests/test_torch_llm.py: resolve_device hands back a CUDA device
    without a card (on the card: tests/test_torch_kernels_cuda.py)."""
    from ray_tpu_torch.llm import engine as te
    monkeypatch.setattr(te, "resolve_device", torch.device)
    with pytest.raises(ValueError, match="head dim 8"):
        LLMBatchPredictor()


@pytest.fixture
def server(params):
    _, tp = params
    srv = LLMServer(dict(MODEL, dtype="float32"),
                    dict(ENGINE, params=tp, eos_token=None, device="cpu"))
    yield srv
    srv.shutdown()
    assert not srv._thread.is_alive()


def _records_of(rid):
    logger = log_plane.get_global()
    assert logger is not None, "the server installs the process logger"
    exported = logger.export() or {"records": []}
    return [r for r in exported["records"] if r["request_id"] == rid]


def test_server_records_and_logs_carry_request_and_trace_ids(server):
    trace_id = trace_context.new_trace_id()
    out = {}

    def call():
        tok = trace_context.activate(trace_id, trace_context.new_span_id())
        try:
            out["traced"] = server({"prompt_ids": [5, 17, 42],
                                    "max_tokens": 4})
        finally:
            trace_context.deactivate(tok)

    t = threading.Thread(target=call)
    t.start()
    t.join(120)
    assert not t.is_alive()
    rid = out["traced"]["request_id"]
    logs = _records_of(rid)
    assert [r["msg"].split(" (")[0] for r in logs] == \
        ["llm request start", "llm request finished"]
    assert all(r["trace_id"] == trace_id and r["role"] == "llm"
               for r in logs)
    plain = server({"prompt_ids": [9, 9, 1], "max_tokens": 3})
    assert [r["trace_id"] for r in _records_of(plain["request_id"])] \
        == ["", ""]
    chunks = list(server.stream({"prompt_ids": [7, 8], "max_tokens": 3}))
    srid = chunks[-1]["request_id"]
    assert [r["msg"].split(" (")[0] for r in _records_of(srid)] == \
        ["llm stream start", "llm stream finished"]
    recs = {d["rid"]: d for d in server.request_records()}
    assert recs[rid]["trace_id"] == trace_id and recs[rid]["done"]
    assert recs[rid]["n_generated"] == 4
    assert recs[plain["request_id"]]["trace_id"] == ""
    assert recs[srid]["finish_reason"] == "length"


def test_server_without_recorder_has_no_records(params):
    _, tp = params
    srv = LLMServer(dict(MODEL, dtype="float32"),
                    dict(ENGINE, params=tp, device="cpu",
                         request_log=False))
    try:
        assert srv({"prompt_ids": [1, 2], "max_tokens": 2})["token_ids"]
        assert srv.request_records() == []
    finally:
        srv.shutdown()


@pytest.mark.parametrize("base", [2048, 1000, 0])
def test_set_overload_level_matches_jax(server, base):
    """The ladder on the JAX server's own stand-in (an engine with only a
    token budget) and on the port's live server: the same budgets."""
    jsrv = SimpleNamespace(engine=SimpleNamespace(step_token_budget=base))
    server.engine.step_token_budget = base
    for level, factor in ((1, 0.5), (2, 0.5), (3, 0.25), (0, 0.5)):
        want = JServer.set_overload_level(jsrv, level, factor)
        assert server.set_overload_level(level, factor) == want
        assert server.engine.step_token_budget == want
    assert server.engine.step_token_budget == base
    # the server keeps answering at a tightened budget
    server.set_overload_level(2)
    assert len(server({"prompt_ids": [3, 4, 5],
                       "max_tokens": 3})["token_ids"]) == 3


@contextlib.contextmanager
def collector_paused():
    gc.disable()
    try:
        yield
    finally:
        gc.collect()
        gc.enable()


@pytest.fixture
def runtimes():
    ray_tpu.init(local_mode=True, num_cpus=4)
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


BATCH_ROWS = DICT_ROWS + [{"prompt": p, "id": 4 + i}
                          for i, p in enumerate(PLAIN_ROWS)]


@pytest.mark.parametrize("blocks, concurrency", [(1, 1), (3, 2)])
def test_batch_inference_rows_match_jax(params, runtimes, blocks,
                                        concurrency):
    jp, tp = params
    kw = dict(max_new_tokens=8, concurrency=concurrency)
    with collector_paused():
        want = jbatch_inference(
            jdata.from_items(BATCH_ROWS, num_blocks=blocks),
            model_config=dict(MODEL, dtype=jnp.float32),
            engine_config=dict(ENGINE, params=jp), **kw).take_all()
    out = batch_inference(
        tdata.from_items(BATCH_ROWS, num_blocks=blocks),
        model_config=dict(MODEL, dtype="float32"),
        engine_config=dict(ENGINE, params=tp, device="cpu"), **kw)
    assert out.num_blocks() == blocks
    got = out.take_all()
    assert got == want
    assert [r["id"] for r in got] == [r["id"] for r in BATCH_ROWS]
    assert {r["finish_reason"] for r in got} == {"stop", "length"}
    assert out.stats()["tasks"] == blocks
    assert out.stats()["rows"] == len(BATCH_ROWS)


def counting_ragged(monkeypatch):
    """The engine's attention counting a launch per call on the CPU, as
    the kernel's wrapper does on the card."""
    from ray_tpu_torch.llm import model as tmodel
    from ray_tpu_torch.ops import paged_attention as tpa
    orig = tmodel.ragged_paged_attention

    def counted(*args, **kwargs):
        tpa._count("ragged_paged_attention")
        return orig(*args, **kwargs)

    monkeypatch.setattr(tmodel, "ragged_paged_attention", counted)


def test_chip_smoke_batch_inference_phases_on_the_cpu(monkeypatch):
    """chip_smoke.py's phases 12a and 12b at a small size on the CPU: the
    pool's launches against its engines' counts, 12a's rows against the
    direct predictor's and 12b's against generate's."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    counting_ragged(monkeypatch)
    small = {"n_layers": 2, "dtype": "float32"}
    launches, expected = chip_smoke.phase_batch_inference(
        small, dict(chip_smoke.MAIN_ENGINE, device="cpu"), lengths=(5, 60))
    assert launches["ragged_paged_attention"] == expected > 0
    launches, expected = chip_smoke.phase_batch_rows(
        dict(small, n_heads=4, n_kv_heads=2, dim=64),
        dict(chip_smoke.BENCH_ENGINE, device="cpu"), lengths=(5, 80))
    assert launches["ragged_paged_attention"] == expected > 0
    assert not ray_tpu_torch.is_initialized()
