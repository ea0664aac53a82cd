"""The port's flight recorder, engine gauges and step-program count against
the JAX engine's, on the CPU.

One request stream runs through the JAX engine and the port's, each with
the JAX package's parameters (carried across with ``convert``): a prompt
prefilled in three chunks, the same prompt's first 16 tokens again (a
prefix hit whose last shared page is copied on write), then three
requests at once under a pool too small for them (a prefix hit that stops
at the EOS token, and two sequences that are preempted and recomputed).
Greedy streams and scheduler stats are equal (tests/test_torch_llm.py), so
everything in the records but their timestamps must be equal too, field
by field; so must the gauges that follow from the stats alone, read after
``_update_metrics(force=True)`` with the gauge window spanning the whole
stream; and the number of step programs the stream dispatched, which
both packages count process-wide and so are read in a fresh process.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.llm.engine import InferenceEngine as JEngine
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm.engine import InferenceEngine as TEngine
from ray_tpu_torch.llm.request_log import FlightRecorder, RequestRecord
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JCFG = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
V = JCFG.vocab_size
# the greedy stream of the prefix-hit request emits this token at its
# sixth position (the stream tests below check that it stopped there)
EOS = 66
ENGINE = dict(page_size=4, total_pages=14, max_batch=4, max_seq_len=64,
              prefill_chunk=8, decode_chunk=4, eos_token=EOS)
# the gauges that follow from the scheduler's counts alone (the token
# rates and SLO shares are clock readings)
DETERMINISTIC_GAUGES = ("_g_kv_util", "_g_hit_rate", "_g_dispatches",
                        "_g_pad_waste", "_g_preempts", "_g_queue")


def _prompt(mult, add, n):
    return [(mult * i + add) % V for i in range(n)]


def _drain(eng, out):
    while eng.has_work():
        out.update(eng.step())


def run_stream(eng):
    """The stream; returns (request ids in order, {rid: tokens})."""
    out = {}
    rids = [eng.add_request(_prompt(7, 3, 20), 8, trace_id="chunked")]
    _drain(eng, out)
    rids.append(eng.add_request(_prompt(7, 3, 16), 4, trace_id="cow"))
    _drain(eng, out)
    rids += [eng.add_request(_prompt(7, 3, 16) + _prompt(5, 1, 6), 12,
                             trace_id="hit"),
             eng.add_request(list(range(1, 9)), 16),
             eng.add_request(list(range(3, 11)), 16)]
    _drain(eng, out)
    return rids, out


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(7))
    return jp, convert.from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def streams(params):
    """Both engines after the stream, their metric updates held back
    until the end so the gauge window spans the whole stream."""
    jp, tp = params
    runs = []
    for eng in (JEngine(JCFG, jp, **ENGINE),
                TEngine(TCFG, tp, device="cpu", **ENGINE)):
        eng._update_metrics = lambda force=False: None
        rids, out = run_stream(eng)
        runs.append((eng, rids, out))
    return runs


def _without_times(d):
    """A record's wire dict with every clock reading taken out."""
    return {
        "trace_id": d["trace_id"], "prompt_tokens": d["prompt_tokens"],
        "max_new_tokens": d["max_new_tokens"],
        "admits": [c for _, c in d["admits"]],
        "chunks": [[n, disp] for _, n, disp in d["chunks"]],
        "cached_tokens": d["cached_tokens"],
        "n_generated": d["n_generated"],
        "decode": [n for _, n in d["decode"]],
        "decode_overflow_tokens": d["decode_overflow_tokens"],
        "stalls": d["stalls"], "preempts": d["preempts"],
        "finish_reason": d["finish_reason"], "done": d["done"],
        "has_ttft": d["ttft"] is not None, "has_tpot": d["tpot"] is not None,
    }


def test_stream_exercises_every_record_path(streams):
    (jeng, jrids, jout), (teng, trids, tout) = streams
    assert [tout[r] for r in trids] == [jout[r] for r in jrids]
    assert teng.stats == jeng.stats
    recs = [teng.request_log.get(r).to_dict() for r in trids]
    assert len(recs[0]["chunks"]) == 3                  # chunked prefill
    assert teng.stats["cow_copies"] == 1 and recs[1]["cached_tokens"] > 0
    assert recs[2]["cached_tokens"] == 16               # prefix hit
    assert recs[2]["finish_reason"] == "stop"
    assert len(tout[trids[2]]) < 12 and EOS not in tout[trids[2]]
    assert {r["finish_reason"] for r in recs} == {"stop", "length"}
    assert teng.stats["preemptions"] >= 1
    assert any(r["preempts"] >= 1 and len(r["admits"]) == r["preempts"] + 1
               for r in recs)


def test_records_match_jax_field_by_field(streams):
    (jeng, jrids, _), (teng, trids, _) = streams
    assert len(teng.request_log) == len(jeng.request_log) == len(trids)
    for jr, tr in zip(jrids, trids):
        want = jeng.request_log.get(jr).to_dict()
        got = teng.request_log.get(tr).to_dict()
        assert got.keys() == want.keys()
        assert _without_times(got) == _without_times(want), tr
        # the port's clock readings are in lifecycle order (a preempted
        # request's re-prefill chunks come after its first token)
        assert 0 <= got["queue_wait"] <= got["chunks"][0][0] + 1e-6
        assert got["chunks"][0][0] <= got["ttft"] + 1e-6
        assert got["chunks"][-1][0] <= got["e2e"] + 1e-6
        assert got["ttft"] <= got["e2e"]
    jrec, trec = jeng.request_log, teng.request_log
    assert (trec.n_finished, trec.n_preempts) == \
        (jrec.n_finished, jrec.n_preempts)
    assert [d["rid"] for d in trec.snapshot()] == trids


def test_gauges_match_jax_after_forced_update(streams):
    (jeng, _, _), (teng, _, _) = streams
    got, want = {}, {}
    for eng, vals in ((jeng, want), (teng, got)):
        type(eng)._update_metrics(eng, force=True)
        for name in DETERMINISTIC_GAUGES:
            vals[name] = getattr(eng, name)._values[()]
    assert got == want
    assert 0 < got["_g_kv_util"] < 1 and 0 < got["_g_hit_rate"] < 1
    assert got["_g_preempts"] >= 1 and got["_g_queue"] == 0
    # the SLO shares are the recorder's own counts
    a_ttft, a_tpot = teng.request_log.slo_attainment()
    assert teng._g_slo_ttft._values[()] == a_ttft
    assert teng._g_slo_tpot._values[()] == a_tpot


def test_recorder_off_leaves_no_records(params):
    _, tp = params
    eng = TEngine(TCFG, tp, device="cpu", request_log=False,
                  **dict(ENGINE, total_pages=64))
    assert eng.request_log is None
    assert eng.generate([5, 17, 42], max_new_tokens=4)


def test_recorder_ring_evicts_finished_first_and_feeds_histograms():
    from ray_tpu_torch.util import metrics
    rec = FlightRecorder(capacity=2, slo_ttft_s=0.5, slo_tpot_s=0.5)
    n0 = metrics.snapshot()["llm_ttft_seconds"]["values"].get(
        (), {"n": 0})["n"]
    a = rec.start("a", 3, 2)
    a.note_admit(a.t0 + 0.01, 0)
    a.note_decode(a.t0 + 0.1, 1)
    a.note_decode(a.t0 + 0.3, 1)
    rec.finish(a, a.t0 + 0.3, "length")
    rec.start("b", 3, 2)
    rec.start("c", 3, 2)                 # evicts the finished "a" first
    assert [d["rid"] for d in rec.snapshot()] == ["b", "c"]
    assert a.ttft == pytest.approx(0.1) and a.tpot == pytest.approx(0.2)
    assert rec.slo_attainment() == (1.0, 1.0)
    assert metrics.snapshot()["llm_ttft_seconds"]["values"][()]["n"] \
        == n0 + 1
    assert rec.snapshot()[1]["done"] is False
    probe = RequestRecord("p", 1, 1, decode_cap=2)
    for i in range(4):
        probe.note_decode(probe.t0 + i, 2)
    assert len(probe.decode_entries()) == 2
    assert probe.to_dict()["decode_overflow_tokens"] == 2
    assert probe.n_generated == 8 and math.isfinite(probe.tpot)


_PROGRAMS = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
import test_torch_request_log as t
jp = t.jl.init_params(t.JCFG, t.jax.random.PRNGKey(7))
tp = t.convert.from_jax(jp, device="cpu")
counts = {{}}
for name, make in (
        ("jax", lambda: t.JEngine(t.JCFG, jp, **t.ENGINE)),
        ("torch", lambda: t.TEngine(t.TCFG, tp, device="cpu", **t.ENGINE))):
    eng = make()
    t.run_stream(eng)
    first = eng.compiled_step_programs()
    t.run_stream(make())             # a second engine of the same shapes
    counts[name] = [first, eng.compiled_step_programs()]
print(json.dumps(counts))
"""


def test_compiled_step_programs_match_jax_in_a_fresh_process():
    """Both counts are process-wide (the JAX one counts jit cache
    entries), so they are read in a process that runs only this stream:
    one engine of each package, then a second engine of the same shapes,
    which adds no program on either side."""
    code = _PROGRAMS.format(root=str(ROOT), tests=str(ROOT / "tests"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ,
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    assert counts["torch"] == counts["jax"], counts
    # ragged step, decode loop and the copy on write, each once
    assert counts["torch"] == [3, 3], counts
