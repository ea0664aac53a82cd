"""The compile tracker's hooks in the port's engine against the JAX
engine's, on the CPU.

Both engines wrap ``ragged_step``, ``decode_loop`` and ``copy_page`` in
their package's process tracker (``llm.*``), probed by
``compiled_step_programs()``: a new step program (the port's: a new
entry of the engine's program set; the JAX engine's: a jit cache entry)
is one compile record. Both counts are process-wide, so the program runs
in a fresh process: tests/test_torch_request_log.py's stream through one
engine of each package (3 programs: ragged step, decode loop, copy on
write), then a second engine with a larger prefill chunk, whose ragged
step is a 4th program: a recompile of ``llm.ragged_step`` with the token
arrays' shapes in its diff, and one ``llm_compile_invariant_breach``
event per excursion above 3, re-armed when the count drops. The port's
records, counts and events must equal the JAX engine's, field by field
but the pid.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CALLABLES = ("llm.ragged_step", "llm.decode_loop", "llm.copy_page")

_PROGRAM = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
import test_torch_request_log as t
from ray_tpu.util import compile_tracker as jct
from ray_tpu_torch.util import compile_tracker as tct
CALLABLES = {callables!r}
jp = t.jl.init_params(t.JCFG, t.jax.random.PRNGKey(7))
tp = t.convert.from_jax(jp, device="cpu")
out = {{}}
for name, make, ct in (
        ("jax", lambda **kw: t.JEngine(t.JCFG, jp, **{{**t.ENGINE, **kw}}),
         jct),
        ("torch", lambda **kw: t.TEngine(t.TCFG, tp, device="cpu",
                                         **{{**t.ENGINE, **kw}}), tct)):
    res = out[name] = {{}}
    eng = make()
    tr = ct.get_global()

    def compiles():
        return {{n: (tr.callable_stats(n) or {{}}).get("compiles", 0)
                for n in CALLABLES}}

    def events():
        return [{{k: v for k, v in e.items() if k != "pid"}}
                for e in tr.drain_journal_events()]

    assert eng._tracker is tr
    t.run_stream(eng)
    eng._update_metrics(force=True)
    res["first"] = [eng.compiled_step_programs(), compiles(), events()]
    wide = make(prefill_chunk=16)
    t.run_stream(wide)
    wide._update_metrics(force=True)
    wide._update_metrics(force=True)        # the same excursion: no event
    res["wide"] = [wide.compiled_step_programs(), compiles(), events()]
    # the count drops (as in a fresh process) and grows again: re-armed
    real = wide.compiled_step_programs
    wide.compiled_step_programs = lambda: 2
    wide._update_metrics(force=True)
    wide.compiled_step_programs = real
    wide._update_metrics(force=True)
    res["rearmed"] = events()
    res["recompiles"] = tr.callable_stats("llm.ragged_step")["recompiles"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    code = _PROGRAM.format(root=str(ROOT), tests=str(ROOT / "tests"),
                           callables=CALLABLES)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_records_equal_programs_and_jax(runs):
    for name in ("jax", "torch"):
        programs, compiles, events = runs[name]["first"]
        assert programs == 3, (name, programs)
        assert compiles == {n: 1 for n in CALLABLES}, (name, compiles)
        assert sum(compiles.values()) == programs
        assert events == [], (name, events)
    assert runs["torch"]["first"] == runs["jax"]["first"]


def test_one_breach_per_excursion_matches_jax(runs):
    programs, compiles, events = runs["torch"]["wide"]
    assert programs == 4
    assert compiles == {"llm.ragged_step": 2, "llm.decode_loop": 1,
                        "llm.copy_page": 1}
    assert len(events) == 1, events
    ev = events[0]
    assert ev["type"] == "llm_compile_invariant_breach"
    assert (ev["programs"], ev["budget"], ev["callable"]) == \
        (4, 3, "llm.ragged_step")
    # the ragged batch's token arrays moved from 20 to 36 slots
    assert ev["diff"] and all("[20] -> " in d and d.endswith("[36]")
                              for d in ev["diff"]), ev["diff"]
    assert runs["torch"]["wide"] == runs["jax"]["wide"]
    assert runs["torch"]["recompiles"] == runs["jax"]["recompiles"] == 1


def test_breach_rearms_when_the_count_drops(runs):
    for name in ("jax", "torch"):
        rearmed = runs[name]["rearmed"]
        assert len(rearmed) == 1, (name, rearmed)
        assert rearmed[0]["callable"] == "llm.ragged_step"
    assert runs["torch"]["rearmed"] == runs["jax"]["rearmed"]


def test_tp_engine_feeds_the_tracker():
    """At tp=2 (both shards on the CPU) the engine's own program set is
    the probe (``TPEngineFns``): the tracker's new records equal the
    engine's programs, at most 3."""
    import torch

    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.util import compile_tracker
    import test_torch_request_log as t

    tracker = compile_tracker.ensure_started()

    def total():
        return sum((tracker.callable_stats(n) or {}).get("compiles", 0)
                   for n in CALLABLES)

    cfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32, n_heads=4,
                              n_kv_heads=2)
    eng = InferenceEngine(cfg, None, tp=2, devices=["cpu", "cpu"],
                          device="cpu", **t.ENGINE)
    before = total()
    t.run_stream(eng)
    programs = eng.compiled_step_programs()
    assert 1 <= programs <= 3
    assert total() - before == programs
