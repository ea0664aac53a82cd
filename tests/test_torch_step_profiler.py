"""The port's step profiler against ray_tpu's: the ``train_step`` span
tree it records into the runtime's task event buffer, which
``util.tracing.latest_train_step`` finds, and ``StepBreakdown.as_metrics``.

The program of ``tests/test_step_profiler.py::test_spans_recorded_and_
cli_selectable`` runs through the port: a backend stand-in holding a
``TaskEventBuffer``, one profiled step of a tiny Llama on the CPU, one
``train_step`` span with a ``train_phase`` child per phase.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu.train import step_profiler as jsp
from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.runtime.events import TaskEventBuffer
from ray_tpu_torch.train import (PHASES, StepBreakdown, make_train_step,
                                 profile_train_step)
from ray_tpu_torch.util import trace_context
from ray_tpu_torch.util.tracing import latest_train_step

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    params = tl.init_params(cfg, device="cpu", seed=0)
    opt_fn = functools.partial(torch.optim.SGD, lr=1e-2)
    init, _ = make_train_step(functools.partial(tl.loss_fn, cfg=cfg),
                              opt_fn)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16)))
    return (functools.partial(tl.loss_fn, cfg=cfg), opt_fn, params,
            init(params), tokens)


def test_phases_match_jax():
    assert PHASES == jsp.PHASES


def test_spans_recorded_and_cli_selectable(setup, monkeypatch):
    loss, opt_fn, params, opt, tokens = setup
    buf = TaskEventBuffer()

    class FakeBackend:
        event_buffer = buf

    monkeypatch.setattr(worker_mod.global_worker, "backend",
                        FakeBackend(), raising=False)
    bd = profile_train_step(loss, opt_fn, params, opt, tokens,
                            steps=1, warmup=0, emit=True)
    events = buf.drain()
    steps = [e for e in events if e["kind"] == "train_step"]
    assert len(steps) == 1
    phases = [e for e in events if e["kind"] == "train_phase"]
    assert [e["name"] for e in phases] == list(PHASES)
    assert all(e["parent_span_id"] == steps[0]["span_id"]
               for e in phases)
    assert all(e["trace_id"] == steps[0]["trace_id"] for e in phases)
    # children partition the parent window (abs tolerance: the span
    # window lives on unix-epoch floats)
    assert steps[0]["end"] - steps[0]["start"] == pytest.approx(
        bd.step_time_s, abs=1e-3)
    assert phases[0]["start"] == pytest.approx(steps[0]["start"], abs=1e-6)
    assert phases[-1]["end"] == pytest.approx(steps[0]["end"], abs=1e-3)
    # util.tracing's selector of the newest step finds the tree
    tree = latest_train_step(events)
    assert tree is not None and tree["name"] == "train_step"
    assert {c["name"] for c in tree["children"]} == set(PHASES)


def test_span_tree_joins_the_ambient_trace(setup, monkeypatch):
    """Profiled under an active trace, the train_step span is a child of
    the caller's span in the caller's trace."""
    loss, opt_fn, params, opt, tokens = setup
    buf = TaskEventBuffer()

    class FakeBackend:
        event_buffer = buf

    monkeypatch.setattr(worker_mod.global_worker, "backend",
                        FakeBackend(), raising=False)
    tid, sid = trace_context.new_trace_id(), trace_context.new_span_id()
    tok = trace_context.activate(tid, sid)
    try:
        profile_train_step(loss, opt_fn, params, opt, tokens, steps=1,
                           warmup=0, emit=True)
    finally:
        trace_context.deactivate(tok)
    (step,) = [e for e in buf.drain() if e["kind"] == "train_step"]
    assert step["trace_id"] == tid and step["parent_span_id"] == sid


def test_profile_outside_a_runtime(setup, monkeypatch):
    """Outside a runtime (no backend, so no event buffer) profiling with
    emit=True still returns its breakdown; emit=False records no span."""
    loss, opt_fn, params, opt, tokens = setup
    monkeypatch.setattr(worker_mod.global_worker, "backend", None,
                        raising=False)
    bd = profile_train_step(loss, opt_fn, params, opt, tokens, steps=1,
                            warmup=0, emit=True)
    assert set(bd.phases) == set(PHASES)
    buf = TaskEventBuffer()

    class FakeBackend:
        event_buffer = buf

    monkeypatch.setattr(worker_mod.global_worker, "backend",
                        FakeBackend(), raising=False)
    profile_train_step(loss, opt_fn, params, opt, tokens, steps=1,
                       warmup=0, emit=False)
    assert buf.drain() == []


def test_as_metrics_matches_jax():
    kw = dict(step_time_s=0.25, compile_time_s=1.5,
              phases={"forward": 0.05, "backward": 0.1, "optimizer": 0.06,
                      "collective_wait": 0.04}, n_steps=3)
    bd = StepBreakdown(**kw)
    got = bd.as_metrics()
    want = jsp.StepBreakdown(**kw).as_metrics()
    assert got.keys() == want.keys()
    assert got == want
    # the phases are a copy, not the breakdown's own dict
    got["phases"]["forward"] = 9.0
    assert bd.phases["forward"] == 0.05


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_report_phases_rides_session_gauges(pkg, tmp_path):
    """tests/test_step_profiler.py's program on each package: a report's
    ``phases`` become ``train_phase_time_s`` gauges tagged by phase (the
    first report only arms the clock); the port's gauges must equal the
    JAX package's."""
    import importlib
    seen = {}
    for name in ("ray_tpu", "ray_tpu_torch") if pkg == "ray_tpu_torch" \
            else (pkg,):
        s = importlib.import_module(f"{name}.train.session")
        m = importlib.import_module(f"{name}.util.metrics")
        m.clear_registry()
        try:
            ctx = s.TrainContext(rank=0, world_size=1,
                                 storage_path=str(tmp_path / name))
            ctx.report({"loss": 1.0})
            ctx.report({"loss": 0.9,
                        "phases": {"forward": 0.25, "backward": 0.5}})
            seen[name] = dict(m.snapshot()["train_phase_time_s"]["values"])
        finally:
            m.clear_registry()
    tagged = seen[pkg]
    assert tagged[("forward",)] == pytest.approx(0.25)
    assert tagged[("backward",)] == pytest.approx(0.5)
    if pkg == "ray_tpu_torch":
        assert seen["ray_tpu_torch"] == seen["ray_tpu"]
