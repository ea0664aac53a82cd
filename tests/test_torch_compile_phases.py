"""The port's compile phases against the JAX package's monitoring listener.

The JAX package's compile tracker hears XLA's own compile phases through a
``jax.monitoring`` listener pair (``_on_jax_duration``, ``_on_jax_event``);
the port's counterparts (``note_phase``, ``note_cache_miss``) are called by
its own compiles: ``ops/_kernels.build`` reports each kernel library it
compiles with ``nvcc`` (one ``cache_miss``, the compiler's seconds as
``backend_compile``) and ``load`` the library's dlopen and binding
(``load``). Here ``nvcc`` is a stand-in script that sleeps SECONDS and
writes its ``-o`` file, and the JAX side fires the same duration:
  - in flight, inside a wrapped call, both records carry the phase: the
    same name, compiled flag, phase keys and ringing, ``backend_s`` within
    timer noise (15% or 5 ms), and one ``cache_miss`` in both counts;
  - with no call in flight, both ring one nameless ``backend_compile``
    record and count one ``cache_miss``;
  - a warm build directory reports nothing, as a jit cache hit does;
  - a ``load`` (of a stand-in library that ``cc`` builds here) rides the
    call in flight, and outside one is counted and never ringed, as the
    JAX package treats its phases other than the backend compile.
Pinned differences: the port's build records say "cuda" (the build is the
card's, whichever process runs it); counts that moved with no record are
exported (a card worker's ``load`` reaches the head); a ``CompiledDAG`` on
the CPU captures nothing and has no phase, where a jitted function reports
its compile.
"""

import numpy as np
import pytest
import torch

from ray_tpu.util import compile_tracker as jct
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.util import compile_tracker as tct

SECONDS = 0.3
LIBRARY = "flash_attention_fwd"
BACKEND_EVENT = "/jax/core/compile/backend_compile_duration"
TRACE_EVENT = "/jax/core/compile/jaxpr_trace_duration"
CACHE_MISS_EVENT = "/jax/compilation_cache/cache_misses"
#: the stand-in compiler: sleeps, then writes its -o file (with STAND_IN,
#: a shared library with the entry points ``load`` binds)
NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  [ "$1" = "-o" ] && out="$2"
  shift
done
sleep {seconds}
{write}
echo "ptxas info    : stand-in"
"""
STAND_IN = """cc -shared -fPIC -x c -o "$out" - <<'EOF'
int flash_attention_fwd(void) { return 0; }
int flash_attention_fwd_smem(void) { return 0; }
const char *kernel_error_string(int e) { return "stand-in"; }
EOF"""


def noise_close(got, want):
    """Timer noise: within 15% or 5 ms."""
    return abs(got - want) <= max(0.005, 0.15 * want)


@pytest.fixture
def trackers(monkeypatch):
    """A fresh process tracker in each package."""
    j = jct.CompileTracker(role="t", storm_threshold=0)
    t = tct.CompileTracker(role="t", storm_threshold=0)
    monkeypatch.setattr(jct, "_global", j)
    monkeypatch.setattr(tct, "_global", t)
    return j, t


def stand_in_nvcc(tmp_path, monkeypatch, library=False):
    script = tmp_path / "nvcc"
    script.write_text(NVCC.format(
        seconds=SECONDS, write=STAND_IN if library else ': > "$out"'))
    script.chmod(0o755)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_kernels, "_loaded", {})


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    stand_in_nvcc(tmp_path, monkeypatch)


def spy_phases(monkeypatch, tracker, seen):
    """Record the phases each ``note_compile`` of ``tracker`` is given."""
    real = tracker.note_compile

    def note(name, signature, wall_s=0.0, phases=None, **kw):
        seen.append(dict(phases or {}))
        return real(name, signature, wall_s=wall_s, phases=phases, **kw)

    monkeypatch.setattr(tracker, "note_compile", note)


def jax_backend_compile():
    """What XLA reports for a compile that missed the cache."""
    jct._on_jax_duration(BACKEND_EVENT, SECONDS)
    jct._on_jax_event(CACHE_MISS_EVENT)


def test_a_build_in_flight_is_the_calls_backend_compile(trackers, nvcc,
                                                        monkeypatch):
    j, t = trackers
    seen = {"jax": [], "torch": []}
    spy_phases(monkeypatch, j, seen["jax"])
    spy_phases(monkeypatch, t, seen["torch"])

    def jax_step(x):
        jax_backend_compile()
        return x

    def torch_step(x):
        _kernels.build([LIBRARY])
        return x

    x = np.zeros((2, 2), np.float32)
    j.wrap(jax_step, name="step", probe=lambda: 0)(x)
    t.wrap(torch_step, name="step", probe=lambda: 0)(x)
    je, te = j.export(), t.export()
    assert [r["name"] for r in je["records"]] == ["step"]
    assert [r["name"] for r in te["records"]] == ["step"]
    jr, tr = je["records"][0], te["records"][0]
    assert jr["kind"] == tr["kind"] == "jit"     # compiled: a record each
    assert jr["signature"] == tr["signature"] == ["f32[2,2]"]
    assert [set(p) for p in seen["jax"]] == [set(p) for p in seen["torch"]] \
        == [set(tr["phases"])] == [{"backend_compile"}]
    assert noise_close(tr["backend_s"], jr["backend_s"]), (tr, jr)
    assert tr["measured_s"] == tr["backend_s"] <= tr["duration_s"]
    assert je["counts"] == te["counts"] == {"jit": 1, "cache_miss": 1}


def test_an_unattributed_build_is_a_nameless_record(trackers, nvcc):
    j, t = trackers
    jax_backend_compile()
    logs = _kernels.build([LIBRARY])
    assert logs == {LIBRARY: "ptxas info    : stand-in\n"}
    assert _kernels.library_path(LIBRARY).exists()
    je, te = j.export(), t.export()
    assert len(je["records"]) == len(te["records"]) == 1
    jr, tr = je["records"][0], te["records"][0]
    for key in ("name", "fingerprint", "signature", "kind", "nth",
                "recompile", "trace_id"):
        assert jr[key] == tr[key], key
    assert tr["name"] == "" and tr["kind"] == "backend_compile"
    assert noise_close(tr["backend_s"], jr["backend_s"]), (tr, jr)
    assert je["counts"] == te["counts"] == \
        {"backend_compile": 1, "cache_miss": 1}
    assert tr["backend"] == "cuda"


def test_a_warm_build_dir_reports_nothing(trackers, nvcc):
    """A library already built: no record, no miss, nothing to export —
    as a jitted function's second call at one signature."""
    import jax
    import jax.numpy as jnp
    j, t = trackers
    _kernels.build([LIBRARY])
    t.export()
    assert _kernels.build([LIBRARY]) == {}
    assert t.export() is None
    assert t.stats()["counts"] == {"backend_compile": 1, "cache_miss": 1}
    # (records of other compiles, such as the input's, are nameless when
    # another test left the JAX listener hooked in this process)
    x = jnp.zeros(4)
    j.export()
    step = j.wrap(jax.jit(lambda x: x * 2 + 1), name="step")
    step(x)
    assert [r["name"] for r in j.export()["records"] if r["name"]] \
        == ["step"]
    step(x)
    assert j.export() is None


def test_a_load_rides_the_call_and_is_otherwise_only_counted(
        trackers, tmp_path, monkeypatch):
    j, t = trackers
    stand_in_nvcc(tmp_path, monkeypatch, library=True)
    lib = t.wrap(lambda: _kernels.load(LIBRARY), name="first_launch",
                 probe=lambda: 0)()
    assert lib.flash_attention_fwd_smem(0, 128, 128, 128) == 0
    assert lib.kernel_error_string(1) == b"stand-in"
    [rec] = t.export()["records"]
    assert rec["name"] == "first_launch"
    assert set(rec["phases"]) == {"backend_compile", "load"}
    assert 0 < rec["phases"]["load"] < rec["phases"]["backend_compile"]
    # a second library's load with no call in flight: counted only, as
    # the JAX package counts a phase other than the backend compile
    monkeypatch.setattr(_kernels, "_loaded", {})
    _kernels.load(LIBRARY)
    jct._on_jax_duration(TRACE_EVENT, 0.01)
    assert j.stats()["counts"] == {"jaxpr_trace": 1}
    assert t.stats()["counts"] == {"jit": 1, "cache_miss": 1, "load": 1}
    # pinned: the port exports counts that moved with no record, so a
    # card worker's library loads reach the head; the JAX package's
    # export waits for a record
    assert j.export() is None
    te = t.export()
    assert te["records"] == [] and te["counts"]["load"] == 1
    assert t.export() is None


def test_a_cpu_dag_has_no_phase_where_a_jit_has_one(trackers):
    """Pinned: the port's ``CompiledDAG`` on CPU tensors records its new
    signature with no phase (nothing is captured), where a jitted
    function's record carries XLA's backend compile."""
    import jax
    import jax.numpy as jnp

    import ray_tpu_torch
    from ray_tpu_torch import dag as tdag
    j, t = trackers
    hooked = jct._jax_hooked
    x = jnp.ones(3)
    assert jct._maybe_hook_jax()
    try:
        j.wrap(jax.jit(lambda x: (x * 2.0) * (x + 1.0)),
               name="dag.compiled")(x)
    finally:
        if not hooked:
            jct._unhook_jax()

    @ray_tpu_torch.remote
    def scale(x):
        return x * 2.0

    @ray_tpu_torch.remote
    def combine(a, b):
        return a * b

    with tdag.InputNode() as inp:
        graph = combine.bind(scale.bind(inp), scale.bind(inp))
    out = tdag.experimental_compile(graph).execute(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 4.0))
    [jr] = [r for r in j.export()["records"] if r["name"]]
    [tr] = t.export()["records"]
    assert jr["name"] == tr["name"] == "dag.compiled"
    assert jr["backend_s"] > 0
    assert tr["phases"] == {} and tr["backend_s"] == 0
    assert tr["backend"] == "cpu"
