"""chip_smoke.py's phase 18 rehearsed on the CPU at tiny sizes, through its
own phase functions, each in a fresh process (18b boots a cluster, 18c
joins a process group, 18d needs phase 4's engine to be the process's
first): 18b (the compiled actor chain: ordering, an error through the
channel, teardown; its speed criterion is the card's, so 0 here), 18c
(PPO, IMPALA and BC through ``build(mesh=)`` on a one-rank gloo mesh,
one update each equal to the bit to ``mesh=None``) and 18d (phase 4's
requests on the tiny fp32 model, then the tracker's records, no breach,
and the A/B in turns with the ragged calls counted as the kernel's
wrapper counts them on the card). 18a captures a CUDA graph, which has
no CPU mode: tests/test_torch_kernels_cuda.py holds it on the card.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_HEAD = """
import sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
import chip_smoke
cpu = torch.device("cpu")
"""


def _run(body, timeout=300):
    out = subprocess.run(
        [sys.executable, "-c", _HEAD.format(root=str(ROOT)) + body],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return out.stdout


def test_phase_18b_actor_dag_on_the_cpu():
    out = _run("print(chip_smoke.phase_actor_dag(n=50, speedup=0.0))")
    assert "18b compiled actor DAG" in out
    assert "compiled_per_s" in out


def test_phase_18c_rl_mesh_on_the_cpu():
    out = _run("chip_smoke.phase_rl_mesh(cpu)")
    assert "18c RL on a one-rank gloo mesh" in out
    for name in ("PPO", "IMPALA", "BC"):
        assert f"{name} {{" in out, out


def test_phase_18d_tracker_on_the_cpu():
    out = _run("""
from ray_tpu_torch.llm import model as tmodel
from ray_tpu_torch.ops import paged_attention as tpa
ragged = tmodel.ragged_paged_attention

def count_ragged(*args, **kwargs):
    tpa.launch_counts["ragged_paged_attention"] += 1
    return ragged(*args, **kwargs)

tmodel.ragged_paged_attention = count_ragged
TINY = {"preset": "tiny", "n_layers": 2, "dtype": "float32"}
engine = dict(chip_smoke.MAIN_ENGINE, device="cpu")
here = chip_smoke.MainServer(TINY, engine)
try:
    here.answer()
    programs = here.srv.engine.compiled_step_programs()
finally:
    here.srv.shutdown()
launches = chip_smoke.phase_tracker(programs, TINY, engine)
assert launches > 0, launches
print("LAUNCHES", launches, "PROGRAMS", programs)
""")
    assert "18d compile tracker" in out and "no breach event" in out
    assert "LAUNCHES" in out
