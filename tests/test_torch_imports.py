"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

# after the imports, print the modules of JAX and of the JAX package loaded
_FOREIGN = (
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'ray_tpu'))\n"
    "print(bad)\n")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ray_tpu_torch.__path__, prefix="ray_tpu_torch."))


def _run(code):
    out = subprocess.run([sys.executable, "-c", "import sys\n" + code
                          + _FOREIGN], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_every_module_imports_without_jax_or_ray_tpu():
    mods = _modules()
    assert "ray_tpu_torch.ops.paged_attention" in mods
    assert "ray_tpu_torch.llm.serve_llm" in mods
    assert "ray_tpu_torch.ops.flash_attention" in mods
    assert "ray_tpu_torch.train.train_step" in mods
    assert "ray_tpu_torch.train.step_profiler" in mods
    for new in ("ray_tpu_torch.util.metrics", "ray_tpu_torch.util.log_plane",
                "ray_tpu_torch.util.trace_context",
                "ray_tpu_torch.llm.request_log", "ray_tpu_torch.llm.batch",
                "ray_tpu_torch.train.optim", "ray_tpu_torch.parallel.moe",
                "ray_tpu_torch.models.mixtral", "ray_tpu_torch.models.mlp",
                "ray_tpu_torch.exceptions", "ray_tpu_torch.remote_function",
                "ray_tpu_torch.actor", "ray_tpu_torch.core.ids",
                "ray_tpu_torch.core.task_spec",
                "ray_tpu_torch.core.object_ref",
                "ray_tpu_torch.core.memory_store",
                "ray_tpu_torch.core.refcount", "ray_tpu_torch.core.generator",
                "ray_tpu_torch.core.worker",
                "ray_tpu_torch.core.local_backend",
                "ray_tpu_torch.rllib.env", "ray_tpu_torch.rllib.replay",
                "ray_tpu_torch.rllib.module", "ray_tpu_torch.rllib.learner",
                "ray_tpu_torch.rllib.env_runner",
                "ray_tpu_torch.rllib.trainer_base",
                "ray_tpu_torch.rllib.algorithm", "ray_tpu_torch.rllib.impala",
                "ray_tpu_torch.rllib.dqn", "ray_tpu_torch.rllib.sac",
                "ray_tpu_torch.rllib.bc", "ray_tpu_torch.data",
                "ray_tpu_torch.data.block", "ray_tpu_torch.data.dataset",
                "ray_tpu_torch.data.iterator", "ray_tpu_torch.data.read_api",
                "ray_tpu_torch.data._internal",
                "ray_tpu_torch.data._internal.shuffle",
                "ray_tpu_torch.data._internal.streaming_executor",
                "ray_tpu_torch.tune", "ray_tpu_torch.tune.search",
                "ray_tpu_torch.tune.searcher", "ray_tpu_torch.tune.trial",
                "ray_tpu_torch.tune.schedulers",
                "ray_tpu_torch.tune.tune_controller",
                "ray_tpu_torch.tune.tuner"):
        assert new in mods, new
    code = (
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import ray_tpu_torch\n"
        "for name in ray_tpu_torch.__all__:\n"
        "    getattr(ray_tpu_torch, name)\n")
    assert _run(code) == "[]"


def test_model_modules_import_without_jax_or_ray_tpu():
    """The second model family and the MLP on their own."""
    assert _run("import ray_tpu_torch.models.mixtral, "
                "ray_tpu_torch.parallel.moe, ray_tpu_torch.models.mlp\n") \
        == "[]"


def test_runtime_imports_without_torch_jax_or_ray_tpu():
    """The copied local-mode runtime needs neither torch nor JAX."""
    code = ("import ray_tpu_torch\n"
            "ray_tpu_torch.init(local_mode=True)\n"
            "ray_tpu_torch.shutdown()\n"
            "assert 'torch' not in sys.modules, 'torch'\n")
    assert _run(code) == "[]"


def test_data_and_tune_import_without_torch_jax_or_ray_tpu():
    """The copied datasets and Tune need neither torch nor JAX until a
    caller asks for tensors."""
    code = ("import ray_tpu_torch.data, ray_tpu_torch.data._internal\n"
            "import ray_tpu_torch.tune\n"
            "assert 'torch' not in sys.modules, 'torch'\n")
    assert _run(code) == "[]"


def test_rllib_imports_without_jax_or_ray_tpu():
    assert _run("import ray_tpu_torch.rllib\n") == "[]"


@pytest.mark.parametrize("script", ["chip_smoke", "chip_compare"])
def test_script_imports_without_jax_or_ray_tpu(script):
    """Scripts at the repo's root that drive the port on the card."""
    assert (ROOT / f"{script}.py").is_file()
    assert _run(f"import {script}\n") == "[]"
