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
                "ray_tpu_torch.models.mixtral", "ray_tpu_torch.models.mlp"):
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


@pytest.mark.parametrize("script", ["chip_smoke", "chip_compare"])
def test_script_imports_without_jax_or_ray_tpu(script):
    """Scripts at the repo's root that drive the port on the card."""
    assert (ROOT / f"{script}.py").is_file()
    assert _run(f"import {script}\n") == "[]"
