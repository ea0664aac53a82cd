"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import ray_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ray_tpu_torch.__path__, prefix="ray_tpu_torch."))


def test_every_module_imports_without_jax_or_ray_tpu():
    mods = _modules()
    assert "ray_tpu_torch.ops.paged_attention" in mods
    assert "ray_tpu_torch.llm.serve_llm" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import ray_tpu_torch\n"
        "for name in ray_tpu_torch.__all__:\n"
        "    getattr(ray_tpu_torch, name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
