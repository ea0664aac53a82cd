"""Child-process environment construction shared by all daemon spawners."""

from __future__ import annotations

import os
from typing import Dict


def child_env(extra: Dict[str, str] | None = None) -> Dict[str, str]:
    """Env for spawned daemons/workers: make the ray_tpu_torch package importable
    even when the parent added it via sys.path (not PYTHONPATH)."""
    import ray_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    if extra:
        env.update(extra)
    return env
