"""Per-task/actor runtime environments: env_vars + working_dir.

Role-equivalent to the reference's runtime_env subsystem (reference:
python/ray/_private/runtime_env/ — working_dir.py packaging + URI cache,
plugin.py validation; the per-node agent that materializes envs). Scoped to
the two capabilities that matter on a GPU cluster image (the machine image
pins the torch/CUDA versions, so pip/conda envs are a foot-gun there):

 - ``env_vars``: spawned into the worker process environment BEFORE any
   runtime initializes (CUDA reads CUDA_* when it makes its context).
 - ``working_dir``: a local directory content-hash-zipped by the driver,
   uploaded once to the head KV (reference: working_dir URI upload to GCS),
   materialized into a per-node cache by the node daemon, and used as the
   worker's cwd + sys.path[0].

Workers are pooled per environment signature — a worker started with one
env never serves leases for another (reference: WorkerPool keys workers by
runtime_env hash, worker_pool.h:224). Unsupported keys raise immediately
instead of being silently dropped.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Any, Callable, Dict, Optional, Tuple

SUPPORTED_KEYS = {"env_vars", "working_dir"}

#: reference caps working_dir at 100 MiB by default
#: (ray_constants: RAY_RUNTIME_ENV_WORKING_DIR_SIZE_LIMIT ~ 100 MiB)
MAX_WORKING_DIR_BYTES = 100 * 1024 * 1024

_KV_PREFIX = "rtenv:pkg:"


def validate(runtime_env: Optional[dict]) -> Optional[dict]:
    """Check keys/types up-front, at decoration/option time.

    Raises ValueError for malformed values and NotImplementedError for
    reference keys outside this build's scope (pip/conda/py_modules/...),
    so a user never gets a silently-ignored environment.
    """
    if runtime_env is None:
        return None
    if not isinstance(runtime_env, dict):
        raise ValueError(
            f"runtime_env must be a dict, got {type(runtime_env).__name__}")
    if not runtime_env:
        return None
    unsupported = set(runtime_env) - SUPPORTED_KEYS
    if unsupported:
        raise NotImplementedError(
            f"runtime_env keys {sorted(unsupported)} are not supported by "
            f"this build (supported: {sorted(SUPPORTED_KEYS)}); pin "
            f"python-level dependencies in the cluster image instead")
    out: Dict[str, Any] = {}
    env_vars = runtime_env.get("env_vars")
    if env_vars is not None:
        if not isinstance(env_vars, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in env_vars.items()):
            raise ValueError("runtime_env['env_vars'] must be Dict[str, str]")
        if env_vars:
            out["env_vars"] = dict(env_vars)
    wd = runtime_env.get("working_dir")
    if wd is not None:
        if not isinstance(wd, str):
            raise ValueError("runtime_env['working_dir'] must be a path str")
        out["working_dir"] = wd
    return out or None


def package_working_dir(path: str) -> Tuple[str, bytes]:
    """Deterministic content-hashed zip of a directory.

    Fixed timestamps + sorted entries make the archive a pure function of
    the directory contents, so the URI doubles as a cache key across
    drivers (reference: working_dir upload is content-addressed into GCS).
    """
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env working_dir {path!r} is not a directory")
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs.sort()
            # skip caches that would churn the hash without changing code
            dirs[:] = [d for d in dirs if d not in ("__pycache__", ".git")]
            for fname in sorted(files):
                full = os.path.join(root, fname)
                rel = os.path.relpath(full, path)
                try:
                    mode = os.stat(full).st_mode & 0o777
                    data = open(full, "rb").read()
                except OSError:
                    continue  # vanished/broken-symlink files are skipped
                total += len(data)
                if total > MAX_WORKING_DIR_BYTES:
                    raise ValueError(
                        f"working_dir {path!r} exceeds "
                        f"{MAX_WORKING_DIR_BYTES >> 20} MiB; ship data "
                        f"through the object store, not the runtime env")
                info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
                info.external_attr = mode << 16
                zf.writestr(info, data)
    blob = buf.getvalue()
    uri = hashlib.sha256(blob).hexdigest()[:24]
    return uri, blob


def kv_key(uri: str) -> str:
    return _KV_PREFIX + uri


def descriptor_key(descriptor: Optional[dict]) -> str:
    """Stable signature used to pool workers per environment ('' = none)."""
    if not descriptor:
        return ""
    return hashlib.sha1(
        json.dumps(descriptor, sort_keys=True).encode()).hexdigest()[:16]


def materialize(cache_root: str, uri: str,
                fetch: Callable[[str], Optional[bytes]]) -> str:
    """Extract a packaged working_dir into the node-local cache (idempotent;
    reference: per-node runtime-env agent URI cache). `fetch` maps a KV key
    to the zip bytes (the head KV holds the uploaded package)."""
    dest = os.path.join(cache_root, uri)
    marker = os.path.join(dest, ".rtenv_ready")
    if os.path.exists(marker):
        return dest
    blob = fetch(kv_key(uri))
    if blob is None:
        raise RuntimeError(
            f"working_dir package {uri} missing from the cluster KV "
            f"(head restarted without persistence?)")
    # unique tmp per attempt: concurrent materializations of the same URI
    # must not rmtree each other's half-extracted trees
    import shutil
    import threading
    tmp = f"{dest}.tmp{os.getpid()}_{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
        for info in zf.infolist():
            mode = (info.external_attr >> 16) & 0o777
            if mode:
                os.chmod(os.path.join(tmp, info.filename), mode)
    open(os.path.join(tmp, ".rtenv_ready"), "w").close()
    try:
        os.replace(tmp, dest)
    except OSError:
        # lost a concurrent-materialize race: the winner's copy is complete
        shutil.rmtree(tmp, ignore_errors=True)
    return dest


def worker_env(descriptor: Optional[dict],
               working_dir_path: Optional[str]) -> Dict[str, str]:
    """Environment additions for a worker spawned under this descriptor."""
    env: Dict[str, str] = {}
    if descriptor:
        env.update(descriptor.get("env_vars") or {})
    if working_dir_path:
        env["RTPT_WORKING_DIR"] = working_dir_path
    return env
