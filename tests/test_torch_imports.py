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


PARALLEL_MODULES = ("mesh", "collectives", "fsdp_overlap", "attention",
                    "ring_attention", "ulysses", "pipeline")
TRAIN_MODULES = ("backend", "config", "checkpoint", "session", "result",
                 "scaling_policy", "worker_group", "controller", "trainer")
#: the cluster's operations surface and the jax-free utilities
OPERATIONS_MODULES = (
    "ray_tpu_torch.util.placement_group", "ray_tpu_torch.cluster_utils",
    "ray_tpu_torch.runtime.instance_manager", "ray_tpu_torch.autoscaler",
    "ray_tpu_torch.jobs", "ray_tpu_torch.util.state",
    "ray_tpu_torch.util.prometheus", "ray_tpu_torch.dashboard",
    "ray_tpu_torch.scripts", "ray_tpu_torch.scripts.cli",
    "ray_tpu_torch.__main__", "ray_tpu_torch.util.actor_pool",
    "ray_tpu_torch.util.queue", "ray_tpu_torch.util.multiprocessing",
    "ray_tpu_torch.util.joblib_backend", "ray_tpu_torch.util.collective",
    "ray_tpu_torch.providers", "ray_tpu_torch.providers.gce_gpu")
SERVE_MODULES = ("batching", "controller", "grpc_proxy", "multiplex",
                 "proxy", "replica", "router", "schema")


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
                "ray_tpu_torch.tune.tuner", "ray_tpu_torch.core.config",
                "ray_tpu_torch.core._native",
                "ray_tpu_torch.core.serialization",
                "ray_tpu_torch._native.build",
                "ray_tpu_torch.accelerators.gpu",
                "ray_tpu_torch.runtime.spawn", "ray_tpu_torch.runtime.wire",
                "ray_tpu_torch.runtime.protocol",
                "ray_tpu_torch.runtime.protocol_native",
                "ray_tpu_torch.runtime.object_plane",
                "ray_tpu_torch.runtime.pubsub", "ray_tpu_torch.runtime.events",
                "ray_tpu_torch.runtime.event_journal",
                "ray_tpu_torch.runtime.runtime_env",
                "ray_tpu_torch.runtime.hw_sampler",
                "ray_tpu_torch.runtime.cgroup", "ray_tpu_torch.runtime.node",
                "ray_tpu_torch.runtime.head",
                "ray_tpu_torch.runtime.cluster_backend",
                "ray_tpu_torch.runtime.worker_main",
                "ray_tpu_torch.util.filesystem",
                "ray_tpu_torch.util.timeseries",
                "ray_tpu_torch.util.stack_profiler",
                "ray_tpu_torch.util.fault_injector",
                "ray_tpu_torch.util.compile_tracker",
                "ray_tpu_torch.util.pubsub", "ray_tpu_torch.util.tracing",
                "ray_tpu_torch.llm.tp", "ray_tpu_torch.dag",
                "ray_tpu_torch.workflow", "ray_tpu_torch.runtime.channel",
                *OPERATIONS_MODULES,
                *(f"ray_tpu_torch.serve.{m}" for m in SERVE_MODULES),
                *(f"ray_tpu_torch.parallel.{m}" for m in PARALLEL_MODULES),
                *(f"ray_tpu_torch.train.{m}" for m in TRAIN_MODULES)):
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


def test_serve_imports_without_torch_jax_or_ray_tpu():
    """Serve (every submodule) and the pubsub and tracing planes it reads
    through need no torch, and the gRPC ingress imports grpc only when it
    starts."""
    mods = ", ".join(["ray_tpu_torch.serve", "ray_tpu_torch.util.pubsub",
                      "ray_tpu_torch.util.tracing",
                      *(f"ray_tpu_torch.serve.{m}" for m in SERVE_MODULES)])
    code = (f"import {mods}\n"
            "from ray_tpu_torch import serve\n"
            "for name in serve.__all__:\n"
            "    getattr(serve, name)\n"
            "assert 'torch' not in sys.modules, 'torch'\n"
            "assert 'grpc' not in sys.modules, 'grpc'\n")
    assert _run(code) == "[]"


def test_operations_surface_imports_without_torch_jax_or_ray_tpu():
    """The instance manager, autoscaler, CLI, dashboard and the other
    modules of the operations surface import no torch (the daemons and the
    CLI hold no card) and no joblib (the card's machine has none): the
    joblib backend imports it when it registers."""
    code = (f"import {', '.join(OPERATIONS_MODULES)}\n"
            "assert 'torch' not in sys.modules, 'torch'\n"
            "assert 'joblib' not in sys.modules, 'joblib'\n")
    assert _run(code) == "[]"


def test_rllib_imports_without_jax_or_ray_tpu():
    assert _run("import ray_tpu_torch.rllib\n") == "[]"


@pytest.mark.parametrize("script", ["chip_smoke", "chip_compare"])
def test_script_imports_without_jax_or_ray_tpu(script):
    """Scripts at the repo's root that drive the port on the card."""
    assert (ROOT / f"{script}.py").is_file()
    assert _run(f"import {script}\n") == "[]"


def test_cluster_worker_imports_without_jax_or_ray_tpu():
    """In cluster mode a task's worker process holds nothing of JAX or of
    the JAX package, and the runtime brings in no torch either."""
    code = (
        "import ray_tpu_torch as rt\n"
        "rt.init(num_cpus=1, _system_config={\n"
        "    'object_store_memory_bytes': 64 << 20})\n"
        "@rt.remote\n"
        "def modules():\n"
        "    import sys\n"
        "    return sorted(sys.modules)\n"
        "names = rt.get(modules.remote(), timeout=120)\n"
        "rt.shutdown()\n"
        "assert 'ray_tpu_torch.runtime.cluster_backend' in names, names\n"
        "assert 'torch' not in names, 'torch in the worker'\n"
        "print(sorted(m for m in names if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu')))\n")
    out = _run(code).splitlines()
    assert out[-2:] == ["[]", "[]"], out


# runs a daemon's module as __main__ and rewrites the file named by its
# first argument with the names in sys.modules every 0.2 s
_DAEMON_WRAPPER = (
    "import os, runpy, sys, threading, time\n"
    "out, mod = sys.argv[1], sys.argv[2]\n"
    "sys.argv = [mod] + sys.argv[3:]\n"
    "def dump():\n"
    "    while True:\n"
    "        time.sleep(0.2)\n"
    "        with open(out + '.tmp', 'w') as f:\n"
    "            f.write('\\n'.join(sorted(sys.modules)))\n"
    "        os.replace(out + '.tmp', out)\n"
    "threading.Thread(target=dump, daemon=True).start()\n"
    "runpy.run_module(mod, run_name='__main__', alter_sys=True)\n")


def test_daemons_import_neither_torch_nor_jax(tmp_path):
    """The head and the node daemon, booted as ``init()`` boots them,
    import no torch, no JAX and nothing of the JAX package."""
    import json
    import os
    import socket
    import time

    from ray_tpu_torch.core.config import GlobalConfig
    from ray_tpu_torch.runtime.spawn import child_env

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    session = os.urandom(4).hex()
    cfg = json.loads(GlobalConfig.to_json())
    procs = []
    try:
        head = subprocess.Popen(
            [sys.executable, "-c", _DAEMON_WRAPPER, str(tmp_path / "head"),
             "ray_tpu_torch.runtime.head", str(port), session,
             json.dumps(cfg)],
            env=child_env(), cwd=ROOT, stdout=subprocess.PIPE, text=True)
        procs.append(head)
        assert head.stdout.readline().startswith("RTPT_HEAD_READY")
        node = subprocess.Popen(
            [sys.executable, "-c", _DAEMON_WRAPPER, str(tmp_path / "node"),
             "ray_tpu_torch.runtime.node", f"127.0.0.1:{port}", session,
             json.dumps({"resources": {"CPU": 1.0},
                         "object_store_bytes": 32 << 20,
                         "config": cfg})],
            env=child_env(), cwd=ROOT, stdout=subprocess.PIPE, text=True)
        procs.append(node)
        assert node.stdout.readline().startswith("RTPT_NODE_READY")
        # the node's first hardware sample and telemetry push (2 s period)
        # import what the daemons import lazily
        time.sleep(3.0)
        for name in ("head", "node"):
            mods = (tmp_path / name).read_text().split()
            assert "ray_tpu_torch.runtime.protocol" in mods
            bad = [m for m in mods if m.split(".")[0] in
                   ("torch", "jax", "jaxlib", "ray_tpu")]
            assert bad == [], (name, bad)
    finally:
        for p in reversed(procs):
            p.terminate()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def test_parallel_axis_modules_import_without_jax_or_ray_tpu():
    """Tensor-parallel serving and the sp, pp and ep paths on their own."""
    assert _run("import ray_tpu_torch.llm.tp, "
                "ray_tpu_torch.parallel.ring_attention, "
                "ray_tpu_torch.parallel.ulysses, "
                "ray_tpu_torch.parallel.pipeline, "
                "ray_tpu_torch.parallel.attention\n") == "[]"


def test_dag_workflow_and_channel_import_without_jax_or_ray_tpu():
    """The DAGs, the workflows and the shm channels on their own; none of
    them needs torch to import (a CompiledDAG imports it to execute)."""
    code = ("import ray_tpu_torch.dag, ray_tpu_torch.workflow, "
            "ray_tpu_torch.runtime.channel\n"
            "assert 'torch' not in sys.modules, 'torch'\n")
    assert _run(code) == "[]"
