"""@ray_tpu_torch.remote for functions.

Role-equivalent to the reference's RemoteFunction
(reference: python/ray/remote_function.py:303 `_remote`): wraps a function,
carries default options (num_returns/resources/retries/scheduling strategy),
`f.remote(...)` builds a TaskSpec and submits through the worker;
`.options(...)` returns a shallow override wrapper.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.core.worker import require_connected

_VALID_OPTIONS = {
    "num_returns", "num_cpus", "num_tpus", "num_gpus", "resources",
    "max_retries", "retry_exceptions", "name", "scheduling_strategy",
    "placement_group", "placement_group_bundle_index", "runtime_env",
    "memory", "_metadata",
}


#: the runtime_env keys local mode applies (``local_backend.py``
#: ``_applied_runtime_env``)
RUNTIME_ENV_KEYS = {"env_vars"}


def validate_runtime_env(runtime_env: Optional[dict]) -> Optional[dict]:
    """Check a runtime_env when the function or class is decorated: a dict
    whose keys local mode knows, ``env_vars`` a ``Dict[str, str]``. Raises
    instead of ignoring what local mode cannot apply."""
    if runtime_env is None:
        return None
    if not isinstance(runtime_env, dict):
        raise ValueError(
            f"runtime_env must be a dict, got {type(runtime_env).__name__}")
    unknown = set(runtime_env) - RUNTIME_ENV_KEYS
    if unknown:
        raise NotImplementedError(
            f"runtime_env keys {sorted(unknown)} are not supported in local "
            f"mode (supported: {sorted(RUNTIME_ENV_KEYS)})")
    env_vars = runtime_env.get("env_vars")
    if env_vars is not None and (not isinstance(env_vars, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env_vars.items())):
        raise ValueError("runtime_env['env_vars'] must be Dict[str, str]")
    return {"env_vars": dict(env_vars)} if env_vars else None


def _build_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    resources: Dict[str, float] = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        resources["CPU"] = float(opts["num_cpus"])
    if opts.get("num_tpus") is not None:
        resources["TPU"] = float(opts["num_tpus"])
    if opts.get("num_gpus") is not None:
        resources["GPU"] = float(opts["num_gpus"])
    if opts.get("memory") is not None:
        resources["memory"] = float(opts["memory"])
    return resources


class RemoteFunction:
    def __init__(self, function, options: Optional[Dict[str, Any]] = None):
        self._function = function
        self._options = dict(options or {})
        for k in self._options:
            if k not in _VALID_OPTIONS:
                raise ValueError(f"invalid option {k!r} for @remote")
        # fail-fast on unsupported/malformed envs at decoration time —
        # never silently dropped (reference: runtime_env plugin validation)
        self._options["runtime_env"] = validate_runtime_env(
            self._options.get("runtime_env"))
        functools.update_wrapper(self, function)
        self._exported_key: Optional[bytes] = None

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._function.__name__} cannot be called "
            "directly — use .remote()")

    def options(self, **opts) -> "RemoteFunction":
        merged = {**self._options, **opts}
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        worker = require_connected()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        spec = TaskSpec(
            task_id=worker.next_task_id(),
            name=opts.get("name") or self._function.__qualname__,
            function=self._function,
            args=worker.make_task_args(args),
            kwargs=dict(kwargs),
            num_returns=0 if streaming else num_returns,
            streaming=streaming,
            resources=_build_resources(opts) or {"CPU": 1.0},
            max_retries=opts.get("max_retries", 3),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            scheduling_strategy=opts.get("scheduling_strategy"),
            runtime_env=opts.get("runtime_env"),
        )
        pg = opts.get("placement_group")
        if pg is not None:
            spec.placement_group_id = pg.id.binary()
            spec.placement_bundle_index = opts.get(
                "placement_group_bundle_index", -1)
        refs = worker.submit_task(spec)
        if streaming:
            return refs  # an ObjectRefGenerator
        if num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference: ray.dag dag_node.py:32): not in this
        package until ``dag.py`` is ported (ROADMAP Queue 1 item 11)."""
        raise NotImplementedError(
            "bind() needs ray_tpu_torch.dag, which is not ported yet "
            "(ROADMAP Queue 1 item 11)")

    @property
    def underlying_function(self):
        return self._function


def remote_decorator(*args, **kwargs):
    """Implements @remote and @remote(**options) for functions and classes."""
    from ray_tpu_torch.actor import ActorClass
    import inspect

    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if inspect.isclass(target):
            return ActorClass(target, {})
        return RemoteFunction(target, {})

    if args:
        raise TypeError("@remote takes keyword options only")

    def wrap(target):
        if inspect.isclass(target):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return wrap
