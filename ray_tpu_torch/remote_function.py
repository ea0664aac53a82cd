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
        # (env_vars and working_dir; local mode applies env_vars only and
        # fails a call that asks for a working_dir, as the JAX package's
        # local mode does)
        from ray_tpu_torch.runtime import runtime_env as rtenv
        self._options["runtime_env"] = rtenv.validate(
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
        """Lazy DAG node (reference: ray.dag dag_node.py:32) — builds the
        graph without executing; see ray_tpu_torch.dag."""
        from ray_tpu_torch.dag import DAGNode
        return DAGNode(self, args, kwargs)

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
