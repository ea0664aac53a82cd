"""Jax-free planes the port's runtime, engine, server and trainer report
through: the port's own copies of ``ray_tpu/util/``'s metrics, trace
context, log, pubsub, tracing, stack-profiler, timeseries, filesystem,
fault-injection and compile-tracking modules, and of its operations
surface: placement groups, the state API, the Prometheus exposition and
the actor pool, queue, multiprocessing, joblib and collective helpers."""

from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                remove_placement_group)

__all__ = ["placement_group", "remove_placement_group", "PlacementGroup"]
