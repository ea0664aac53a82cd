"""Jax-free planes the port's engine, server and trainer report through:
the port's own copies of ``ray_tpu/util/{metrics,trace_context,log_plane}.py``
(only what the port calls)."""
