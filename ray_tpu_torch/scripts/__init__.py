"""CLI entrypoints (reference: python/ray/scripts/scripts.py); the port
of ``ray_tpu/scripts/``."""
