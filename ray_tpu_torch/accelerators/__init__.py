"""Accelerator managers (reference: python/ray/_private/accelerators/)."""

from ray_tpu_torch.accelerators.gpu import (DeviceAllocator,
                                            GPUAcceleratorManager)

__all__ = ["GPUAcceleratorManager", "DeviceAllocator"]
