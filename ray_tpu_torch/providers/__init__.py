"""Cloud node providers for the autoscaler's NodeProvider seam."""

from ray_tpu_torch.providers.gce_gpu import GceGpuNodeProvider

__all__ = ["GceGpuNodeProvider"]
