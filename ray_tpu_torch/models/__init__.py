"""Model definitions of the PyTorch port (``ray_tpu.models`` counterparts):
the Llama family, the MLP, and (``models.mixtral``) the Mixtral family.
``param_specs`` waits for the device mesh."""

from ray_tpu_torch.models.llama import (LlamaConfig, forward, init_params,
                                        loss_fn)
from ray_tpu_torch.models.mlp import MLPConfig, mlp_apply, mlp_init

__all__ = [
    "LlamaConfig", "init_params", "forward", "loss_fn",
    "MLPConfig", "mlp_init", "mlp_apply",
]
