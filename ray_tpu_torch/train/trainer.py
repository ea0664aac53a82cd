"""TorchTrainer — the user-facing trainer, the PyTorch port of
``ray_tpu/train/trainer.py``'s ``JaxTrainer``.

Reference shape: python/ray/train/data_parallel_trainer.py:26 (v1 API) run
on the v2 controller. ScalingConfig.mesh describes the job's device mesh;
each worker joins the run's torch.distributed group (NCCL on the card,
gloo on the CPU) and the loop builds the mesh with
``train.get_context().global_mesh()``.
"""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import TrainController
from ray_tpu_torch.train.result import Result


class TorchTrainer:
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[dict] = None):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets

    def fit(self) -> Result:
        controller = TrainController(
            self.train_loop_per_worker, self.scaling_config,
            self.run_config, self.train_loop_config,
            datasets=self.datasets)
        result = controller.run()
        if result.error is not None:
            raise TrainingFailedError(str(result.error)) from result.error
        return result


class TrainingFailedError(RuntimeError):
    """Raised when the failure budget is exhausted (reference:
    train/base_trainer.py TrainingFailedError)."""
