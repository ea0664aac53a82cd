"""Training of the PyTorch port (``ray_tpu.train`` counterparts): the train
step builder, the Adafactor optimizer (``optax.adafactor``) and the step
profiler. The trainer, worker group and sharded checkpoints come with the
distributed-training slice."""

from ray_tpu_torch.train.optim import Adafactor
from ray_tpu_torch.train.step_profiler import (PHASES, StepBreakdown,
                                               profile_train_step)
from ray_tpu_torch.train.train_step import make_train_step, param_leaves

__all__ = ["make_train_step", "param_leaves", "profile_train_step",
           "StepBreakdown", "PHASES", "Adafactor"]
