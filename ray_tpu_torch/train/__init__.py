"""ray_tpu_torch.train — distributed training, the PyTorch port of
``ray_tpu.train``.

``TorchTrainer`` runs ``train_loop_per_worker`` on a group of worker
processes of the port's runtime (``WorkerGroup``, one rank each, a card
each with ``ScalingConfig.use_gpu``, by default whenever the cluster has
one), under the v2 controller
state machine (failure restarts from the latest checkpoint, elastic
shrink and grow). Each worker joins one torch.distributed process group
(NCCL on the card, gloo on the CPU) before the loop; the loop builds the
device mesh (``get_context().global_mesh()``), shards the parameters
(``shard_params``: DTensors) and trains with ``make_train_step``;
checkpoints are sharded, each rank writing its own pieces. The
``Adafactor`` optimizer and the step profiler sit beside them. Not in the
port yet: the RL learners' mesh path (``rllib``'s ``build(mesh=)``).
"""

from ray_tpu_torch.train.checkpoint import (Checkpoint, CheckpointCorrupt,
                                            CheckpointManager)
from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                        RunConfig, ScalingConfig)
from ray_tpu_torch.train.optim import Adafactor
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.train.session import (TrainContext, get_checkpoint,
                                         get_context, get_dataset_shard,
                                         report)
from ray_tpu_torch.train.step_profiler import (PHASES, StepBreakdown,
                                               profile_train_step)
from ray_tpu_torch.train.train_step import (make_train_step, param_leaves,
                                            shard_batch, shard_params)
from ray_tpu_torch.train.trainer import TorchTrainer, TrainingFailedError

__all__ = [
    "TorchTrainer", "TrainingFailedError", "RunConfig", "ScalingConfig",
    "FailureConfig", "CheckpointConfig", "Checkpoint", "CheckpointCorrupt",
    "CheckpointManager", "Result", "TrainContext",
    "get_context", "get_checkpoint", "get_dataset_shard", "report",
    "make_train_step", "shard_params", "shard_batch", "param_leaves",
    "profile_train_step", "StepBreakdown", "PHASES", "Adafactor",
]
