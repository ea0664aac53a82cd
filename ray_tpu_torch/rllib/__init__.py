"""ray_tpu_torch.rllib — RL training: EnvRunner actors + torch learners.

The port of ``ray_tpu/rllib``: PPO, IMPALA, DQN and SAC, their learners
and env runners, and offline behavior cloning (``BC`` over a dataset that
``record_dataset`` writes with ``ray_tpu_torch.data``), on the port's
local-mode runtime (``ray_tpu_torch.init(local_mode=True)``). Each
``*Config.build(device=)`` runs its learner and runners on that device,
the card unless the caller asks for the CPU.
"""

from ray_tpu_torch.rllib.algorithm import PPO, PPOConfig
from ray_tpu_torch.rllib.bc import BC, BCConfig, BCLearner, record_dataset
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNLearner
from ray_tpu_torch.rllib.env import (ENV_REGISTRY, CartPoleVectorEnv,
                                     PendulumVectorEnv, VectorEnv)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.impala import (IMPALA, IMPALAConfig,
                                        IMPALALearner, vtrace)
from ray_tpu_torch.rllib.learner import PPOLearner, compute_gae
from ray_tpu_torch.rllib.module import forward, init_module, sample_actions
from ray_tpu_torch.rllib.replay import ReplayBuffer
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACLearner

__all__ = [
    "BC", "BCConfig", "BCLearner", "record_dataset",
    "DQN", "DQNConfig", "DQNLearner", "ReplayBuffer",
    "IMPALA", "IMPALAConfig", "IMPALALearner", "vtrace",
    "PPO", "PPOConfig", "PPOLearner", "EnvRunner", "VectorEnv",
    "CartPoleVectorEnv", "PendulumVectorEnv", "ENV_REGISTRY",
    "SAC", "SACConfig", "SACLearner",
    "compute_gae", "init_module", "forward", "sample_actions",
]
