"""ray_tpu_torch.rllib: reinforcement learning on the new-stack architecture.

The port of `ray_tpu/rllib/`: the reference's RLModule/Learner/
LearnerGroup/RolloutWorker stack (`rllib/core/`, `rllib/evaluation/`, the
new stack only) with torch nets, the learner's update on the card and the
rollout workers sampling on CPU actors of the port's runtime. Offline IO
and BC (`offline.py`) write and read experiences through
`ray_tpu_torch.data`.
"""

from ray_tpu_torch.rllib.connectors import (
    Connector,
    ConnectorPipeline,
    FrameStack,
    GrayscaleResize,
    atari_connectors,
)
from ray_tpu_torch.rllib.env import (
    CartPoleVectorEnv,
    CatchVectorEnv,
    ConnectorVectorEnv,
    GymnasiumVectorEnv,
    VectorEnv,
    make_env,
)
from ray_tpu_torch.rllib.impala import (
    IMPALA,
    IMPALAConfig,
    IMPALALearner,
    vtrace_returns,
)
from ray_tpu_torch.rllib.appo import APPO, APPOConfig, APPOLearner
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNLearner, QModule
from ray_tpu_torch.rllib.external import PolicyClient, PolicyServer
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.offline import (
    BC,
    BCConfig,
    BCLearner,
    batch_to_rows,
    iter_learner_batches,
    read_batches,
    rows_to_batch,
    write_batches,
)
from ray_tpu_torch.rllib.replay_buffers import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, PPOLearner
from ray_tpu_torch.rllib.rl_module import (
    ConvPolicyModule,
    DiscretePolicyModule,
    RLModule,
    SpecDict,
    build_module,
)
from ray_tpu_torch.rllib.rollout import RolloutWorker, WorkerSet

__all__ = [
    "VectorEnv", "CartPoleVectorEnv", "CatchVectorEnv",
    "ConnectorVectorEnv", "GymnasiumVectorEnv", "make_env",
    "Connector", "ConnectorPipeline", "FrameStack", "GrayscaleResize",
    "atari_connectors",
    "RLModule", "DiscretePolicyModule", "ConvPolicyModule", "SpecDict",
    "build_module",
    "Learner", "LearnerGroup", "RolloutWorker", "WorkerSet",
    "PPO", "PPOConfig", "PPOLearner",
    "IMPALA", "IMPALAConfig", "IMPALALearner", "vtrace_returns",
    "APPO", "APPOConfig", "APPOLearner",
    "DQN", "DQNConfig", "DQNLearner", "QModule",
    "ReplayBuffer", "PrioritizedReplayBuffer",
    "PolicyServer", "PolicyClient",
    "BC", "BCConfig", "BCLearner", "batch_to_rows", "rows_to_batch",
    "write_batches", "read_batches", "iter_learner_batches",
]
