"""Training tier of the PyTorch port (counterpart of `ray_tpu.train`)."""

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import (BaseTrainer, DataParallelTrainer,
                                         Result, TorchTrainer)

__all__ = ["BaseTrainer", "DataParallelTrainer", "Result", "RunConfig",
           "ScalingConfig", "TorchTrainer"]
