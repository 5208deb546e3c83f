"""ray_tpu_torch.train: multi-worker training harness (counterpart of
`ray_tpu.train`, the reference's Ray Train + AIR).

The main path: `TorchTrainer.fit()` starts the worker actors (each granted
its GPUs), forms the torch.distributed group when there is more than one,
and runs the user's loop with `session.report` streaming metrics and
checkpoints back.
"""

from ray_tpu_torch.train.backend import (
    Backend,
    BackendConfig,
    TorchBackend,
    TorchConfig,
)
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  TrainingFailedError)
from ray_tpu_torch.train.batch_predictor import (BatchPredictor, Predictor,
                                                 TorchPredictor)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    broadcast_params,
    get_checkpoint,
    get_collective,
    get_context,
    get_dataset_shard,
    get_device,
    get_ingest_stats,
    get_local_rank,
    get_mesh,
    get_world_rank,
    get_world_size,
    report,
    sync_gradients,
)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    Result,
    TorchTrainer,
)
from ray_tpu_torch.train.integrations import (
    LightGBMTrainer,
    TransformersTrainer,
    XGBoostTrainer,
    prepare_trainer,
)
from ray_tpu_torch.train.worker_group import TrainWorker, WorkerGroup

__all__ = [
    "Backend", "BackendConfig", "BackendExecutor", "BaseTrainer",
    "BatchPredictor", "Predictor", "TorchPredictor",
    "Checkpoint", "CheckpointConfig", "CheckpointManager",
    "DataParallelTrainer", "FailureConfig", "Result", "RunConfig",
    "ScalingConfig", "TorchBackend", "TorchConfig", "TorchTrainer",
    "TrainWorker", "TrainingFailedError", "WorkerGroup", "broadcast_params",
    "get_checkpoint", "get_collective", "get_context", "get_dataset_shard",
    "get_device", "get_ingest_stats", "get_local_rank", "get_mesh",
    "get_world_rank", "get_world_size", "report", "sync_gradients",
    "TransformersTrainer", "XGBoostTrainer", "LightGBMTrainer",
    "prepare_trainer",
]
