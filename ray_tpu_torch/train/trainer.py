"""Trainers: BaseTrainer -> DataParallelTrainer -> TorchTrainer.

The port's copy of `ray_tpu/train/trainer.py` (the reference's
`BaseTrainer.fit`, `python/ray/train/base_trainer.py:555`, and
`DataParallelTrainer`, `data_parallel_trainer.py:56`). `fit()` starts the
runtime when it is not up and runs the loop in worker actors through the
BackendExecutor; the workers hold the card (each granted
`gpus_per_worker` GPUs) unless `device="cpu"` or `use_gpu=False` asks for
CPU workers. An error in the loop comes back as `Result.error` with the
metrics reported before it; setup errors (no CUDA, too few GPUs, a bad
config) raise before any worker starts. A Trainer is convertible to a Tune
trainable (`as_trainable`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  TrainingFailedError)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig

logger = logging.getLogger(__name__)


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    best_checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    path: Optional[str] = None


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        if datasets:
            raise NotImplementedError(
                "datasets= needs ray_tpu_torch.data, not ported yet "
                "(ROADMAP M4c)")
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def training_loop(self) -> Result:
        raise NotImplementedError

    def _check_setup(self) -> None:
        """Raise for a setup the run cannot take, before the runtime
        starts or any worker is placed."""

    def fit(self) -> Result:
        import ray_tpu_torch

        self._check_setup()
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        return self.training_loop()

    def as_trainable(self):
        """Wrap as a Tune trainable function (reference: base_trainer.py
        constructs a Tuner internally; we expose the seam directly)."""
        trainer = self

        def trainable(config: Dict[str, Any]):
            merged = trainer._with_config_overrides(config)
            merged._check_setup()
            result = merged.training_loop()
            if result.error:
                raise result.error
            return result.metrics

        trainable.__name__ = type(self).__name__
        return trainable

    def _with_config_overrides(self, config: Dict[str, Any]) -> "BaseTrainer":
        if config and hasattr(self, "train_loop_config"):
            merged = dict(self.train_loop_config or {})
            merged.update(config)
            self.train_loop_config = merged
        return self


class DataParallelTrainer(BaseTrainer):
    """Runs `train_loop_per_worker` on N workers with a backend-made process
    group; results stream through session.report (reference
    data_parallel_trainer.py:385 training_loop). The loop finds its device
    with `session.get_device()`."""

    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 device: Optional[str] = None):
        super().__init__(scaling_config=scaling_config, run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint,
                         datasets=datasets)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._default_backend_config
        self.device = device

    def _worker_device(self) -> str:
        """"cuda" (workers granted GPUs) or "cpu"."""
        device = "cuda" if self.device is None else str(self.device)
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device {device!r}: workers train on 'cuda' "
                             "(each its granted cards) or 'cpu'")
        if not self.scaling_config.use_gpu:
            device = "cpu"
        return device

    def _check_setup(self) -> None:
        sc = self.scaling_config
        if sc.num_workers < 1:
            raise ValueError(f"num_workers={sc.num_workers}: at least 1")
        if self._worker_device() == "cuda":
            if not sc.gpus_per_worker > 0:
                raise ValueError("a worker on the card takes "
                                 "gpus_per_worker > 0; pass device='cpu' "
                                 "or use_gpu=False otherwise")
            from ray_tpu_torch._torch_env import resolve_device

            resolve_device("cuda")  # raises where CUDA is absent

    def training_loop(self) -> Result:
        import ray_tpu_torch

        device = self._worker_device()
        scaling = dataclasses.replace(self.scaling_config,
                                      use_gpu=device == "cuda")
        if scaling.use_gpu:
            want = scaling.num_workers * scaling.gpus_per_worker
            have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if have < want:
                raise RuntimeError(
                    f"{scaling.num_workers} workers x "
                    f"{scaling.gpus_per_worker} GPUs need {want} GPUs; the "
                    f"cluster has {have}")
        backend_config = self.backend_config
        if isinstance(backend_config, TorchConfig) \
                and backend_config.backend is None:
            backend_config = dataclasses.replace(
                backend_config, backend="nccl" if scaling.use_gpu else "gloo")
        run_config = self.run_config
        name = run_config.name or f"{type(self).__name__}_{int(time.time())}"
        exp_dir = run_config.resolved_storage_path()
        if not run_config.name:
            exp_dir = os.path.join(exp_dir, name)
        ckpt_conf = run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(exp_dir, "checkpoints"),
            num_to_keep=ckpt_conf.num_to_keep,
            score_attribute=ckpt_conf.checkpoint_score_attribute,
            score_order=ckpt_conf.checkpoint_score_order,
        )
        executor = BackendExecutor(
            backend_config, scaling,
            max_failures=run_config.failure_config.max_failures)
        executor.start()
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        last_ckpt: Optional[Checkpoint] = None
        error: Optional[BaseException] = None
        try:
            for round_results in executor.run(
                    self.train_loop_per_worker, self.train_loop_config,
                    checkpoint=self.resume_from_checkpoint, device=device,
                    experiment_name=name):
                rank0 = next((r for r in round_results if r["rank"] == 0),
                             round_results[0])
                last_metrics = rank0["metrics"]
                history.append(last_metrics)
                ckpt = rank0.get("checkpoint")
                if ckpt is not None:
                    path = manager.register(ckpt, last_metrics)
                    last_ckpt = Checkpoint.from_directory(path)
                for cb in run_config.callbacks or []:
                    try:
                        cb(last_metrics)
                    except Exception:
                        logger.exception("callback failed")
                if run_config.stop and all(
                        last_metrics.get(k, float("-inf")) >= v
                        for k, v in run_config.stop.items()):
                    logger.info("stop condition met: %s", run_config.stop)
                    break
        except (TrainingFailedError, Exception) as e:  # noqa: BLE001
            error = e
        finally:
            executor.shutdown()
        return Result(metrics=last_metrics, checkpoint=last_ckpt,
                      best_checkpoint=manager.best_checkpoint(),
                      error=error, metrics_history=history, path=exp_dir)

    @classmethod
    def restore(cls, path: str, train_loop_per_worker: Callable, **kwargs):
        """Resume from the latest checkpoint under an experiment dir."""
        ckpt_dir = os.path.join(path, "checkpoints")
        latest = None
        if os.path.isdir(ckpt_dir):
            entries = sorted(os.listdir(ckpt_dir))
            if entries:
                latest = Checkpoint.from_directory(
                    os.path.join(ckpt_dir, entries[-1]))
        return cls(train_loop_per_worker,
                   resume_from_checkpoint=latest, **kwargs)


class TorchTrainer(DataParallelTrainer):
    """The port's training entry point, where the JAX package has
    `JaxTrainer` (reference `TorchTrainer`, `torch/torch_trainer.py:15`):
    the worker group forms a torch.distributed process group (NCCL on the
    card, gloo on the CPU; none for one worker), and the loop syncs
    gradients through `session.sync_gradients`."""

    _default_backend_config = TorchConfig()

    def __init__(self, train_loop_per_worker, *, train_loop_config=None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config=None, run_config=None, datasets=None,
                 resume_from_checkpoint=None, device=None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config, run_config=run_config,
            datasets=datasets, resume_from_checkpoint=resume_from_checkpoint,
            device=device)
