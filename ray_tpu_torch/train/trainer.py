"""Trainers: BaseTrainer -> DataParallelTrainer -> TorchTrainer.

The port's copy of `ray_tpu/train/trainer.py` (the reference's
`BaseTrainer.fit`, `python/ray/train/base_trainer.py:555`, and
`DataParallelTrainer`, `data_parallel_trainer.py:56`). `fit()` starts the
runtime when it is not up and runs the loop in worker actors through the
BackendExecutor; the workers hold the card (each granted
`gpus_per_worker` GPUs) unless `device="cpu"` or `use_gpu=False` asks for
CPU workers. An error in the loop comes back as `Result.error` with the
metrics reported before it; setup errors (a cluster with too few GPUs, a
bad config) raise before any worker starts. Whether a process can train on
its card is checked in the worker the runtime granted it, not in the
process that calls `fit()`. A Trainer is convertible to a Tune trainable
(`as_trainable`), whose workers' reports reach the trial as they come.
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
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

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
        constructs a Tuner internally; we expose the seam directly).

        In a Tune trial, each round of the workers' reports reaches the
        trial as it comes (`tune.report` of rank 0's metrics and
        checkpoint), so a scheduler can stop the run between steps; the
        trainable then returns nothing more. Called outside a trial, it
        returns the last metrics. `tune_gpus` is the GPUs a run holds,
        which caps how many trials Tune runs at once by default."""
        from ray_tpu_torch.train import session

        trainer = self

        def trainable(config: Dict[str, Any]):
            merged = trainer._with_config_overrides(config)
            merged._check_setup()
            trial = session._session  # a Tune trial's session, or None

            def on_report(metrics, checkpoint, workers):
                # The trial's controller kills these workers should the
                # trial actor die before its trainer shut them down.
                trial.trainer_workers = workers
                session.report(metrics, checkpoint=checkpoint)

            result = merged.training_loop(
                on_report=on_report if trial is not None else None)
            if result.error:
                raise result.error
            return None if trial is not None else result.metrics

        trainable.__name__ = type(self).__name__
        trainable.tune_gpus = self._run_gpus()
        return trainable

    def _run_gpus(self) -> float:
        """The GPUs one run of this trainer holds."""
        return 0.0

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
        if self._worker_device() == "cuda" and not sc.gpus_per_worker > 0:
            raise ValueError("a worker on the card takes gpus_per_worker > "
                             "0; pass device='cpu' or use_gpu=False "
                             "otherwise")

    def _run_gpus(self) -> float:
        sc = self.scaling_config
        if self._worker_device() != "cuda":
            return 0.0
        return sc.num_workers * sc.gpus_per_worker

    def _split_datasets(self) -> Optional[List[Dict[str, Any]]]:
        """Per-worker dataset shards: ray_tpu_torch.data Datasets are
        streaming_split and wrapped in prefetching ShardIterators (each
        worker's prefetch thread pulls the next blocks onto its host ahead
        of the step, with step-stall accounting — see
        ray_tpu_torch/data/streaming/ingest.py); plain lists are
        round-robin sharded; other values are passed through whole."""
        if not self.datasets:
            return None
        n = self.scaling_config.num_workers
        per_worker: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            splits = None
            if hasattr(ds, "streaming_split"):
                from ray_tpu_torch.data.streaming.ingest import ShardIterator

                splits = [ShardIterator(s) for s in ds.streaming_split(n)]
            elif isinstance(ds, (list, tuple)):
                splits = [list(ds[i::n]) for i in range(n)]
            if splits is None:
                for i in range(n):
                    per_worker[i][name] = ds
            else:
                for i in range(n):
                    per_worker[i][name] = splits[i]
        return per_worker

    def training_loop(self, on_report: Optional[Callable] = None
                      ) -> Result:
        """Run the loop in the worker group. `on_report(metrics,
        checkpoint, workers)` gets each round's rank-0 report as it comes,
        with the actor ids of the workers that run the loop (a Tune
        trial's `report`); an exception it raises ends the run, its
        workers shut down."""
        import ray_tpu_torch

        device = self._worker_device()
        scaling = dataclasses.replace(self.scaling_config,
                                      use_gpu=device == "cuda")
        if scaling.use_gpu:
            want = self._run_gpus()
            have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if have < want:
                raise RuntimeError(
                    f"{scaling.num_workers} workers x "
                    f"{scaling.gpus_per_worker} GPUs need {want} GPUs; the "
                    f"cluster advertises {have}, so no worker can be "
                    "granted a CUDA card: pass device='cpu' or "
                    "use_gpu=False to train on the CPU")
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
        try:
            executor.start()
        except BaseException:
            executor.shutdown()  # no worker of a failed start lives on
            raise
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        last_ckpt: Optional[Checkpoint] = None
        error: Optional[BaseException] = None
        datasets_per_worker = None
        try:
            # Split once per fit(): a gang restart hands the new workers
            # the same shards, which resume the split's epoch.
            datasets_per_worker = self._split_datasets()
            for round_results in executor.run(
                    self.train_loop_per_worker, self.train_loop_config,
                    checkpoint=self.resume_from_checkpoint, device=device,
                    datasets_per_worker=datasets_per_worker,
                    experiment_name=name):
                rank0 = next((r for r in round_results if r["rank"] == 0),
                             round_results[0])
                last_metrics = rank0["metrics"]
                history.append(last_metrics)
                ckpt = rank0.get("checkpoint")
                if ckpt is not None:
                    path = manager.register(ckpt, last_metrics)
                    last_ckpt = Checkpoint.from_directory(path)
                if on_report is not None:
                    on_report(last_metrics,
                              last_ckpt if ckpt is not None else None,
                              executor.worker_ids())
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
            _close_shards(datasets_per_worker)
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


def _close_shards(datasets_per_worker: Optional[List[Dict[str, Any]]]):
    """Release each split's shared execution when the run ends: a loop
    that stops mid-epoch (N steps) leaves the split's coordinator holding
    the pipeline's in-flight blocks in the object store."""
    for shards in datasets_per_worker or ():
        for shard in shards.values():
            close = getattr(shard, "close", None)
            if close is not None:
                close()


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
