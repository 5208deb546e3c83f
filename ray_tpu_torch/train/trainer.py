"""Trainers: BaseTrainer -> DataParallelTrainer -> TorchTrainer.

Counterpart of `ray_tpu/train/trainer.py`, where `JaxTrainer` runs the loop
in worker actors over a mesh. In this slice `fit()` runs its one worker in
the calling process, on the card unless `device="cpu"` is asked for; the
worker group of actors is a later slice (ROADMAP, queue 1).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ray_tpu_torch._torch_env import resolve_device
from ray_tpu_torch.train import session
from ray_tpu_torch.train.config import RunConfig, ScalingConfig


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    path: Optional[str] = None


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()

    def training_loop(self) -> Result:
        raise NotImplementedError

    def fit(self) -> Result:
        return self.training_loop()


class DataParallelTrainer(BaseTrainer):
    """Runs `train_loop_per_worker(train_loop_config)`; the loop reports
    through `session.report` and finds its device with
    `session.get_device()`. Errors in the loop propagate out of `fit()`."""

    def __init__(self, train_loop_per_worker: Callable[[Dict[str, Any]], Any],
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(scaling_config=scaling_config, run_config=run_config)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.device = device

    def training_loop(self) -> Result:
        scaling = self.scaling_config
        if scaling.num_workers != 1:
            raise NotImplementedError(
                f"num_workers={scaling.num_workers}: more than one worker "
                "needs the actor-runtime worker group (ROADMAP, queue 1), "
                "not yet ported")
        device = resolve_device(self.device)
        if device.type == "cuda" and not (scaling.use_gpu
                                          and scaling.gpus_per_worker == 1):
            raise ValueError("a worker on the card takes use_gpu=True and "
                             "gpus_per_worker=1; pass device='cpu' otherwise")
        run = self.run_config
        name = run.name or f"{type(self).__name__}_{int(time.time())}"
        sess = session._TrainSession(
            context=session.TrainContext(experiment_name=name), device=device)
        session.init_session(sess)
        try:
            self.train_loop_per_worker(self.train_loop_config)
        finally:
            session.shutdown_session()
        history = sess.reports
        return Result(metrics=history[-1] if history else {},
                      metrics_history=history,
                      path=os.path.join(run.storage_path, name)
                      if run.storage_path else None)


class TorchTrainer(DataParallelTrainer):
    """The counterpart of `JaxTrainer`: the port's training entry point."""
