"""ray_tpu_torch.tune: hyperparameter search over trials-as-actors.

The port's copy of `ray_tpu/tune/` (the reference's Ray Tune,
`python/ray/tune/tuner.py:52,315`): `Tuner.fit` expands the param space
into trials, runs them through the TuneController with a scheduler
(ASHA/PBT/FIFO), checkpoints experiment state, and returns a ResultGrid.
Train trainers plug in via `Trainer.as_trainable()`; their workers take
the cards, one trial's at a time per card (`max_concurrent_trials`
defaults to the cluster's cards over a trial's GPUs). Tune itself is host
code and imports no torch.

    from ray_tpu_torch import tune

    def trainable(config):
        for step in range(10):
            tune.report({"loss": config["lr"] * step})

    tuner = tune.Tuner(trainable,
                       param_space={"lr": tune.loguniform(1e-4, 1e-1)},
                       tune_config=tune.TuneConfig(num_samples=8,
                                                   metric="loss", mode="min"))
    results = tuner.fit()
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.session import get_checkpoint, get_session
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    BOHBSearcher,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trial import Trial, TrialStatus
from ray_tpu_torch.tune.tune_controller import TrialStopped, TuneController

# Where experiments go without a RunConfig.storage_path, and where a cloud
# experiment's local working copy lives.
DEFAULT_RESULTS_DIR = os.path.join("~", "ray_tpu_torch_results")
SYNC_CACHE_DIR = os.path.join("~", ".cache", "ray_tpu_torch", "tune_sync")


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None):
    """Report metrics (+ optional checkpoint) from inside a trainable."""
    get_session().report(metrics, checkpoint)


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    # 0: one trial per cluster CPU, capped for GPU trainables at the
    # cluster's cards over a trial's GPUs.
    max_concurrent_trials: int = 0
    scheduler: Optional[TrialScheduler] = None
    # Adaptive search algorithm (e.g. TPESearcher). When set, trials are
    # suggested sequentially as results arrive instead of expanded upfront.
    search_alg: Optional[Searcher] = None
    # Restarts per trial after actor death (from the last checkpoint).
    max_failures: int = 0
    seed: Optional[int] = None


@dataclass
class Result:
    metrics: Dict[str, Any]
    config: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[str]
    trial_id: str
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    # The port adds where the trial ended and when it ran.
    status: str = TrialStatus.PENDING
    start_time: float = 0.0
    runtime_s: float = 0.0


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str], mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._trials)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, i):
        return self.results[i]

    @property
    def results(self) -> List[Result]:
        return [Result(
            metrics=t.last_result, config=t.config,
            checkpoint=Checkpoint.from_directory(t.checkpoint_path)
            if t.checkpoint_path else None,
            error=t.error, trial_id=t.trial_id,
            metrics_history=t.metrics_history, status=t.status,
            start_time=t.start_time, runtime_s=t.runtime_s)
            for t in self._trials]

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._trials if t.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric)")
        scored = [r for r in self.results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self.results:
            row = {"trial_id": r.trial_id, **{f"config/{k}": v
                                              for k, v in r.config.items()}}
            row.update(r.metrics)
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 _trials: Optional[List[Trial]] = None):
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._restored_trials = _trials

    def _experiment_name(self) -> str:
        return self._run_config.name or \
            f"{getattr(self._trainable, '__name__', 'trainable')}_{int(time.time())}"

    def _experiment_dir(self) -> str:
        name = self._experiment_name()
        base = self._run_config.storage_path or os.path.expanduser(
            DEFAULT_RESULTS_DIR)
        from ray_tpu_torch.train import storage

        if storage.is_cloud_uri(base):
            # Cloud storage_path: work locally, sync to the bucket
            # (reference tune/syncer.py; _sync_uri consumed by fit()).
            self._sync_uri = f"{base.rstrip('/')}/{name}"
            return os.path.join(os.path.expanduser(SYNC_CACHE_DIR), name)
        self._sync_uri = None
        return os.path.join(base, name)

    def fit(self) -> ResultGrid:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        tc = self._tune_config
        if self._restored_trials is not None:
            trials = self._restored_trials
        elif tc.search_alg is not None:
            trials = []  # the searcher proposes them as capacity frees
        else:
            configs = BasicVariantGenerator(
                self._param_space, tc.num_samples, tc.seed).generate()
            trials = [Trial(config=c) for c in configs]
        experiment_dir = self._experiment_dir()
        controller = TuneController(
            self._trainable, trials,
            scheduler=tc.scheduler,
            max_concurrent=tc.max_concurrent_trials,
            experiment_dir=experiment_dir,
            stop=self._run_config.stop,
            metric=tc.metric, mode=tc.mode,
            searcher=tc.search_alg,
            num_samples=tc.num_samples if tc.search_alg is not None else None,
            max_failures=tc.max_failures,
            sync_uri=getattr(self, "_sync_uri", None),
        )
        controller.run()
        return ResultGrid(trials, tc.metric, tc.mode)

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its directory — or from
        a bucket URI (the cloud copy written by experiment sync), which is
        downloaded into the local working dir and re-synced on fit()."""
        from ray_tpu_torch.train import storage

        name = os.path.basename(path.rstrip("/"))
        if storage.is_cloud_uri(path):
            local = os.path.join(os.path.expanduser(SYNC_CACHE_DIR), name)
            storage.download_dir(path, local)
            trials = TuneController.load_trials(local)
            # Checkpoint paths were recorded on the machine that synced;
            # remap them into the freshly-downloaded tree.
            for t in trials:
                cp = getattr(t, "checkpoint_path", None)
                if cp:
                    cand = os.path.join(local, t.trial_id,
                                        os.path.basename(cp.rstrip("/")))
                    if os.path.isdir(cand):
                        t.checkpoint_path = cand
            run_config = RunConfig(
                name=name,
                storage_path=path.rstrip("/")[: -len(name) - 1])
        else:
            trials = TuneController.load_trials(path)
            run_config = RunConfig(name=name,
                                   storage_path=os.path.dirname(
                                       path.rstrip("/")))
        return cls(trainable, tune_config=tune_config, run_config=run_config,
                   _trials=trials)

    @staticmethod
    def can_restore(path: str) -> bool:
        from ray_tpu_torch.train import storage

        if storage.is_cloud_uri(path):
            return storage.uri_exists(f"{path.rstrip('/')}/tuner.pkl")
        return os.path.exists(os.path.join(path, "tuner.pkl"))


__all__ = [
    "Tuner", "TuneConfig", "Result", "ResultGrid", "report", "RunConfig",
    "Trial", "TrialStatus", "TrialStopped", "TrialScheduler",
    "FIFOScheduler", "ASHAScheduler", "PopulationBasedTraining",
    "HyperBandScheduler", "MedianStoppingRule",
    "grid_search", "choice", "uniform", "loguniform", "randint", "quniform",
    "sample_from", "get_checkpoint", "Searcher", "TPESearcher",
    "BOHBSearcher", "PB2",
]
