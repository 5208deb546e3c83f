"""Framework-integration trainers: HF Transformers, XGBoost, LightGBM.

Equivalent of the reference's wrapper-trainer families
(`python/ray/train/huggingface/transformers/`, `train/xgboost/`,
`train/lightgbm/`): thin, honest adapters that run the external
framework's training loop inside this framework's worker group with
metrics/checkpoints flowing through `train.session.report`.

The port's counterpart of `ray_tpu/train/integrations.py`, on the port's
`DataParallelTrainer` and `TorchConfig`. As every trainer of the port, the
workers hold a card each unless `device="cpu"` is passed (the loop reads
`session.get_device()`). None of the three libraries is a dependency: each
trainer checks at construction that its library is installed and raises
an ImportError naming it otherwise.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.backend import TorchConfig
from ray_tpu_torch.train.trainer import DataParallelTrainer


def _require(module: str, trainer: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{trainer} requires the {module!r} package, which is not "
            f"installed in this environment") from e


class TransformersTrainer(DataParallelTrainer):
    """Run a Hugging Face `transformers` training loop on the worker
    group (reference `TransformersTrainer` /
    `huggingface/transformers/_transformers_utils.py`).

    The per-worker loop receives the config and builds its own
    `transformers.Trainer` (or manual loop); under num_workers > 1 the
    torch process group is formed (gloo on CPU hosts) before the loop
    runs (NCCL on the cards, gloo on the CPU), so `transformers`' DDP
    integration sees a ready `torch.distributed`. Use `prepare_trainer` to wire HF's reporting
    into this framework's session.
    """

    def __init__(self, train_loop_per_worker, *, train_loop_config=None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config=None, run_config=None, datasets=None,
                 resume_from_checkpoint=None, device=None):
        _require("transformers", "TransformersTrainer")
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config, run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint, device=device)


def prepare_trainer(hf_trainer):
    """Attach a callback to a `transformers.Trainer` that forwards its
    logged metrics to `train.session.report` (reference
    `RayTrainReportCallback`), so Tune/Train see HF progress natively."""
    transformers = _require("transformers", "prepare_trainer")

    from ray_tpu_torch.train import session

    class _ReportCallback(transformers.TrainerCallback):
        def on_log(self, args, state, control, logs=None, **kwargs):
            if logs:
                metrics = {k: v for k, v in logs.items()
                           if isinstance(v, (int, float))}
                metrics.setdefault("step", state.global_step)
                session.report(metrics)

    hf_trainer.add_callback(_ReportCallback())
    return hf_trainer


def _gbdt_training_matrix(label_column: str):
    """Worker side: the 'train' dataset shard as (X, y) arrays."""
    import numpy as np

    from ray_tpu_torch.train import session

    ds = session.get_dataset_shard("train")
    batches = list(ds.iter_batches()) if ds is not None else []
    if not batches:
        raise ValueError(
            "GBDT trainers require a non-empty 'train' dataset "
            "(datasets={'train': ds})")
    X = np.concatenate([
        np.column_stack([v for k, v in b.items() if k != label_column])
        for b in batches])
    y = np.concatenate([b[label_column] for b in batches])
    return X, y


def _xgboost_loop(config):
    import xgboost as xgb

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import Checkpoint

    X, y = _gbdt_training_matrix(config["label_column"])
    dtrain = xgb.DMatrix(X, label=y)
    results: Dict[str, Any] = {}
    booster = xgb.train(config["params"], dtrain,
                        num_boost_round=config["num_boost_round"],
                        evals=[(dtrain, "train")], evals_result=results)
    final = {k: float(v[-1]) for k, v in results.get("train", {}).items()}
    session.report({"boost_rounds": config["num_boost_round"], **final},
                   checkpoint=Checkpoint.from_dict(
                       {"model": booster.save_raw()}))


def _lightgbm_loop(config):
    import lightgbm as lgb

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import Checkpoint

    X, y = _gbdt_training_matrix(config["label_column"])
    booster = lgb.train(config["params"], lgb.Dataset(X, label=y),
                        num_boost_round=config["num_boost_round"])
    session.report({"boost_rounds": config["num_boost_round"]},
                   checkpoint=Checkpoint.from_dict(
                       {"model": booster.model_to_string()}))


class _GBDTTrainer(DataParallelTrainer):
    """Shared shape for the boosting trainers: single worker (the GBDT
    libraries multithread internally; the reference distributes via
    xgboost-ray, which has no equivalent here). The train loop is a
    module-level function and every knob rides train_loop_config, so
    workers never receive a pickled trainer object (with the full
    driver-side datasets inside)."""

    _module = ""
    _name = ""
    _loop_fn: Callable = None

    def __init__(self, *, params: Dict[str, Any],
                 label_column: str = "label",
                 num_boost_round: int = 10,
                 datasets=None, scaling_config=None, run_config=None,
                 resume_from_checkpoint=None, device=None):
        _require(self._module, self._name)
        if not datasets or "train" not in datasets:
            raise ValueError(
                f"{self._name} requires datasets={{'train': ...}}")
        super().__init__(
            type(self)._loop_fn,
            train_loop_config={"params": dict(params),
                               "label_column": label_column,
                               "num_boost_round": num_boost_round},
            backend_config=None,
            scaling_config=scaling_config, run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint, device=device)


class XGBoostTrainer(_GBDTTrainer):
    """Reference `train/xgboost/xgboost_trainer.py`: boosts on the
    worker from the 'train' dataset shard, reporting eval metrics per
    round through the session."""

    _module = "xgboost"
    _name = "XGBoostTrainer"
    _loop_fn = staticmethod(_xgboost_loop)


class LightGBMTrainer(_GBDTTrainer):
    """Reference `train/lightgbm/lightgbm_trainer.py`."""

    _module = "lightgbm"
    _name = "LightGBMTrainer"
    _loop_fn = staticmethod(_lightgbm_loop)
