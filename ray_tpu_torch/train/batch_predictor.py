"""BatchPredictor: checkpointed-model inference over a Dataset.

The port's copy of `ray_tpu/train/batch_predictor.py` (the reference's
`python/ray/train/batch_predictor.py`): a `Predictor` class is constructed
from a `Checkpoint` once per scoring actor (via the Data layer's
ActorPoolStrategy map operator), then streams batches through `predict`.
The expensive parts (building the model, loading its state dict onto the
card) happen once per actor, not once per block; batches are the
numpy-dict the Data layer already produces, and `TorchPredictor` returns
float32 numpy (bfloat16 has no numpy dtype).

`TorchPredictor` stands where the JAX package has `JaxPredictor`. It
computes on the card its actor was granted, so the scoring pool asks for
one: `BatchPredictor.predict(ds, ...).with_resources(num_gpus=1)` gives
the pool actors a GPU each and leaves the upstream read tasks on CPU
workers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import numpy as np

from ray_tpu_torch.train.checkpoint import Checkpoint


class Predictor:
    """Base: subclass with from_checkpoint + predict (reference
    `air.predictor.Predictor`)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class TorchPredictor(Predictor):
    """Predictor over a torch module whose weights a state-dict checkpoint
    holds (`Checkpoint.from_state_dict`): emits
    `predictions = model(batch[input_column])` as float32 numpy, plus the
    passthrough of `keep_columns`. Subclasses that score differently
    override `predict`; `inputs(batch, column)` moves a column to the
    model's device."""

    def __init__(self, model: Any, input_column: str = "x",
                 keep_columns: tuple = ()):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.input_column = input_column
        self.keep_columns = tuple(keep_columns)

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        model: Callable[..., Any], input_column: str = "x",
                        keep_columns: tuple = (),
                        device: Optional[str] = None) -> "TorchPredictor":
        """`model` is a picklable spec: a callable that builds the module
        on the device it is passed, e.g. `functools.partial(GPT2,
        GPT2Config.small())`. It runs on `device` when given, else on the
        card this process was granted; a process with no card raises."""
        from ray_tpu_torch._torch_env import granted_device

        dev = granted_device(device, "predictor", "score through "
                             "BatchPredictor.predict(...).with_resources("
                             "num_gpus=1)")
        module = model(device=dev)
        module.load_state_dict(checkpoint.get_state_dict(map_location=dev))
        return cls(module, input_column, keep_columns)

    def inputs(self, batch: Dict[str, np.ndarray], column: str):
        import torch

        # A copy: blocks from the object store are read-only.
        return torch.tensor(batch[column], device=self.device)

    def _passthrough(self, batch: Dict[str, np.ndarray],
                     result: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        for col in self.keep_columns:
            if col in batch:
                result[col] = batch[col]
        return result

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        import torch

        with torch.no_grad():
            out = self.model(self.inputs(batch, self.input_column))
        return self._passthrough(
            batch, {"predictions": out.float().cpu().numpy()})


class _ScoringWorker:
    """Stateful map_batches UDF: one Predictor per pool actor."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], predictor_kwargs: Dict):
        self._predictor = predictor_cls.from_checkpoint(checkpoint,
                                                        **predictor_kwargs)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self._predictor.predict(batch)


class BatchPredictor:
    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(self, dataset, *, batch_size: int = 256,
                max_scoring_workers: int = 2,
                keep_columns: Optional[tuple] = None):
        """Score a Dataset; returns the lazy Dataset of prediction batches."""
        from ray_tpu_torch.data.dataset import ActorPoolStrategy

        kwargs = dict(self._predictor_kwargs)
        if keep_columns is not None:
            kwargs["keep_columns"] = tuple(keep_columns)
        return dataset.map_batches(
            _ScoringWorker,
            batch_size=batch_size,
            compute=ActorPoolStrategy(size=max_scoring_workers),
            fn_constructor_args=(self._checkpoint, self._predictor_cls,
                                 kwargs),
        )
