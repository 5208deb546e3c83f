"""Offline RL IO: persist sample batches through the Data layer, train
policies from them without an environment.

The port of `ray_tpu/rllib/offline.py` (the reference's `rllib/offline/`,
JsonWriter/JsonReader and `dataset_reader.py` reading experiences through
Ray Data, and the BC algorithm `rllib/algorithms/bc/`). Experiences
round-trip as row dicts so they compose with every Data transform
(filter/map_batches/split) before reaching a learner, whose update runs on
the card unless `BCConfig.device` asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.rl_module import SpecDict, build_module

_FIELDS = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.DONES, sb.LOGP)


def batch_to_rows(batch: Dict[str, np.ndarray],
                  fields: Sequence[str] = _FIELDS) -> List[Dict[str, Any]]:
    """Columnar SampleBatch -> row dicts (json/parquet friendly)."""
    present = [f for f in fields if f in batch]
    n = len(batch[present[0]])
    rows = []
    for i in range(n):
        row = {}
        for f in present:
            v = batch[f][i]
            row[f] = v.tolist() if isinstance(v, np.ndarray) else \
                (v.item() if hasattr(v, "item") else v)
        rows.append(row)
    return rows


def rows_to_batch(rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Row dicts -> columnar SampleBatch."""
    if not rows:
        return {}
    out = {}
    for k in rows[0]:
        col = [r[k] for r in rows]
        arr = np.asarray(col)
        if k in (sb.ACTIONS,):
            arr = arr.astype(np.int64)
        elif k in (sb.REWARDS, sb.LOGP):
            arr = arr.astype(np.float32)
        elif k == sb.DONES:
            arr = arr.astype(bool)
        elif arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        out[k] = arr
    return out


def write_batches(path: str, batches: List[Dict[str, np.ndarray]],
                  format: str = "json") -> List[str]:
    """Persist sample batches under `path` via the Data layer."""
    import ray_tpu_torch.data as rdata

    rows: List[Dict[str, Any]] = []
    for b in batches:
        rows.extend(batch_to_rows(b))
    ds = rdata.from_items(rows)
    os.makedirs(path, exist_ok=True)
    if format == "parquet":
        return ds.write_parquet(path)
    return ds.write_json(path)


def read_batches(path: str, format: str = "json"):
    """Load an experience dataset written by `write_batches` as a
    `ray_tpu_torch.data.Dataset` of rows (compose transforms freely). Uses
    the standard read_* path expansion, filtered to this format's extension
    so a directory holding both formats (or sidecar files) reads cleanly."""
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.data.datasource import expand_paths

    ext = ".parquet" if format == "parquet" else ".json"
    paths = [p for p in expand_paths(path) if p.endswith(ext)] \
        if os.path.isdir(path) else path
    if format == "parquet":
        return rdata.read_parquet(paths)
    return rdata.read_json(paths)


def iter_learner_batches(ds, batch_size: int = 256,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled columnar minibatches from an experience Dataset. The ragged
    tail (and a dataset smaller than batch_size) is yielded too — silently
    training on nothing would be worse than one odd-shaped batch."""
    rows = ds.take_all()
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(rows))
    for s in range(0, len(rows), batch_size):
        chunk = [rows[i] for i in order[s:s + batch_size]]
        if chunk:
            yield rows_to_batch(chunk)


# --------------------------------------------------------------------------- #
# BC: the smallest offline algorithm (reference rllib/algorithms/bc)
# --------------------------------------------------------------------------- #


@dataclass
class BCConfig:
    obs_dim: int = 0
    n_actions: int = 0
    obs_shape: tuple = ()
    hidden: tuple = (64, 64)
    lr: float = 1e-3
    grad_clip: float = 10.0
    seed: int = 0
    # The learner's device: the card unless "cpu" is asked for.
    device: Optional[str] = "cuda"


class BCLearner(Learner):
    """Negative log-likelihood of the logged actions."""

    def compute_loss(self, net, batch):
        out = self.module.forward_train(net, batch)
        loss = -torch.mean(out["logp"])
        return loss, {"nll": loss, "entropy": torch.mean(out["entropy"])}


class BC:
    """Behavior cloning from an experience dataset (no env needed)."""

    def __init__(self, config: BCConfig):
        self.config = config
        spec = SpecDict(config.obs_dim, config.n_actions,
                        tuple(config.obs_shape))
        self.module = build_module(spec, hidden=config.hidden)
        self.learner = BCLearner(self.module, config, seed=config.seed)
        self.iteration = 0

    def train_on_dataset(self, ds, *, epochs: int = 1,
                         batch_size: int = 256) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        for ep in range(epochs):
            for batch in iter_learner_batches(ds, batch_size,
                                              seed=self.config.seed + ep):
                metrics = self.learner.update(
                    {sb.OBS: batch[sb.OBS], sb.ACTIONS: batch[sb.ACTIONS]})
            self.iteration += 1
        return metrics

    def get_policy_weights(self):
        return self.learner.get_weights()
