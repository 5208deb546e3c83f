"""Per-worker training session: report(), the context, the device.

Counterpart of `ray_tpu/train/session.py`; `get_device()` stands where the
JAX package's `get_mesh()` does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    experiment_name: str = ""


@dataclass
class _TrainSession:
    context: TrainContext
    device: torch.device
    reports: List[Dict[str, Any]] = field(default_factory=list)

    def report(self, metrics: Dict[str, Any]):
        self.reports.append(dict(metrics))


_session: Optional[_TrainSession] = None


def init_session(session: _TrainSession):
    global _session
    _session = session


def shutdown_session():
    global _session
    _session = None


def get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active: session APIs are only usable inside "
            "a train_loop_per_worker launched by a Trainer.")
    return _session


def report(metrics: Dict[str, Any]):
    get_session().report(metrics)


def get_context() -> TrainContext:
    return get_session().context


def get_device() -> torch.device:
    """The device this worker trains on."""
    return get_session().device
