"""Training configuration dataclasses.

Counterpart of `ray_tpu/train/config.py`: ScalingConfig speaks GPUs where
the JAX package's speaks TPU chips and meshes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ScalingConfig:
    """How many training workers, each with how many GPUs.

    This slice runs one worker on one card; more workers need the actor
    runtime (ROADMAP, queue 1)."""

    num_workers: int = 1
    use_gpu: bool = True
    gpus_per_worker: int = 1


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
