"""Training configuration dataclasses.

The port's copy of `ray_tpu/train/config.py` (the reference's AIR configs,
`python/ray/air/config.py`: RunConfig/ScalingConfig/FailureConfig/
CheckpointConfig). ScalingConfig speaks GPUs where the JAX package's
speaks TPU chips and pod slices; its mesh is a DeviceMesh over the workers'
ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.parallel.mesh import MeshSpec


@dataclass
class ScalingConfig:
    """How many training workers, with what resources.

    - `num_workers`: training worker processes (actors).
    - `use_gpu` + `gpus_per_worker`: each worker is granted that many GPUs
      and sees exactly those cards (`CUDA_VISIBLE_DEVICES`); with
      `use_gpu=False` the workers run on the CPU and see no card.
    - `placement_strategy`: how the workers' bundles are placed (PACK,
      SPREAD, STRICT_PACK, STRICT_SPREAD).
    - `topology`: a node shape ("h100-16": 2 hosts of 8 H100s, see
      `util/accelerators.py`); when set, it gives one worker per host
      holding all of that host's cards, spread one to a host.
    - `mesh`: logical mesh spec laid over the workers' ranks (one rank a
      worker); the loop reads the built DeviceMesh with
      `session.get_mesh()`.
    """

    num_workers: int = 1
    use_gpu: bool = True
    gpus_per_worker: float = 1
    resources_per_worker: Optional[Dict[str, float]] = None
    cpus_per_worker: float = 1.0
    topology: Optional[str] = None
    mesh: Optional[MeshSpec] = None
    placement_strategy: str = "PACK"

    def __post_init__(self):
        if self.topology:
            from ray_tpu_torch.util.accelerators import (
                shape_gpu_count, shape_host_count)

            self.num_workers = shape_host_count(self.topology)
            self.gpus_per_worker = \
                shape_gpu_count(self.topology) // self.num_workers
            self.use_gpu = True
            self.placement_strategy = "STRICT_SPREAD"

    def worker_resources(self) -> Dict[str, float]:
        out = {"CPU": float(self.cpus_per_worker)}
        if self.use_gpu and self.gpus_per_worker:
            out["GPU"] = float(self.gpus_per_worker)
        if self.resources_per_worker:
            out.update(self.resources_per_worker)
        return out

    def as_placement_group_bundles(self) -> List[Dict[str, float]]:
        return [self.worker_resources() for _ in range(self.num_workers)]

    @property
    def total_workers(self) -> int:
        return self.num_workers


@dataclass
class FailureConfig:
    """Retries for the whole worker group (the reference's Train-era
    semantics: restart the group, not partial-elastic)."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    callbacks: Optional[List[Any]] = None

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_torch_results")
        return os.path.join(base, self.name) if self.name else base
