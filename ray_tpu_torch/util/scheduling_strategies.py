"""Scheduling strategies (reference: `python/ray/util/scheduling_strategies.py`)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.common import SchedulingStrategy


class DefaultSchedulingStrategy(SchedulingStrategy):
    """Hybrid policy: pack locally under threshold, then best remote node."""


class SpreadSchedulingStrategy(SchedulingStrategy):
    """Round-robin among feasible nodes (the "SPREAD" strategy)."""


class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks
