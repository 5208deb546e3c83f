"""DataContext: execution knobs (reference `python/ray/data/context.py:134`)."""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional


@dataclass
class DataContext:
    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    # Streaming executor backpressure: max concurrent tasks per operator.
    # (Buffered OUTPUT is bounded in bytes, not blocks — see
    # `inflight_budget_bytes` below and ray_tpu_torch/data/streaming/budget.py.)
    max_tasks_in_flight_per_op: int = 8
    # Legacy secondary cap on buffered blocks per op; the byte budget is
    # the primary backpressure signal since the streaming ingest plane.
    max_buffered_blocks_per_op: int = 16
    read_parallelism: int = -1  # -1 = auto (min(files, 2*CPUs, 192))
    eager_free: bool = True
    # Per-operator wall/rows stats (ds.stats()); one fire-and-forget
    # actor call per executed block when enabled.
    enable_stats: bool = True

    # Byte-budget knobs are PROMOTED into core/config.py (env-overridable
    # `RAY_TPU_DATA_*`, refresh()-aware memoized reads): `None` here means
    # "consult GLOBAL_CONFIG on every resolve", so an env var set before
    # ray_tpu_torch.init() takes effect without touching the context; assigning
    # a value is an explicit per-process override that always wins.
    inflight_budget_bytes: Optional[int] = None
    prefetch_shards: Optional[int] = None
    locality_routing: Optional[bool] = None
    sort_sample_rows: Optional[int] = None
    broadcast_join_bytes: Optional[int] = None
    # Tenant the data plane charges this process's executions to (the
    # per-tenant budget ledger in streaming/budget.py). None resolves to
    # the submitting job id (RAY_TPU_TORCH_JOB_ID) and finally "default".
    tenant: Optional[str] = None

    def resolved_inflight_budget_bytes(self) -> int:
        """0 = negotiate against the object store (ByteBudget.negotiated)."""
        if self.inflight_budget_bytes is not None:
            return self.inflight_budget_bytes
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG.data_inflight_budget_bytes

    def resolved_prefetch_shards(self) -> int:
        if self.prefetch_shards is not None:
            return self.prefetch_shards
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG.data_prefetch_shards

    def resolved_locality_routing(self) -> bool:
        if self.locality_routing is not None:
            return self.locality_routing
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG.data_locality_routing

    def resolved_sort_sample_rows(self) -> int:
        if self.sort_sample_rows is not None:
            return self.sort_sample_rows
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG.query_sort_sample_rows

    def resolved_broadcast_join_bytes(self) -> int:
        if self.broadcast_join_bytes is not None:
            return self.broadcast_join_bytes
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG.query_broadcast_join_bytes

    def resolved_tenant(self) -> str:
        if self.tenant:
            return self.tenant
        import os

        return os.environ.get("RAY_TPU_TORCH_JOB_ID") or "default"

    _instance: Optional["DataContext"] = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = DataContext()
            return cls._instance
