"""ray_tpu_torch.data.streaming: the sustained-ingest pipeline plane.

Turns the Dataset DAG into a many-GB dataflow engine (the Data tier):

- `budget`  — ByteBudget: one in-flight byte budget per pipeline
  execution, negotiated against object-store capacity, with per-op
  backpressure accounting (`stats()` says where the pipeline is bound).
- `shuffle` — windowed push shuffle: all-to-all whose working set may
  exceed memory degrades into windows that spill through the store's
  disk tier instead of OOMing.
- `lineage` — per-block recipes + recomputed-block accounting: a node
  death mid-pipeline recomputes only the lost partitions (core task
  specs first, data-tier replay as fallback), never a restart.
- `ingest`  — ShardIterator: per-host double-buffered prefetch feeding
  `train.session` with step-stall accounting.

See docs/DATA_STREAMING.md for the window/budget model and contracts.
"""

from ray_tpu_torch.data.streaming.budget import (ByteBudget, current_budget,
                                           pipeline_budget)
from ray_tpu_torch.data.streaming.ingest import ShardIterator, iter_shards
from ray_tpu_torch.data.streaming.lineage import BlockLineage, core_reconstructions
from ray_tpu_torch.data.streaming.shuffle import iter_shuffled_refs

__all__ = [
    "ByteBudget", "BlockLineage", "ShardIterator", "core_reconstructions",
    "current_budget", "iter_shards", "iter_shuffled_refs",
    "pipeline_budget",
]
