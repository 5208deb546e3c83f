"""Distributed query tier: width-scale exchange operators over the
streaming plane.

Three operators — range-partitioned sort, hash-aggregate groupby, and a
broadcast/shuffle join — run as budget-bounded dataflows through the
windowed-shuffle machinery (ray_tpu_torch/data/streaming/shuffle.py):
rows never transit the driver (the sort's boundary sample is the one
bounded exception), intermediates seal into the spillable store, every
partition carries a `BlockLineage` recipe for bounded mid-shuffle
recovery, and per-op backpressure lands in `ds.stats()`. Consumption is
locality-routed (query/locality.py): reduce tasks NodeAffinity-place on
bucket holders, and same-host handoff rides the raylet's sealed-segment
shm attach instead of a socket copy.

See docs/DATA_QUERY.md for operator semantics and knobs.
"""

from ray_tpu_torch.data.query.aggregate import (
    AggregateFn,
    Count,
    Max,
    Mean,
    Min,
    Sum,
)
from ray_tpu_torch.data.query.join import join_datasets
from ray_tpu_torch.data.query.sort import sort_dataset

__all__ = [
    "AggregateFn",
    "Count",
    "Sum",
    "Min",
    "Max",
    "Mean",
    "join_datasets",
    "sort_dataset",
]
