"""Distributed sort: sample-based range partitioning over the windowed
shuffle.

Plan (reference `push_based_shuffle.py` / the classic TeraSort shape):

1. **Sample.** One remote task per parent block draws at most
   ceil(sample_rows / n_blocks) keys (seeded, without replacement) and
   ships ONLY the keys back. The driver never sees rows — its resident
   footprint is bounded by `query_sort_sample_rows` keys, an invariant
   `last_sort_stats["driver_sample_bytes"]` makes assertable.
2. **Range scatter.** Sorted samples cut into n_parts-1 boundary keys; a
   `_RangePartitioner` (picklable, ships in the map closure) assigns
   row -> partition by bisect_right, so EQUAL KEYS NEVER SPLIT across
   partitions. The exchange itself is `iter_shuffled_refs(mode="keyed")`
   — windowed, budget-bounded, spillable, lineage-recorded: the sort
   inherits every recovery and backpressure property of the shuffle.
3. **Local sort.** Each partition stable-sorts locally (fused transform,
   never driver-side). Range partitioning preserves each block's
   original row order within a partition (buckets concat in block
   order), so stable local sort == exact stable global sort: output is
   row-identical to driver-side ``sorted(rows, key=...)`` REGARDLESS of
   which keys the sample happened to draw. Samples only steer balance,
   never correctness.

Descending flips the partition index (n_parts-1-idx) and runs a stable
descending local sort, preserving original order among equal keys — the
same contract as ``sorted(..., reverse=True)``.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

_KEY_ERROR = ("sort() on record rows needs a key: pass a column name "
              "(sort(key='col')) or a callable")


class _RangePartitioner:
    """row -> partition index against sampled boundaries. The columnar
    `assign_block` fast path uses np.searchsorted(side="right"), exactly
    bisect_right's semantics, so bucket membership is representation-
    independent."""

    def __init__(self, boundaries: List[Any], key, descending: bool,
                 n_parts: int):
        self.boundaries = boundaries
        self.key = key
        self.descending = descending
        self.n_parts = n_parts

    def _key_of(self, row):
        if self.key is None:
            return row
        if callable(self.key):
            return self.key(row)
        return row[self.key]

    def __call__(self, row) -> int:
        idx = bisect.bisect_right(self.boundaries, self._key_of(row))
        return self.n_parts - 1 - idx if self.descending else idx

    def assign_block(self, block) -> Optional[np.ndarray]:
        """Vectorized assignment for a dict-of-arrays block; None defers
        to the row path (callable key, object dtype, odd comparisons)."""
        if not isinstance(self.key, str) or self.key not in block:
            return None
        col = np.asarray(block[self.key])
        if col.dtype == object:
            return None
        try:
            bounds = np.asarray(self.boundaries)
            if bounds.dtype == object:
                return None
            idx = np.searchsorted(bounds, col, side="right")
        except Exception:  # noqa: BLE001 — incomparable dtypes -> row path
            return None
        if self.descending:
            idx = self.n_parts - 1 - idx
        return idx


def _sample_block_keys(block, k: int, key, seed: int, salt: int):
    """Remote sample task: at most k keys from one block, seeded without
    replacement. Returns plain Python scalars (keys only — the driver-
    resident bound is what makes the sort 'distributed' in the first
    place)."""
    from ray_tpu_torch.data.block import BlockAccessor, _is_batch_dict

    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return []
    rng = np.random.default_rng(seed * 99991 + salt)
    take = min(max(k, 1), n)
    idxs = sorted(rng.choice(n, size=take, replace=False).tolist())
    if _is_batch_dict(block) and isinstance(key, str):
        col = np.asarray(block[key])
        return np.asarray(col)[idxs].tolist()
    rows = list(acc.rows())
    out = []
    for i in idxs:
        row = rows[i]
        if key is None:
            if isinstance(row, dict):
                raise ValueError(_KEY_ERROR)
            out.append(row)
        elif callable(key):
            out.append(key(row))
        else:
            out.append(row[key])
    return [v.item() if hasattr(v, "item") else v for v in out]


def _stable_desc_order(col: np.ndarray) -> np.ndarray:
    """Permutation sorting `col` descending with ties in ORIGINAL order
    (== sorted(reverse=True)): stable-ascending argsort of the reversed
    array, mapped back and reversed."""
    n = len(col)
    return (n - 1 - np.argsort(col[::-1], kind="stable"))[::-1]


def make_local_sort_transform(key, descending: bool,
                              lenient: bool = False) -> Callable:
    """Fused per-partition transform: stable local sort. `lenient`
    swallows TypeError from unorderable keys and returns the block
    as-is (groupby's best-effort ordering contract)."""

    def _row_key(row):
        if key is None:
            return row
        if callable(key):
            return key(row)
        return row[key]

    def transform(block):
        from ray_tpu_torch.data.block import BlockAccessor, _is_batch_dict

        if _is_batch_dict(block) and isinstance(key, str) and block:
            col = np.asarray(block[key])
            if col.dtype != object:
                order = (_stable_desc_order(col) if descending
                         else np.argsort(col, kind="stable"))
                return {k: np.asarray(v)[order] for k, v in block.items()}
        rows = list(BlockAccessor(block).rows())
        try:
            rows.sort(key=_row_key, reverse=descending)
        except TypeError:
            if not lenient:
                raise
        return rows

    transform._op_name = "Sort"
    return transform


def compute_boundaries(samples: List[Any], n_parts: int) -> List[Any]:
    """n_parts-1 ascending cut points from sorted samples (equal-width
    quantiles of the sample). Fewer samples than partitions just means
    duplicate boundaries => some empty partitions, never wrong rows."""
    if not samples or n_parts <= 1:
        return []
    samples = sorted(samples)
    return [samples[(i * len(samples)) // n_parts]
            for i in range(1, n_parts)]


def sort_dataset(parent, key: Union[None, str, Callable] = None,
                 descending: bool = False, *, lenient: bool = False):
    """Range-partitioned distributed sort of `parent`; returns a lazy
    Dataset whose iteration runs sample -> keyed exchange -> local sort.
    `lenient`: unorderable keys degrade to unsorted output instead of
    raising (the groupby result-ordering contract)."""
    from ray_tpu_torch.data.dataset import _RangeSortDataset

    return _RangeSortDataset(parent, key, descending, lenient)
