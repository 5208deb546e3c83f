"""Hash-aggregate groupby: partial pre-aggregation, hash scatter, merge.

A driver-side GroupedData pulled EVERY block to the driver and merged
partials in-process — the exact driver-materialization this tier exists
to kill (the pattern raylint's RL019 flags). The distributed plan:

1. **Partial aggregate** (fused map): each block collapses to at most
   one partial row per distinct key — ``{"k": key, "s": [state, ...]}``
   — before anything moves. Columnar dict-of-arrays blocks take a
   vectorized path (np.unique + bincount/reduceat) so multi-GB blocks
   never iterate rows in Python.
2. **Hash scatter**: partial rows exchange through the windowed shuffle
   (mode="hash" on "k"), so every key's partials co-locate on one
   reducer. Budget, spill, lineage, and backpressure all inherit from
   the shuffle — a groupby whose key cardinality exceeds memory spills,
   it does not OOM.
3. **Merge + finalize** (fused on reduce outputs): states merge per key
   and finalize into result rows named by each AggregateFn ("count()",
   "sum(v)", ...).
4. **Global order**: results range-sort by key through the distributed
   sort (lenient — unorderable mixed keys degrade to unsorted, matching
   the seed contract's TypeError tolerance).

States are tiny scalars/tuples, so stages 2-4 move kilobytes even when
stage 1 read gigabytes — the whole point of pre-aggregation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class AggregateFn:
    """Composable aggregation: init() -> state, accumulate(state, row),
    merge(state, state), finalize(state) -> value under `name` in the
    result row. `vectorize(block, inv, n_groups)` optionally returns a
    per-group state list for a columnar block (None = fall back to the
    row path for that block)."""

    def __init__(self, init: Callable[[], Any],
                 accumulate: Callable[[Any, Any], Any],
                 merge: Callable[[Any, Any], Any],
                 finalize: Optional[Callable[[Any], Any]] = None,
                 name: str = "agg()",
                 vectorize: Optional[Callable] = None):
        self.init = init
        self.accumulate = accumulate
        self.merge = merge
        self.finalize = finalize or (lambda s: s)
        self.name = name
        self.vectorize = vectorize


def _group_reduce(vals: np.ndarray, inv: np.ndarray, n_groups: int,
                  ufunc) -> Optional[list]:
    """Per-group ufunc.reduceat over values stable-sorted by group id;
    keeps the column dtype (int sums stay ints). None for object/empty
    groups edge cases the caller should row-path instead."""
    if vals.dtype == object:
        return None
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(n_groups))
    return [v.item() for v in ufunc.reduceat(vals[order], starts)]


def _col(block, on) -> Optional[np.ndarray]:
    if on not in block:
        return None
    vals = np.asarray(block[on])
    return None if vals.dtype == object else vals


def Count() -> AggregateFn:
    return AggregateFn(
        lambda: 0, lambda s, r: s + 1, lambda a, b: a + b,
        name="count()",
        vectorize=lambda block, inv, n:
            np.bincount(inv, minlength=n).tolist())


def Sum(on: str) -> AggregateFn:
    def acc(s, r):
        v = r.get(on) if isinstance(r, dict) else r
        if v is None:
            return s
        return v if s is None else s + v

    def merge(a, b):
        if a is None:
            return b
        return a if b is None else a + b

    def vec(block, inv, n):
        vals = _col(block, on)
        return None if vals is None else _group_reduce(vals, inv, n, np.add)

    return AggregateFn(lambda: None, acc, merge, name=f"sum({on})",
                       vectorize=vec)


def Min(on: str) -> AggregateFn:
    def acc(s, r):
        v = r.get(on) if isinstance(r, dict) else r
        if v is None:
            return s
        return v if s is None else min(s, v)

    def merge(a, b):
        if a is None:
            return b
        return a if b is None else min(a, b)

    def vec(block, inv, n):
        vals = _col(block, on)
        return None if vals is None else _group_reduce(vals, inv, n,
                                                       np.minimum)

    return AggregateFn(lambda: None, acc, merge, name=f"min({on})",
                       vectorize=vec)


def Max(on: str) -> AggregateFn:
    def acc(s, r):
        v = r.get(on) if isinstance(r, dict) else r
        if v is None:
            return s
        return v if s is None else max(s, v)

    def merge(a, b):
        if a is None:
            return b
        return a if b is None else max(a, b)

    def vec(block, inv, n):
        vals = _col(block, on)
        return None if vals is None else _group_reduce(vals, inv, n,
                                                       np.maximum)

    return AggregateFn(lambda: None, acc, merge, name=f"max({on})",
                       vectorize=vec)


def Mean(on: str) -> AggregateFn:
    """State (total, n) counts only non-None values — mean of all-None
    is None, matching the seed semantics."""

    def acc(s, r):
        v = r.get(on) if isinstance(r, dict) else r
        if v is None:
            return s
        return (s[0] + v, s[1] + 1)

    def merge(a, b):
        return (a[0] + b[0], a[1] + b[1])

    def fin(s):
        return s[0] / s[1] if s[1] else None

    def vec(block, inv, n):
        vals = _col(block, on)
        if vals is None:
            return None
        totals = _group_reduce(vals.astype(np.float64), inv, n, np.add)
        if totals is None:
            return None
        counts = np.bincount(inv, minlength=n)
        return list(zip(totals, counts.tolist()))

    return AggregateFn(lambda: (0.0, 0), acc, merge, fin,
                       name=f"mean({on})", vectorize=vec)


def _partial_key(row):
    return row["k"]


def make_partial_transform(key, aggs: List[AggregateFn]) -> Callable:
    """Fused map transform: block -> list of partial rows, one per
    distinct key seen in this block."""

    def _key_of(row):
        if callable(key):
            return key(row)
        return row[key]

    def transform(block):
        from ray_tpu_torch.data.block import BlockAccessor, _is_batch_dict

        if (_is_batch_dict(block) and block and isinstance(key, str)
                and all(a.vectorize is not None for a in aggs)):
            col = np.asarray(block[key])
            if col.dtype != object:
                uk, inv = np.unique(col, return_inverse=True)
                per_agg = [a.vectorize(block, inv, len(uk)) for a in aggs]
                if all(s is not None for s in per_agg):
                    return [{"k": uk[g].item(),
                             "s": [sa[g] for sa in per_agg]}
                            for g in range(len(uk))]
        acc_by_key: Dict[Any, list] = {}
        for row in BlockAccessor(block).rows():
            k = _key_of(row)
            if hasattr(k, "item"):
                k = k.item()
            states = acc_by_key.get(k)
            if states is None:
                states = acc_by_key[k] = [a.init() for a in aggs]
            for i, a in enumerate(aggs):
                states[i] = a.accumulate(states[i], row)
        return [{"k": k, "s": states} for k, states in acc_by_key.items()]

    transform._op_name = "PartialAggregate"
    return transform


def make_merge_transform(key_name: str, aggs: List[AggregateFn]) -> Callable:
    """Fused reduce transform: partial rows (one partition's worth,
    co-located by the hash scatter) -> finalized result rows."""

    def transform(block):
        from ray_tpu_torch.data.block import BlockAccessor

        merged: Dict[Any, list] = {}
        for row in BlockAccessor(block).rows():
            k = row["k"]
            states = merged.get(k)
            if states is None:
                merged[k] = list(row["s"])
            else:
                for i, a in enumerate(aggs):
                    states[i] = a.merge(states[i], row["s"][i])
        return [dict([(key_name, k)]
                     + [(a.name, a.finalize(states[i]))
                        for i, a in enumerate(aggs)])
                for k, states in merged.items()]

    transform._op_name = "MergeAggregate"
    return transform


def grouped_aggregate(ds, key, key_name: str, aggs: List[AggregateFn]):
    """Full distributed groupby plan over `ds`; returns a lazy Dataset of
    result rows, globally sorted by key when keys are orderable."""
    from ray_tpu_torch.data.query.sort import sort_dataset

    partials = ds._derive(make_partial_transform(key, aggs))
    shuffled = partials._push_shuffle(mode="hash", key_fn=_partial_key)
    merged = shuffled._derive(make_merge_transform(key_name, aggs))
    return sort_dataset(merged, key_name, False, lenient=True)
