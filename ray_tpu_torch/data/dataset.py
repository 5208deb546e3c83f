"""Dataset: lazy, distributed data pipeline executed as tasks over the core.

Equivalent of the reference's `Dataset`/`Datastream`
(`python/ray/data/dataset.py`, `datastream.py:1096` streaming_split) with the
logical plan + streaming executor collapsed into one chain of fused block
transforms (`_internal/logical/`, `_internal/planner/planner.py`): every
consecutive 1:1 transform rides the same task, all-to-all ops (repartition,
random_shuffle) are materialization barriers, and consumption is streaming
(`iter_batches` starts before reads finish).

The canonical batch format is dict[str, np.ndarray], so `iter_batches`
output goes to the card with `torch.from_numpy(...).to(device)` without
conversion.
"""

from __future__ import annotations

import itertools
import logging
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext

logger = logging.getLogger(__name__)

WorkItem = Tuple[Optional[Callable], tuple]


def _map_rows_transform(fn):
    def transform(block):
        return [fn(row) for row in BlockAccessor(block).rows()]

    transform._op_name = (
        f"Map({getattr(fn, '__name__', 'fn')})")
    return transform


def _flat_map_transform(fn):
    def transform(block):
        out = []
        for row in BlockAccessor(block).rows():
            out.extend(fn(row))
        return out

    transform._op_name = (
        f"FlatMap({getattr(fn, '__name__', 'fn')})")
    return transform


def _filter_transform(fn):
    def transform(block):
        acc = BlockAccessor(block)
        if isinstance(block, list):
            return [r for r in acc.rows() if fn(r)]
        batch = acc.to_batch()
        keep = np.asarray([bool(fn(row)) for row in acc.rows()])
        return {k: v[keep] for k, v in batch.items()}

    transform._op_name = (
        f"Filter({getattr(fn, '__name__', 'fn')})")
    return transform


def _map_batches_transform(fn, batch_size: Optional[int], fn_kwargs):
    def transform(block):
        acc = BlockAccessor(block)
        n = acc.num_rows()
        if n == 0:
            return block
        if batch_size is None or batch_size >= n:
            out = fn(acc.to_batch(), **fn_kwargs) if fn_kwargs else fn(acc.to_batch())
            return BlockAccessor.batch_to_block(out)
        pieces = []
        for start in range(0, n, batch_size):
            piece = BlockAccessor(acc.slice(start, min(start + batch_size, n)))
            out = fn(piece.to_batch(), **fn_kwargs) if fn_kwargs \
                else fn(piece.to_batch())
            pieces.append(BlockAccessor.batch_to_block(out))
        return BlockAccessor.concat(pieces)

    transform._op_name = (
        f"MapBatches({getattr(fn, '__name__', 'fn')})")
    return transform


def _stable_key_hash(k) -> int:
    """Deterministic cross-process hash that agrees wherever keys compare
    equal: np scalars unbox, bool/integral floats collapse to int (True,
    1, 1.0 and np.int64(1) all bucket together — a raw pickle hash would
    split one logical group across partitions). Strings hash by bytes
    (Python's str hash is per-process salted)."""
    import pickle as _pickle
    import zlib

    if hasattr(k, "item"):
        k = k.item()
    if isinstance(k, bool):
        k = int(k)
    elif isinstance(k, float) and k.is_integer():
        k = int(k)
    if isinstance(k, int):
        return k & 0x7FFFFFFF
    if isinstance(k, str):
        return zlib.crc32(k.encode())
    if isinstance(k, bytes):
        return zlib.crc32(k)
    if isinstance(k, tuple):
        h = 0x345678
        for x in k:
            h = (h * 1000003) ^ _stable_key_hash(x)
        return h & 0x7FFFFFFF
    return zlib.crc32(_pickle.dumps(k, protocol=4))


def _shuffle_map_block(block, n_out, mode, seed, salt, key_fn):
    """Map side of the push shuffle: scatter one block's rows into n_out
    bucket blocks (returned as separate objects via num_returns).

    Modes: "random" (seeded scatter), "hash" (stable key hash — groups
    co-locate), "keyed" (key_fn IS the partition assignment, row ->
    partition index — the query tier's range partitioner).

    Columnar fast path: a random or keyed scatter of a dict-of-arrays
    block slices arrays by the assignment vector instead of
    materializing one Python dict per row — the row->partition
    assignment is computed identically to the row path (same rng draw /
    same searchsorted-vs-bisect semantics), so bucket membership is
    representation-independent and deterministic either way."""
    from ray_tpu_torch.data.block import _is_batch_dict

    columnar = _is_batch_dict(block) and block
    if mode == "random" and columnar:
        n = BlockAccessor(block).num_rows()
        rng = np.random.default_rng(
            None if seed is None else seed * 100003 + salt)
        assignment = rng.integers(0, n_out, size=n)
        if n_out == 1:
            return block
        return tuple({k: v[assignment == b] for k, v in block.items()}
                     for b in range(n_out))
    if mode == "keyed" and columnar and hasattr(key_fn, "assign_block"):
        assignment = key_fn.assign_block(block)
        if assignment is not None:
            if n_out == 1:
                return block
            return tuple({k: v[assignment == b] for k, v in block.items()}
                         for b in range(n_out))
    rows = list(BlockAccessor(block).rows())
    buckets: List[list] = [[] for _ in range(n_out)]
    if mode == "hash":
        for row in rows:
            k = key_fn(row) if key_fn else row
            buckets[_stable_key_hash(k) % n_out].append(row)
    elif mode == "keyed":
        for row in rows:
            buckets[int(key_fn(row)) % n_out].append(row)
    else:  # random scatter, deterministic per (seed, block salt)
        rng = np.random.default_rng(
            None if seed is None else seed * 100003 + salt)
        assignment = rng.integers(0, n_out, size=len(rows))
        for row, b in zip(rows, assignment):
            buckets[b].append(row)
    return buckets[0] if n_out == 1 else tuple(buckets)


def _shuffle_reduce_blocks(mode, seed, part_idx, *buckets):
    """Reduce side: concat this partition's buckets (+ local shuffle for
    random mode, so within-partition order is random too). Columnar
    buckets concat as arrays and shuffle via one permutation."""
    from ray_tpu_torch.data.block import _is_batch_dict

    if buckets and all(_is_batch_dict(b) for b in buckets):
        merged = BlockAccessor.concat(list(buckets))
        if mode == "random":
            rng = np.random.default_rng(
                None if seed is None else seed * 7919 + part_idx)
            perm = rng.permutation(BlockAccessor(merged).num_rows())
            merged = {k: v[perm] for k, v in merged.items()}
        return merged
    rows: List[Any] = []
    for b in buckets:
        if _is_batch_dict(b):
            # Mixed representations (e.g. a union of columnar and row
            # parents): expand dict buckets to rows — extending the raw
            # dict would splice column NAMES into the data.
            rows.extend(BlockAccessor(b).rows())
        else:
            rows.extend(b)
    if mode == "random":
        rng = np.random.default_rng(
            None if seed is None else seed * 7919 + part_idx)
        rng.shuffle(rows)
    return rows


class ActorPoolStrategy:
    """Compute strategy for stateful map_batches UDFs (reference
    `ActorPoolStrategy` / `actor_pool_map_operator.py`): blocks flow
    through a pool of long-lived actors, each holding one instance of the
    UDF class — expensive setup (model load, jit compile) happens once per
    actor instead of once per block."""

    def __init__(self, size: Optional[int] = None, *, min_size: int = 1,
                 max_size: Optional[int] = None):
        self.size = size or max_size or max(min_size, 2)


class _MapWorker:
    """Actor body for ActorPoolStrategy stages."""

    def __init__(self, fn_cls, ctor_args, ctor_kwargs, batch_size, fn_kwargs):
        self._transform = _map_batches_transform(
            fn_cls(*ctor_args, **ctor_kwargs), batch_size, fn_kwargs)

    def apply(self, block):
        return self._transform(block)


class Dataset:
    """Lazy pipeline: `_work` produces input blocks, `_transforms` fuse."""

    def __init__(self, work: List[WorkItem],
                 transforms: Optional[List[Callable]] = None,
                 resources: Optional[dict] = None):
        self._work = work
        self._transforms = list(transforms or [])
        self._resources = resources
        self._materialized_refs: Optional[List[Any]] = None

    # ------------------------------------------------------------ transforms

    def _derive(self, transform: Callable) -> "Dataset":
        return Dataset(self._work, self._transforms + [transform],
                       self._resources)

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return self._derive(_map_rows_transform(fn))

    def flat_map(self, fn: Callable[[Any], List[Any]]) -> "Dataset":
        return self._derive(_flat_map_transform(fn))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        return self._derive(_filter_transform(fn))

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    fn_kwargs: Optional[Dict] = None,
                    compute: Optional["ActorPoolStrategy"] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[Dict] = None,
                    **_compat) -> "Dataset":
        if compute is not None or isinstance(fn, type):
            if not isinstance(fn, type):
                raise ValueError(
                    "compute=ActorPoolStrategy requires a callable CLASS "
                    "(stateful UDF), got a function")
            return _ActorStageDataset(
                self, fn, batch_size, fn_kwargs or {},
                tuple(fn_constructor_args), fn_constructor_kwargs or {},
                compute or ActorPoolStrategy())
        return self._derive(_map_batches_transform(fn, batch_size,
                                                   fn_kwargs or {}))

    def limit(self, n: int) -> "Dataset":
        """First `n` rows. Executes streaming with early stop (the
        reference's limit pushdown: upstream tasks past the cutoff are
        never launched because the pull stops)."""
        parent = self

        def work() -> List[WorkItem]:
            out: List[WorkItem] = []
            remaining = n
            for block in parent._iter_block_values():
                acc = BlockAccessor(block)
                take = min(acc.num_rows(), remaining)
                if take > 0:
                    out.append((None, (acc.slice(0, take),)))
                    remaining -= take
                if remaining <= 0:
                    break
            return out

        return _DeferredDataset(work)

    def sort(self, key: Optional[Any] = None, descending: bool = False
             ) -> "Dataset":
        """Distributed global sort: sample-based range partitioning
        through the windowed shuffle, per-partition stable local sort
        (ray_tpu_torch/data/query/sort.py). The driver holds only the boundary
        sample (bounded by `query_sort_sample_rows`), never rows —
        output is row-identical to a driver-side stable sort for any
        sample draw."""
        from ray_tpu_torch.data.query.sort import sort_dataset

        return sort_dataset(self, key, descending)

    def join(self, other: "Dataset", on,
             how: str = "inner") -> "Dataset":
        """Distributed join (ray_tpu_torch/data/query/join.py): broadcast when
        `other` (the build side) fits `query_broadcast_join_bytes`,
        hash-shuffle exchange of both sides otherwise. `on` is a column
        name or a (left_col, right_col) pair; `how` is "inner" or
        "left". Colliding non-key columns from `other` get the zip()
        "_1" suffix."""
        from ray_tpu_torch.data.query.join import join_datasets

        return join_datasets(self, other, on, how)

    def with_resources(self, **resources) -> "Dataset":
        """Run this dataset's tasks with resource options (e.g. num_cpus).
        Type-preserving: subclasses carry their plan state along."""
        out = self._copy()
        out._resources = resources
        return out

    def _copy(self) -> "Dataset":
        return Dataset(self._work, self._transforms, self._resources)

    # ----------------------------------------------------------- all-to-all

    def repartition(self, num_blocks: int, *,
                    shuffle: bool = False) -> "Dataset":
        """Rebalance into num_blocks blocks. shuffle=True runs the
        distributed push shuffle instead of the driver-side re-slice
        (reference repartition(shuffle=True))."""
        if shuffle:
            return self._push_shuffle(mode="random", seed=0,
                                      num_blocks=num_blocks)
        parent = self

        def work() -> List[WorkItem]:
            # raylint: disable=RL019 — documented driver-side re-slice; width-scale callers pass shuffle=True
            blocks = [b for b in parent._iter_block_values()]
            merged = BlockAccessor.concat(blocks) if blocks else []
            total = BlockAccessor(merged).num_rows()
            per = max(1, -(-total // num_blocks))
            acc = BlockAccessor(merged)
            out: List[WorkItem] = []
            for i in range(num_blocks):
                start = min(i * per, total)
                end = min((i + 1) * per, total)
                out.append((None, (acc.slice(start, end),)))
            return out

        return _DeferredDataset(work)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Global shuffle as a push-based two-stage exchange (reference
        `push_based_shuffle.py`): map tasks scatter each block's rows into
        per-output buckets (one return object per bucket, so a reducer
        pulls only its slice), reduce tasks concat + locally shuffle. The
        driver never materializes the data."""
        return self._push_shuffle(mode="random", seed=seed)

    def _push_shuffle(self, *, mode: str, seed: Optional[int] = None,
                      key_fn: Optional[Callable[[Any], Any]] = None,
                      num_blocks: Optional[int] = None) -> "Dataset":
        return _WindowedShuffleDataset(self, mode, seed, key_fn, num_blocks)

    def union(self, *others: "Dataset") -> "Dataset":
        sets = [self, *others]

        def work() -> List[WorkItem]:
            out: List[WorkItem] = []
            for ds in sets:
                for ref in ds._iter_block_refs():
                    out.append((None, (ref,)))
            return out

        return _DeferredDataset(work)

    # ------------------------------------------------------------- execution

    def _iter_block_refs(self) -> Iterator[Any]:
        """Streaming execution: yields ObjectRefs to output blocks."""
        if self._materialized_refs is not None:
            yield from self._materialized_refs
            return
        yield from self._execute_work(iter(self._work))

    def _ensure_collector(self):
        from ray_tpu_torch.data.context import DataContext

        if not DataContext.get_current().enable_stats:
            return None
        from ray_tpu_torch.data import stats as stats_mod

        # One collector per Dataset, reused across executions and
        # reaped with the Dataset object (a per-execution actor
        # would leak one worker process per epoch).
        collector = getattr(self, "_stats_collector", None)
        if collector is None:
            collector = stats_mod.make_collector()
            self._stats_collector = collector
        return collector

    def _execute_work(self, work_iter, lineage=None) -> Iterator[Any]:
        """Run one streaming execution over `work_iter` (shared by the
        plan path and the windowed-shuffle path): byte-budgeted executor,
        per-dataset stats collector, per-execution block lineage (shared
        with an upstream shuffle stage when passed in)."""
        from ray_tpu_torch.data.executor import StreamingExecutor
        from ray_tpu_torch.data.streaming.lineage import BlockLineage

        collector = self._ensure_collector()
        if lineage is None:
            lineage = BlockLineage()
        self._lineage = lineage
        executor = StreamingExecutor(self._transforms,
                                     resources=self._resources,
                                     stats_collector=collector,
                                     lineage=lineage)
        # Cumulative across executions: the collector aggregates every
        # run of this Dataset, so the stats() flush barrier must expect
        # the total, not just the latest run's blocks.
        if getattr(self, "_executed_blocks", None) is None:
            self._executed_blocks = 0
        try:
            for ref in executor.execute(work_iter):
                self._executed_blocks += 1
                yield ref
        finally:
            self._last_budget_stats = executor.last_budget_stats
            lineage.clear()  # recipes drain with the execution

    def stats(self):
        """Per-operator wall/rows/blocks summary, aggregated over every
        execution of this Dataset so far (re-iterating a lazy dataset
        adds to the totals — reference `Dataset.stats()`,
        `data/_internal/stats.py`), plus the LAST execution's per-op
        byte-budget backpressure (`.backpressure` — where the pipeline
        is bound). None before any execution."""
        from ray_tpu_torch.data import stats as stats_mod

        return stats_mod.fetch(getattr(self, "_stats_collector", None),
                               expected_blocks=getattr(
                                   self, "_executed_blocks", None),
                               backpressure=getattr(
                                   self, "_last_budget_stats", None))

    def _iter_block_values(self) -> Iterator[Block]:
        import ray_tpu_torch

        for ref in self._iter_block_refs():
            # Data-tier lineage fallback: a block the core could not
            # recover re-runs from its recorded recipe, bounded.
            lineage = getattr(self, "_lineage", None)
            if lineage is not None:
                yield lineage.resolve(ref)
            else:
                yield ray_tpu_torch.get(ref)

    def materialize(self) -> "Dataset":
        refs = list(self._iter_block_refs())
        out = Dataset(self._work, self._transforms, self._resources)
        out._stats_collector = getattr(self, "_stats_collector", None)
        out._executed_blocks = getattr(self, "_executed_blocks", None)
        out._materialized_refs = refs
        # Keep a plan for re-execution-from-refs.
        out._work = [(None, (r,)) for r in refs]
        out._transforms = []
        return out

    # ------------------------------------------------------------ consumers

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_block_values():
            yield from BlockAccessor(block).rows()

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False,
                     prefetch_batches: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        from ray_tpu_torch.data.iterator import batch_blocks

        yield from batch_blocks(self._iter_block_values(), batch_size,
                                drop_last)

    def iterator(self):
        from ray_tpu_torch.data.iterator import DataIterator

        return DataIterator(self)

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for block in self._iter_block_values():
            out.extend(BlockAccessor(block).take(limit - len(out)))
            if len(out) >= limit:
                break
        return out[:limit]

    def take_all(self) -> List[Any]:
        # raylint: disable=RL019 — the deliberate driver-resident endpoint: the caller asked for a local copy
        return [r for r in self.iter_rows()]

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows()
                   for b in self._iter_block_values())

    def schema(self):
        for block in self._iter_block_values():
            acc = BlockAccessor(block)
            if acc.num_rows():
                return acc.schema()
        return None

    def num_blocks(self) -> int:
        return len(self._work)

    # ------------------------------------------------------------ column ops

    def add_column(self, name: str, fn: Callable[[Any], Any]) -> "Dataset":
        """Add a column computed per row (reference Dataset.add_column)."""
        return self.map(lambda r: {**r, name: fn(r)})

    def drop_columns(self, cols: List[str]) -> "Dataset":
        drop = set(cols)
        return self.map(
            lambda r: {k: v for k, v in r.items() if k not in drop})

    def select_columns(self, cols: List[str]) -> "Dataset":
        keep = list(cols)
        return self.map(lambda r: {k: r[k] for k in keep})

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column: per-block sets union'd on the
        driver (map-side dedup keeps the transfer small)."""
        def transform(block):
            seen = {row[column] for row in BlockAccessor(block).rows()}
            return [{"u": v} for v in seen]

        out = set()
        for b in self._derive(transform)._iter_block_values():
            for row in BlockAccessor(b).rows():
                out.add(row["u"])
        try:
            return sorted(out)
        except TypeError:  # mixed/unorderable values
            return list(out)

    def zip(self, other: "Dataset") -> "Dataset":
        """Positional zip (reference Dataset.zip): rows pair up in order;
        dict rows merge (collisions suffixed _1), others become tuples.
        All-to-all barrier — deferred until consumed, like repartition."""
        parent, rhs = self, other

        def work() -> List[WorkItem]:
            right_rows = []
            for b in rhs._iter_block_values():
                right_rows.extend(BlockAccessor(b).rows())
            blocks: List[Block] = []
            pos = 0
            for b in parent._iter_block_values():
                merged = []
                for r in BlockAccessor(b).rows():
                    if pos >= len(right_rows):
                        raise ValueError(
                            "zip: datasets have different lengths")
                    o = right_rows[pos]
                    pos += 1
                    if isinstance(r, dict) and isinstance(o, dict):
                        m = dict(r)
                        for k, v in o.items():
                            m[f"{k}_1" if k in m else k] = v
                        merged.append(m)
                    else:
                        merged.append((r, o))
                blocks.append(merged)
            if pos != len(right_rows):
                raise ValueError("zip: datasets have different lengths")
            return [(None, (b,)) for b in blocks]

        return _DeferredDataset(work)

    # --------------------------------------------------------------- groupby

    def groupby(self, key: Union[str, Callable[[Any], Any]]) -> "GroupedData":
        """Group rows by a column name or key function (reference
        Dataset.groupby -> GroupedData)."""
        return GroupedData(self, key)

    def sum(self, on: Optional[str] = None):
        return self._agg(np.sum, on)

    def mean(self, on: Optional[str] = None):
        total, rows = 0.0, 0
        for b in self._iter_block_values():
            acc = BlockAccessor(b)
            batch = acc.to_batch()
            col = batch[on] if on else next(iter(batch.values()))
            total += float(np.sum(col))
            rows += len(col)
        return total / rows if rows else 0.0

    def min(self, on: Optional[str] = None):
        return self._agg(np.min, on, reducer=min)

    def max(self, on: Optional[str] = None):
        return self._agg(np.max, on, reducer=max)

    def _agg(self, fn, on, reducer=None):
        parts = []
        for b in self._iter_block_values():
            batch = BlockAccessor(b).to_batch()
            col = batch[on] if on else next(iter(batch.values()))
            if len(col):
                parts.append(fn(col))
        if not parts:
            return None
        if reducer:
            out = parts[0]
            for p in parts[1:]:
                out = reducer(out, p)
            return out
        return float(np.sum(parts)) if fn is np.sum else fn(parts)

    # ---------------------------------------------------------------- splits

    def split(self, n: int) -> List["Dataset"]:
        """Materializing split into n datasets with balanced rows."""
        refs = list(self.materialize()._iter_block_refs())
        groups: List[List[Any]] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            groups[i % n].append(ref)
        out = []
        for g in groups:
            ds = Dataset([(None, (r,)) for r in g])
            out.append(ds)
        return out

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List[Any]:
        """n coordinated iterators over ONE shared streaming execution
        (reference `datastream.py:1096` -> `StreamSplitDataIterator`)."""
        from ray_tpu_torch.data.iterator import make_streaming_splits

        return make_streaming_splits(self, n, equal=equal)

    # ---------------------------------------------------------------- writes

    def write_parquet(self, path: str) -> List[str]:
        return self._write(path, "parquet")

    def write_csv(self, path: str) -> List[str]:
        return self._write(path, "csv")

    def write_json(self, path: str) -> List[str]:
        return self._write(path, "json")

    def write_numpy(self, path: str, column: str = "item") -> List[str]:
        return self._write(path, "numpy", column=column)

    def write_webdataset(self, path: str) -> List[str]:
        """One tar shard per block; rows must be dicts whose keys are
        webdataset extensions (plus optional __key__)."""
        return self._write(path, "webdataset")

    def _write(self, path: str, fmt: str, **kw) -> List[str]:
        import os

        import ray_tpu_torch
        from ray_tpu_torch.data.datasource import write_block

        os.makedirs(path, exist_ok=True)
        refs = []
        for i, block_ref in enumerate(self._iter_block_refs()):
            refs.append(ray_tpu_torch.remote(write_block).remote(
                block_ref, path, i, fmt, kw))
        return ray_tpu_torch.get(refs)

    def to_pandas(self):
        import pandas as pd

        # raylint: disable=RL019 — a DataFrame IS a local copy; the caller opted out of the streaming plane
        blocks = [BlockAccessor(b).to_pandas()
                  for b in self._iter_block_values()]
        return pd.concat(blocks, ignore_index=True) if blocks else pd.DataFrame()

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._work)}, "
                f"num_transforms={len(self._transforms)})")


class _ActorStageDataset(Dataset):
    """map_batches over an actor pool: the parent's output refs stream
    through `size` long-lived _MapWorker actors with bounded in-flight
    (reference `actor_pool_map_operator.py`); downstream 1:1 transforms
    fuse into tasks over the stage's outputs as usual."""

    def __init__(self, parent: Dataset, fn_cls, batch_size, fn_kwargs,
                 ctor_args, ctor_kwargs, strategy: ActorPoolStrategy,
                 transforms: Optional[List[Callable]] = None,
                 resources: Optional[dict] = None):
        super().__init__([], transforms, resources or parent._resources)
        self._parent = parent
        self._stage = (fn_cls, batch_size, fn_kwargs, ctor_args, ctor_kwargs,
                       strategy)

    def _derive(self, transform: Callable) -> "Dataset":
        return _ActorStageDataset(self._parent, *self._stage[:5],
                                  self._stage[5],
                                  self._transforms + [transform],
                                  self._resources)

    def _copy(self) -> "Dataset":
        return _ActorStageDataset(self._parent, *self._stage[:5],
                                  self._stage[5], list(self._transforms),
                                  self._resources)

    def _actor_output_refs(self) -> Iterator[Any]:
        import ray_tpu_torch

        fn_cls, batch_size, fn_kwargs, ctor_args, ctor_kwargs, strat = \
            self._stage
        actor_cls = ray_tpu_torch.remote(_MapWorker)
        if self._resources:
            actor_cls = actor_cls.options(**self._resources)
        actors = [actor_cls.remote(fn_cls, ctor_args, ctor_kwargs,
                                   batch_size, fn_kwargs)
                  for _ in range(strat.size)]
        try:
            upstream = self._parent._iter_block_refs()
            in_flight: Dict[Any, Any] = {}  # result ref -> actor
            free = list(actors)
            exhausted = False
            while True:
                while free and not exhausted:
                    try:
                        block_ref = next(upstream)
                    except StopIteration:
                        exhausted = True
                        break
                    actor = free.pop()
                    in_flight[actor.apply.remote(block_ref)] = actor
                if not in_flight:
                    if exhausted:
                        return
                    continue
                ready, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                        timeout=30.0)
                for ref in ready:
                    free.append(in_flight.pop(ref))
                    yield ref
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:  # noqa: BLE001
                    pass

    def _iter_block_refs(self) -> Iterator[Any]:
        if self._materialized_refs is not None:
            yield from self._materialized_refs
            return
        refs = self._actor_output_refs()
        if not self._transforms:
            yield from refs
            return
        from ray_tpu_torch.data.executor import StreamingExecutor

        executor = StreamingExecutor(self._transforms,
                                     resources=self._resources)
        yield from executor.execute((None, (ref,)) for ref in refs)

    def num_blocks(self) -> int:
        return self._parent.num_blocks()


class _DeferredDataset(Dataset):
    """Dataset whose inputs come from a barrier (all-to-all) computation;
    the work list is computed on first execution and cached."""

    def __init__(self, work_fn: Callable[[], List[WorkItem]],
                 transforms: Optional[List[Callable]] = None,
                 resources: Optional[dict] = None):
        super().__init__([], transforms, resources)
        self._work_fn = work_fn
        self._resolved = False

    def _derive(self, transform: Callable) -> "Dataset":
        return _DeferredDataset(self._work_fn,
                                self._transforms + [transform],
                                self._resources)

    def _copy(self) -> "Dataset":
        return _DeferredDataset(self._work_fn, list(self._transforms),
                                self._resources)

    def _resolve(self):
        if not self._resolved:
            self._work = self._work_fn()
            self._resolved = True

    def _iter_block_refs(self) -> Iterator[Any]:
        self._resolve()
        yield from super()._iter_block_refs()

    def num_blocks(self) -> int:
        self._resolve()
        return len(self._work)


class _WindowedShuffleDataset(Dataset):
    """All-to-all exchange executed as the WINDOWED streaming plan
    (ray_tpu_torch/data/streaming/shuffle.py): parent blocks stream through
    budget-bounded scatter windows whose sealed buckets spill through the
    store's disk tier when the working set exceeds memory, then reduce
    with bounded admission. Row-level output is identical to the one-shot
    exchange for a given (mode, seed).

    Re-iterating RE-WINDOWS: every epoch re-runs the exchange (and the
    parent pipeline feeding it) instead of re-materializing the shuffled
    dataset — multi-epoch train ingest holds one window of intermediates,
    not the whole dataset. `materialize()` still pins an epoch's outputs
    when a caller wants them resident."""

    def __init__(self, parent: Dataset, mode: str, seed: Optional[int],
                 key_fn: Optional[Callable[[Any], Any]],
                 num_blocks: Optional[int],
                 transforms: Optional[List[Callable]] = None,
                 resources: Optional[dict] = None):
        super().__init__([], transforms, resources or parent._resources)
        self._parent = parent
        self._shuffle_plan = (mode, seed, key_fn, num_blocks)
        # Filled per execution: windows / input_bytes / window_bytes.
        self.last_shuffle_stats: Dict[str, Any] = {}

    def _derive(self, transform: Callable) -> "Dataset":
        return _WindowedShuffleDataset(self._parent, *self._shuffle_plan,
                                       self._transforms + [transform],
                                       self._resources)

    def _copy(self) -> "Dataset":
        return _WindowedShuffleDataset(self._parent, *self._shuffle_plan,
                                       list(self._transforms),
                                       self._resources)

    def num_blocks(self) -> int:
        n_out = self._shuffle_plan[3]
        return n_out if n_out else self._parent.num_blocks()

    def _iter_block_refs(self) -> Iterator[Any]:
        if self._materialized_refs is not None:
            yield from self._materialized_refs
            return
        from ray_tpu_torch.data.streaming.budget import pipeline_budget
        from ray_tpu_torch.data.streaming.shuffle import iter_shuffled_refs

        mode, seed, key_fn, _ = self._shuffle_plan
        n_out = self.num_blocks()
        if n_out <= 0:
            return
        from ray_tpu_torch.data.streaming.lineage import BlockLineage

        collector = self._ensure_collector()
        lineage = BlockLineage()
        stats: Dict[str, Any] = {}
        # Live while the epoch runs, so a consumer that stops mid-epoch
        # (a split's coordinator) can still read the map stage's windows.
        self.last_shuffle_stats = stats
        with pipeline_budget() as budget:
            reduce_refs = iter_shuffled_refs(
                self._parent._iter_block_refs(), n_out, mode=mode,
                seed=seed, key_fn=key_fn, budget=budget,
                stage_stats=collector, stats=stats,
                resources=self._resources, lineage=lineage)
            try:
                if not self._transforms:
                    # No downstream transforms: reduce outputs ARE the
                    # dataset's blocks — yield them directly instead of
                    # paying an identity fused task per block (and keep
                    # the lineage chain one level deep for recovery).
                    self._lineage = lineage
                    yield from reduce_refs
                else:
                    yield from self._execute_work(
                        ((None, (r,)) for r in reduce_refs),
                        lineage=lineage)
            finally:
                if not self._transforms:
                    self._last_budget_stats = budget.stats()
                    lineage.clear()


class _RangeSortDataset(Dataset):
    """Distributed sort (ray_tpu_torch/data/query/sort.py): bounded remote key
    sample -> range boundaries -> keyed windowed exchange -> fused stable
    local sort. Inherits the windowed shuffle's budget/spill/lineage
    behavior; `last_sort_stats` records the driver-resident sample bytes
    (the operator's entire driver footprint) for assertion."""

    def __init__(self, parent: Dataset, key, descending: bool,
                 lenient: bool = False,
                 transforms: Optional[List[Callable]] = None,
                 resources: Optional[dict] = None):
        super().__init__([], transforms, resources or parent._resources)
        self._parent = parent
        self._sort_plan = (key, descending, lenient)
        self.last_sort_stats: Dict[str, Any] = {}
        self.last_shuffle_stats: Dict[str, Any] = {}

    def _derive(self, transform: Callable) -> "Dataset":
        return _RangeSortDataset(self._parent, *self._sort_plan,
                                 self._transforms + [transform],
                                 self._resources)

    def _copy(self) -> "Dataset":
        return _RangeSortDataset(self._parent, *self._sort_plan,
                                 list(self._transforms), self._resources)

    def num_blocks(self) -> int:
        return max(1, self._parent.num_blocks())

    def _sample_boundaries(self, parent_refs, key, n_parts):
        """Remote per-block key samples -> sorted boundary cut points.
        Driver-resident state is KEYS ONLY, bounded by
        `query_sort_sample_rows`; `last_sort_stats` carries the measured
        byte count so tests can assert the bound. Raises TypeError for
        unorderable key mixtures (callers in lenient mode catch it)."""
        import ray_tpu_torch
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.query.sort import (_sample_block_keys,
                                             compute_boundaries)

        ctx = DataContext.get_current()
        sample_rows = max(n_parts, ctx.resolved_sort_sample_rows())
        per_block = max(1, -(-sample_rows // len(parent_refs)))
        sampler = ray_tpu_torch.remote(_sample_block_keys)
        if self._resources:
            sampler = sampler.options(**self._resources)
        sample_refs = [
            sampler.remote(ref, per_block, key, 0, salt)
            for salt, ref in enumerate(parent_refs)]
        # bounded-sample: per_block * n_blocks ~= query_sort_sample_rows
        # keys total — never rows, never unbounded.
        samples = [k for part in ray_tpu_torch.get(sample_refs) for k in part]
        if len(samples) > sample_rows:  # cap exactly, not just ~per-block
            rng = np.random.default_rng(0)
            keep = sorted(rng.choice(len(samples), size=sample_rows,
                                     replace=False).tolist())
            samples = [samples[i] for i in keep]
        boundaries = compute_boundaries(samples, n_parts)
        self.last_sort_stats = {
            "sample_rows": len(samples),
            "driver_sample_bytes": serialization.serialized_size(
                serialization.serialize(samples)),
            "n_parts": n_parts,
        }
        return boundaries

    def _iter_block_refs(self) -> Iterator[Any]:
        if self._materialized_refs is not None:
            yield from self._materialized_refs
            return
        from ray_tpu_torch.data.executor import StreamingExecutor
        from ray_tpu_torch.data.query.sort import (_RangePartitioner,
                                             make_local_sort_transform)
        from ray_tpu_torch.data.streaming.budget import pipeline_budget
        from ray_tpu_torch.data.streaming.lineage import BlockLineage
        from ray_tpu_torch.data.streaming.shuffle import iter_shuffled_refs

        key, descending, lenient = self._sort_plan
        # Parent executes ONCE; refs (not data) are held so the sample
        # and scatter passes read the same blocks. Sealed parents spill
        # under pressure, so pinning refs is disk-bounded, not RAM.
        parent_refs = list(self._parent._iter_block_refs())
        if not parent_refs:
            return
        n_parts = self.num_blocks()
        try:
            boundaries = self._sample_boundaries(parent_refs, key, n_parts)
        except TypeError:
            if not lenient:
                raise
            # Unorderable key mixture: degrade to unsorted passthrough
            # (the groupby result-ordering contract).
            yield from self._execute_work(
                ((None, (r,)) for r in parent_refs))
            return
        partitioner = _RangePartitioner(boundaries, key, descending,
                                        n_parts)
        collector = self._ensure_collector()
        lineage = BlockLineage()
        stats: Dict[str, Any] = {}
        with pipeline_budget() as budget:
            reduce_refs = iter_shuffled_refs(
                iter(parent_refs), n_parts, mode="keyed", seed=0,
                key_fn=partitioner, budget=budget, stage_stats=collector,
                stats=stats, resources=self._resources, lineage=lineage)
            transforms = [make_local_sort_transform(key, descending,
                                                    lenient)]
            transforms += self._transforms
            executor = StreamingExecutor(transforms,
                                         resources=self._resources,
                                         stats_collector=collector,
                                         lineage=lineage)
            self._lineage = lineage
            if getattr(self, "_executed_blocks", None) is None:
                self._executed_blocks = 0
            try:
                for ref in executor.execute(
                        (None, (r,)) for r in reduce_refs):
                    self._executed_blocks += 1
                    yield ref
            finally:
                self.last_shuffle_stats = stats
                self._last_budget_stats = executor.last_budget_stats
                lineage.clear()


class _JoinDataset(Dataset):
    """Distributed join (ray_tpu_torch/data/query/join.py). Strategy picked at
    iteration time from the build side's actual sealed bytes: broadcast
    (right refs ride every probe task's args; the store ships each right
    block to a node at most once) or hash exchange of BOTH sides through
    the windowed shuffle under ONE shared pipeline budget.
    `last_join_stats` records the decision + build size."""

    def __init__(self, parent: Dataset, right: Dataset, left_on: str,
                 right_on: str, how: str,
                 transforms: Optional[List[Callable]] = None,
                 resources: Optional[dict] = None):
        super().__init__([], transforms, resources or parent._resources)
        self._parent = parent
        self._join_plan = (right, left_on, right_on, how)
        self.last_join_stats: Dict[str, Any] = {}

    def _derive(self, transform: Callable) -> "Dataset":
        return _JoinDataset(self._parent, *self._join_plan,
                            self._transforms + [transform],
                            self._resources)

    def _copy(self) -> "Dataset":
        return _JoinDataset(self._parent, *self._join_plan,
                            list(self._transforms), self._resources)

    def num_blocks(self) -> int:
        return max(1, self._parent.num_blocks())

    def _iter_block_refs(self) -> Iterator[Any]:
        if self._materialized_refs is not None:
            yield from self._materialized_refs
            return
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.executor import StreamingExecutor
        from ray_tpu_torch.data.query.join import (_KeyGetter,
                                             join_partition_blocks)
        from ray_tpu_torch.data.streaming.budget import pipeline_budget
        from ray_tpu_torch.data.streaming.lineage import BlockLineage
        from ray_tpu_torch.data.streaming.shuffle import (_block_size,
                                                    iter_shuffled_refs)

        right, left_on, right_on, how = self._join_plan
        ctx = DataContext.get_current()
        # Build side materializes to refs either way: broadcast ships
        # them to every probe, hash exchange re-scatters them. Sizes
        # come from the object directory, not from pulling data.
        right_refs = list(right._iter_block_refs())
        est_default = ctx.target_min_block_size
        build_bytes = sum(_block_size(r) or est_default
                          for r in right_refs)
        threshold = ctx.resolved_broadcast_join_bytes()
        broadcast = build_bytes <= threshold
        self.last_join_stats = {
            "strategy": "broadcast" if broadcast else "hash",
            "build_bytes": build_bytes,
            "broadcast_threshold": threshold,
        }
        collector = self._ensure_collector()
        lineage = BlockLineage()
        self._lineage = lineage
        executor = StreamingExecutor(self._transforms,
                                     resources=self._resources,
                                     stats_collector=collector,
                                     lineage=lineage)
        if getattr(self, "_executed_blocks", None) is None:
            self._executed_blocks = 0

        def _run(work_iter):
            try:
                for ref in executor.execute(work_iter):
                    self._executed_blocks += 1
                    yield ref
            finally:
                self._last_budget_stats = executor.last_budget_stats
                lineage.clear()

        if broadcast:
            yield from _run(
                (join_partition_blocks,
                 (left_on, right_on, how, None, lref, *right_refs))
                for lref in self._parent._iter_block_refs())
            return
        rcols_hint = None
        if how == "left":
            # Left-join None-fill needs the GLOBAL right column set — a
            # hash partition may receive none (or a columnar subset) of
            # the build rows yet must still emit the same schema as the
            # broadcast strategy. Column NAMES are bounded metadata, so
            # this stays within the driver's sample-sized footprint.
            from ray_tpu_torch.data.query.join import right_block_columns
            import ray_tpu_torch
            col_task = ray_tpu_torch.remote(right_block_columns)
            # raylint: disable=RL019 — bounded metadata: column names only, one short list per build block
            col_lists = ray_tpu_torch.get([col_task.remote(r)
                                     for r in right_refs])
            seen_cols: set = set()
            rcols_hint = []
            for cols in col_lists:
                for c in cols:
                    if c not in seen_cols:
                        seen_cols.add(c)
                        rcols_hint.append(c)
        n_parts = self.num_blocks()
        lstats: Dict[str, Any] = {}
        rstats: Dict[str, Any] = {}
        with pipeline_budget() as budget:
            lgen = iter_shuffled_refs(
                self._parent._iter_block_refs(), n_parts, mode="hash",
                seed=0, key_fn=_KeyGetter(left_on), budget=budget,
                stage_stats=collector, stats=lstats,
                resources=self._resources, lineage=lineage)
            rgen = iter_shuffled_refs(
                iter(right_refs), n_parts, mode="hash", seed=0,
                key_fn=_KeyGetter(right_on), budget=budget,
                stage_stats=collector, stats=rstats,
                resources=self._resources, lineage=lineage)
            try:
                yield from _run(
                    (join_partition_blocks,
                     (left_on, right_on, how, rcols_hint, lref, rref))
                    for lref, rref in zip(lgen, rgen))
            finally:
                lgen.close()
                rgen.close()
                self.last_join_stats["left_shuffle"] = lstats
                self.last_join_stats["right_shuffle"] = rstats


class GroupedData:
    """Result of `Dataset.groupby`: the distributed hash-aggregate plan
    (ray_tpu_torch/data/query/aggregate.py) — per-block partial aggregation,
    hash scatter of the partials through the windowed shuffle, merge +
    finalize on the reducers, range-sorted output. Rows never transit
    the driver. Aggregations return a Dataset of `{key, <agg>}` rows
    sorted by key (when orderable); `map_groups` applies a function to
    each group's rows in parallel tasks.
    """

    def __init__(self, ds: Dataset, key: Union[str, Callable[[Any], Any]]):
        self._ds = ds
        self._key = key

    def _key_fn(self) -> Callable[[Any], Any]:
        k = self._key
        if callable(k):
            return k
        return lambda row: row[k]

    def _key_name(self) -> str:
        return self._key if isinstance(self._key, str) else "key"

    def aggregate(self, *aggs) -> Dataset:
        """Run composable AggregateFns (ray_tpu_torch/data/query/aggregate.py)
        through the distributed hash-aggregate plan; one result row per
        key, columns named by each aggregation."""
        from ray_tpu_torch.data.query.aggregate import grouped_aggregate

        return grouped_aggregate(self._ds, self._key, self._key_name(),
                                 list(aggs))

    def count(self) -> Dataset:
        from ray_tpu_torch.data.query.aggregate import Count

        return self.aggregate(Count())

    def sum(self, on: str) -> Dataset:
        from ray_tpu_torch.data.query.aggregate import Sum

        return self.aggregate(Sum(on))

    def mean(self, on: str) -> Dataset:
        from ray_tpu_torch.data.query.aggregate import Mean

        return self.aggregate(Mean(on))

    def min(self, on: str) -> Dataset:
        from ray_tpu_torch.data.query.aggregate import Min

        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        from ray_tpu_torch.data.query.aggregate import Max

        return self.aggregate(Max(on))

    def map_groups(self, fn: Callable[[List[Any]], Any]) -> Dataset:
        """Apply `fn` to each group's full row list; fn returns a row or a
        list of rows. Rows route to partitions by key hash through the
        push shuffle (all of a group's rows land in one partition without
        transiting the driver); each partition task then groups locally
        and applies fn per group."""
        keyf = self._key_fn()
        shuffled = self._ds._push_shuffle(mode="hash", key_fn=keyf)

        def transform(block):
            groups: Dict[Any, List[Any]] = {}
            for row in BlockAccessor(block).rows():
                groups.setdefault(keyf(row), []).append(row)
            out: List[Any] = []
            for rows in groups.values():
                res = fn(rows)
                out.extend(res if isinstance(res, list) else [res])
            return out

        return shuffled._derive(transform)
