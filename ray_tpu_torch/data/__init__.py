"""ray_tpu_torch.data: distributed datasets executed as tasks over the core.

Equivalent of Ray Data (`python/ray/data/read_api.py`, `dataset.py`):
creation APIs here, transforms/consumption on `Dataset`. Reads are lazy —
each file/chunk becomes a read task fused with downstream transforms.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import ActorPoolStrategy, Dataset
from ray_tpu_torch.data.iterator import DataIterator, StreamSplitDataIterator
from ray_tpu_torch.data.streaming import (BlockLineage, ByteBudget,
                                    ShardIterator)
from ray_tpu_torch.data import datasource as _ds


def _auto_parallelism(n_items: int) -> int:
    ctx = DataContext.get_current()
    if ctx.read_parallelism > 0:
        return min(n_items, ctx.read_parallelism)
    try:
        import ray_tpu_torch

        cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 2))
    except Exception:
        cpus = 2
    return max(1, min(n_items, 2 * cpus, 192))


# ------------------------------------------------------------------ creation #


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    import builtins

    p = parallelism if parallelism > 0 else _auto_parallelism(max(1, n // 1000))
    per = max(1, -(-n // p))
    work = [(_ds.make_range_block, (s, min(s + per, n)))
            for s in builtins.range(0, n, per)]
    return Dataset(work)


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1) -> Dataset:
    import builtins

    p = parallelism if parallelism > 0 else _auto_parallelism(max(1, n // 1000))
    per = max(1, -(-n // p))
    work = [(_ds.make_tensor_range_block, (s, min(s + per, n), tuple(shape)))
            for s in builtins.range(0, n, per)]
    return Dataset(work)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    import builtins

    p = parallelism if parallelism > 0 else _auto_parallelism(
        max(1, len(items) // 100))
    per = max(1, -(-len(items) // p)) if items else 1
    work = [(None, (items[s:s + per],))
            for s in builtins.range(0, max(len(items), 1), per)]
    return Dataset(work)


def from_numpy(arr: np.ndarray, *, column: str = "data",
               parallelism: int = -1) -> Dataset:
    import builtins

    n = len(arr)
    p = parallelism if parallelism > 0 else _auto_parallelism(max(1, n // 1000))
    per = max(1, -(-n // p))
    work = [(None, ({column: arr[s:s + per]},))
            for s in builtins.range(0, n, per)]
    return Dataset(work)


def from_pandas(df) -> Dataset:
    return Dataset([(None, (df,))])


def from_arrow(table) -> Dataset:
    return Dataset([(None, (table,))])


# -------------------------------------------------------------------- reads #

Partitioning = _ds.Partitioning


def _file_work(paths, reader, *reader_args,
               partitioning: Optional["Partitioning"] = None,
               partition_filter=None):
    """Shared file-read planning: expand paths, apply the partition
    filter (on parsed partition dicts when a scheme is given, else on
    raw paths), and wrap the reader to attach partition columns
    (reference `file_based_datasource.py` + `partitioning.py`)."""
    import functools

    files = _ds.expand_paths(paths)
    if (partitioning is not None and partitioning.base_dir is None
            and isinstance(paths, str) and os.path.isdir(paths)):
        # Scope parsing to the read root: an ancestor directory that
        # happens to contain '=' (".../run=3/tbl/...") must not leak in
        # as a partition column.
        partitioning = _ds.Partitioning(
            partitioning.style, base_dir=paths,
            field_names=partitioning.field_names or None)
    if partition_filter is not None:
        if partitioning is not None:
            files = [f for f in files
                     if partition_filter(partitioning.parse(f))]
        else:
            files = [f for f in files if partition_filter(f)]
        if not files:
            raise FileNotFoundError(
                "partition_filter excluded every input file")
    if partitioning is not None:
        reader = functools.partial(_ds.partitioned_reader, reader)
        return [(reader, (f, partitioning) + reader_args) for f in files]
    return [(reader, (f,) + reader_args) for f in files]


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 partitioning: Optional["Partitioning"] = None,
                 partition_filter=None,
                 parallelism: int = -1) -> Dataset:
    return Dataset(_file_work(paths, _ds.read_parquet_file, columns,
                              partitioning=partitioning,
                              partition_filter=partition_filter))


def read_csv(paths, *, partitioning: Optional["Partitioning"] = None,
             partition_filter=None, parallelism: int = -1, **kw) -> Dataset:
    import functools

    reader = functools.partial(_ds.read_csv_file, **kw) if kw \
        else _ds.read_csv_file
    return Dataset(_file_work(paths, reader,
                              partitioning=partitioning,
                              partition_filter=partition_filter))


def read_json(paths, *, lines: bool = True,
              partitioning: Optional["Partitioning"] = None,
              partition_filter=None, parallelism: int = -1) -> Dataset:
    return Dataset(_file_work(paths, _ds.read_json_file, lines,
                              partitioning=partitioning,
                              partition_filter=partition_filter))


def read_text(paths, *, encoding: str = "utf-8",
              parallelism: int = -1) -> Dataset:
    files = _ds.expand_paths(paths)
    return Dataset([(_ds.read_text_file, (f, encoding)) for f in files])


def read_numpy(paths, *, parallelism: int = -1) -> Dataset:
    files = _ds.expand_paths(paths)
    return Dataset([(_ds.read_numpy_file, (f,)) for f in files])


def read_binary_files(paths, *, include_paths: bool = False,
                      parallelism: int = -1) -> Dataset:
    files = _ds.expand_paths(paths)
    return Dataset([(_ds.read_binary_file, (f, include_paths)) for f in files])


def read_tfrecords(paths, *, parallelism: int = -1) -> Dataset:
    """Raw TFRecord payloads as {"data": bytes} rows (framing + crc32c
    validated; no TensorFlow dependency)."""
    files = _ds.expand_paths(paths)
    return Dataset([(_ds.read_tfrecord_file, (f,)) for f in files])


def read_sql(sql: str, connection_factory, *, parallelism: int = -1
             ) -> Dataset:
    """One read task running `sql` through a DB-API connection factory
    (reference `ray.data.read_sql`)."""
    return Dataset([(_ds.read_sql_query, (sql, connection_factory))])


def read_images(paths, *, size=None, mode: Optional[str] = None,
                partitioning: Optional["Partitioning"] = None,
                partition_filter=None, parallelism: int = -1) -> Dataset:
    """Decoded images as {"image": ndarray, "path": str} rows."""
    return Dataset(_file_work(paths, _ds.read_image_file, size, mode,
                              partitioning=partitioning,
                              partition_filter=partition_filter))


def read_webdataset(paths, *, decode: bool = True,
                    parallelism: int = -1) -> Dataset:
    """WebDataset tar shards -> sample rows grouped by basename stem
    ({'__key__': ..., '<ext>': value}); one block per shard (reference
    `ray.data.read_webdataset`, standard tarfile — no webdataset dep)."""
    files = _ds.expand_paths(paths)
    return Dataset([(_ds.read_webdataset_shard, (f, decode))
                    for f in files])


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline=None, parallelism: int = -1) -> Dataset:
    """MongoDB collection rows (reference `ray.data.read_mongo`); needs
    pymongo at execution time."""
    return Dataset([(_ds.read_mongo_collection,
                     (uri, database, collection, pipeline))])


__all__ = [
    "ActorPoolStrategy", "Dataset", "DataIterator",
    "StreamSplitDataIterator", "DataContext",
    "BlockLineage", "ByteBudget", "ShardIterator",
    "Block", "BlockAccessor", "BlockMetadata",
    "range", "range_tensor", "from_items", "from_numpy", "from_pandas",
    "from_arrow", "read_parquet", "read_csv", "read_json", "read_text",
    "read_numpy", "read_binary_files", "read_tfrecords", "read_sql",
    "read_images", "read_webdataset", "read_mongo", "Partitioning",
]
