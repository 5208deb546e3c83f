"""The port's Data (`ray_tpu_torch.data`) on the CPU.

Three parts. The block functions (shuffle map/reduce, sort sampling and
range partition, join, partial and merged aggregates, `batch_blocks`) are
held against the JAX package's `ray_tpu.data` on the same numpy blocks
from a seed: the outputs must be equal, element for element, since both
do the same integer and float64 work in the same order. Then the
reference's runtime cases from tests/test_data.py, test_data_query.py,
test_data_streaming.py and test_data_partitioning.py, each under the name
of the reference test it mirrors, on one module-scoped port cluster (the
pandas and pyarrow cases skip where those are absent; the trainer cases
are in test_torch_train.py). Last, a seeded shuffle through both
runtimes in one process, and a node removed mid-shuffle that the pipeline
recovers from by recomputing.
"""

import gc
import os
import tarfile
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data
from ray_tpu_torch import data as rd
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.data import dataset as port_dataset
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.iterator import batch_blocks as port_batch_blocks
from ray_tpu_torch.data.query import aggregate as port_agg
from ray_tpu_torch.data.query import join as port_join
from ray_tpu_torch.data.query import sort as port_sort
from ray_tpu_torch.data.streaming import (BlockLineage, ByteBudget,
                                          ShardIterator)

from ray_tpu.data import dataset as ref_dataset
from ray_tpu.data.iterator import batch_blocks as ref_batch_blocks
from ray_tpu.data.query import aggregate as ref_agg
from ray_tpu.data.query import join as ref_join
from ray_tpu.data.query import sort as ref_sort


@pytest.fixture(scope="module", autouse=True)
def cluster():
    # A cluster rather than init(), so the lineage test can add and remove
    # nodes; the driver connects to its head (4 CPUs and one GPU, which
    # without a card is a grant only) as init() would.
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "num_gpus": 1})
    c.wait_for_nodes()
    c.connect()
    yield c
    c.shutdown()


# --------------------------------------------------------------------------- #
# Block functions against the JAX package's
# --------------------------------------------------------------------------- #


def _columnar(seed, n=40):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 9, size=n), "x": rng.normal(size=n),
            "v": np.arange(n)}


def _rows(seed, n=40):
    b = _columnar(seed, n)
    return [{"k": int(b["k"][i]), "x": float(b["x"][i]), "v": i}
            for i in range(n)]


def _assert_same(got, want):
    """Blocks (or tuples/lists of them) equal element for element."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("layout", ["columnar", "rows"])
@pytest.mark.parametrize("mode", ["random", "hash", "keyed"])
def test_shuffle_map_and_reduce_match_the_reference(layout, mode):
    make = _columnar if layout == "columnar" else _rows
    keys = {"random": (None, None), "hash": (lambda r: r["k"],) * 2,
            "keyed": (port_sort._RangePartitioner([2, 5], "k", False, 3),
                      ref_sort._RangePartitioner([2, 5], "k", False, 3))}
    port_key, ref_key = keys[mode]
    port_buckets, ref_buckets = [], []
    for salt in range(3):
        block = make(seed=salt)
        got = port_dataset._shuffle_map_block(block, 3, mode, 7, salt,
                                              port_key)
        want = ref_dataset._shuffle_map_block(make(seed=salt), 3, mode, 7,
                                              salt, ref_key)
        _assert_same(got, want)
        port_buckets.append(got)
        ref_buckets.append(want)
    for part in range(3):
        _assert_same(
            port_dataset._shuffle_reduce_blocks(
                mode, 7, part, *[b[part] for b in port_buckets]),
            ref_dataset._shuffle_reduce_blocks(
                mode, 7, part, *[b[part] for b in ref_buckets]))


def test_stable_key_hash_matches_the_reference():
    keys = [0, 7, np.int64(7), 7.0, True, "key-3", b"raw", (1, "a"),
            2 ** 40, None]
    assert [port_dataset._stable_key_hash(k) for k in keys] == \
        [ref_dataset._stable_key_hash(k) for k in keys]


@pytest.mark.parametrize("layout", ["columnar", "rows"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_sampling_and_partition_match_the_reference(layout,
                                                         descending):
    make = _columnar if layout == "columnar" else _rows
    samples = {"port": [], "ref": []}
    for salt in range(4):
        samples["port"] += port_sort._sample_block_keys(make(salt), 8, "k",
                                                        3, salt)
        samples["ref"] += ref_sort._sample_block_keys(make(salt), 8, "k", 3,
                                                      salt)
    assert samples["port"] == samples["ref"]
    bounds = port_sort.compute_boundaries(samples["port"], 4)
    assert bounds == ref_sort.compute_boundaries(samples["ref"], 4)
    port_part = port_sort._RangePartitioner(bounds, "k", descending, 4)
    ref_part = ref_sort._RangePartitioner(bounds, "k", descending, 4)
    block = make(9)
    if layout == "columnar":
        np.testing.assert_array_equal(port_part.assign_block(block),
                                      ref_part.assign_block(make(9)))
    else:
        assert [port_part(r) for r in block] == [ref_part(r) for r in block]
    _assert_same(
        port_sort.make_local_sort_transform("k", descending)(make(9)),
        ref_sort.make_local_sort_transform("k", descending)(make(9)))


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_partition_blocks_match_the_reference(how):
    left = _columnar(1, 30)
    right = [{"k": k, "r": 10 * k, "x": -1.0} for k in (0, 2, 2, 5, 11)]
    got = port_join.join_partition_blocks("k", "k", how, None, left, right)
    want = ref_join.join_partition_blocks("k", "k", how, None,
                                          _columnar(1, 30), right)
    assert got == want and len(got) > 0


@pytest.mark.parametrize("layout", ["columnar", "rows"])
def test_aggregates_match_the_reference(layout):
    make = _columnar if layout == "columnar" else _rows

    def aggs(mod):
        return [mod.Count(), mod.Sum("x"), mod.Mean("x"), mod.Min("v"),
                mod.Max("x")]

    partial = {"port": [], "ref": []}
    for seed in range(3):
        partial["port"] += port_agg.make_partial_transform(
            "k", aggs(port_agg))(make(seed))
        partial["ref"] += ref_agg.make_partial_transform(
            "k", aggs(ref_agg))(make(seed))
    assert partial["port"] == partial["ref"]
    got = port_agg.make_merge_transform("k", aggs(port_agg))(partial["port"])
    want = ref_agg.make_merge_transform("k", aggs(ref_agg))(partial["ref"])
    assert got == want and len(got) == 9


@pytest.mark.parametrize("batch_size", [1, 7, 16, 40])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_blocks_match_the_reference(batch_size, drop_last):
    def blocks():
        yield _columnar(0, 13)
        yield _rows(1, 0)
        yield _rows(2, 9)
        yield _columnar(3, 20)

    got = list(port_batch_blocks(blocks(), batch_size, drop_last))
    want = list(ref_batch_blocks(blocks(), batch_size, drop_last))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_same(g, w)


# --------------------------------------------------------------------------- #
# From tests/test_data.py
# --------------------------------------------------------------------------- #


def test_range_count_take():
    ds = rd.range(1000)
    assert ds.count() == 1000
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]

def test_map_filter_pipeline_fuses():
    ds = rd.range(100).map(lambda r: {"id": r["id"] * 2}) \
        .filter(lambda r: r["id"] % 4 == 0)
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == [i * 2 for i in range(100) if (i * 2) % 4 == 0]

def test_map_batches_numpy_format():
    ds = rd.range(64).map_batches(lambda b: {"sq": b["id"] ** 2})
    total = ds.sum("sq")
    assert total == sum(i * i for i in range(64))

def test_map_batches_with_batch_size():
    seen_sizes = []

    def record(batch):
        return {"n": np.array([len(batch["id"])])}

    ds = rd.range(100, parallelism=1).map_batches(record, batch_size=16)
    sizes = [r["n"] for r in ds.take_all()]
    assert all(s <= 16 for s in sizes)
    assert sum(sizes) > 0

def test_iter_batches_exact_sizes():
    ds = rd.range(100)
    batches = list(ds.iter_batches(batch_size=32))
    sizes = [len(b["id"]) for b in batches]
    assert sizes == [32, 32, 32, 4]
    assert sorted(np.concatenate([b["id"] for b in batches]).tolist()) == \
        list(range(100))
    batches = list(ds.iter_batches(batch_size=32, drop_last=True))
    assert [len(b["id"]) for b in batches] == [32, 32, 32]

def test_from_items_and_flat_map():
    ds = rd.from_items([1, 2, 3]).flat_map(lambda x: [x, x * 10])
    assert sorted(ds.take_all()) == [1, 2, 3, 10, 20, 30]

def test_repartition_and_union():
    ds = rd.range(90).repartition(3)
    assert ds.num_blocks() == 3
    assert ds.count() == 90
    u = rd.from_items([1]).union(rd.from_items([2]), rd.from_items([3]))
    assert sorted(u.take_all()) == [1, 2, 3]

def test_random_shuffle_preserves_rows():
    ds = rd.range(200).random_shuffle(seed=7)
    ids = [r["id"] for r in ds.take_all()]
    assert sorted(ids) == list(range(200))
    assert ids != list(range(200))

def test_split_balanced():
    parts = rd.range(100, parallelism=4).split(2)
    counts = [p.count() for p in parts]
    assert sum(counts) == 100
    assert all(c > 0 for c in counts)

def test_streaming_split_covers_all_rows():
    ds = rd.range(120, parallelism=6)
    it_a, it_b = ds.streaming_split(2)
    rows_a = [r["id"] for r in it_a.iter_rows()]
    rows_b = [r["id"] for r in it_b.iter_rows()]
    assert sorted(rows_a + rows_b) == list(range(120))
    # Second epoch works (re-executes).
    rows_a2 = [r["id"] for r in it_a.iter_rows()]
    rows_b2 = [r["id"] for r in it_b.iter_rows()]
    assert sorted(rows_a2 + rows_b2) == list(range(120))

def test_parquet_roundtrip(tmp_path):
    pytest.importorskip("pyarrow")
    ds = rd.range(50).map_batches(lambda b: {"id": b["id"],
                                             "x": b["id"] * 0.5})
    files = ds.write_parquet(str(tmp_path))
    assert files and all(os.path.exists(f) for f in files)
    back = rd.read_parquet(str(tmp_path))
    assert back.count() == 50
    assert back.sum("id") == sum(range(50))

def test_csv_and_json_roundtrip(tmp_path):
    pytest.importorskip("pandas")
    ds = rd.from_items([{"a": i, "b": f"s{i}"} for i in range(10)])
    csv_dir, json_dir = tmp_path / "csv", tmp_path / "json"
    ds.write_csv(str(csv_dir))
    ds.write_json(str(json_dir))
    assert rd.read_csv(str(csv_dir)).count() == 10
    back = rd.read_json(str(json_dir)).take_all()
    assert sorted(r["a"] for r in back) == list(range(10))

def test_text_and_numpy_reads(tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("hello\nworld\n\nfoo\n")
    ds = rd.read_text(str(p))
    assert ds.take_all() == ["hello", "world", "foo"]

    npy = tmp_path / "arr.npy"
    np.save(npy, np.arange(12).reshape(3, 4))
    nds = rd.read_numpy(str(npy))
    batch = next(nds.iter_batches(batch_size=10))
    assert batch["item"].shape == (3, 4)

def test_from_numpy_and_mean():
    arr = np.arange(100, dtype=np.float64)
    ds = rd.from_numpy(arr, column="x")
    assert ds.mean("x") == pytest.approx(49.5)
    assert ds.min("x") == 0 and ds.max("x") == 99

def test_to_pandas():
    pytest.importorskip("pandas")
    df = rd.range(10).to_pandas()
    assert list(df["id"]) == list(range(10))

def test_groupby_aggregations():
    ds = rd.from_items([{"g": i % 3, "v": float(i)} for i in range(30)])
    counts = {r["g"]: r["count()"] for r in ds.groupby("g").count().take_all()}
    assert counts == {0: 10, 1: 10, 2: 10}
    sums = {r["g"]: r["sum(v)"] for r in ds.groupby("g").sum("v").take_all()}
    assert sums[0] == sum(float(i) for i in range(0, 30, 3))
    means = {r["g"]: r["mean(v)"]
             for r in ds.groupby("g").mean("v").take_all()}
    assert abs(means[1] - np.mean([i for i in range(30) if i % 3 == 1])) < 1e-9
    mins = {r["g"]: r["min(v)"] for r in ds.groupby("g").min("v").take_all()}
    maxs = {r["g"]: r["max(v)"] for r in ds.groupby("g").max("v").take_all()}
    assert mins == {0: 0.0, 1: 1.0, 2: 2.0}
    assert maxs == {0: 27.0, 1: 28.0, 2: 29.0}
    # Results arrive sorted by key.
    assert [r["g"] for r in ds.groupby("g").count().take_all()] == [0, 1, 2]

def test_groupby_key_function_and_map_groups():
    ds = rd.from_items(list(range(20)))
    grouped = ds.groupby(lambda x: x % 2)
    out = grouped.map_groups(lambda rows: {"parity": rows[0] % 2,
                                           "total": sum(rows)})
    rows = sorted(out.take_all(), key=lambda r: r["parity"])
    assert rows == [{"parity": 0, "total": sum(range(0, 20, 2))},
                    {"parity": 1, "total": sum(range(1, 20, 2))}]

def test_zip_merges_rows():
    a = rd.from_items([{"x": i} for i in range(5)])
    b = rd.from_items([{"y": 10 * i} for i in range(5)])
    rows = a.zip(b).take_all()
    assert rows[3] == {"x": 3, "y": 30}
    # Collisions get the _1 suffix.
    c = rd.from_items([{"x": -i} for i in range(5)])
    rows = a.zip(c).take_all()
    assert rows[2] == {"x": 2, "x_1": -2}
    # Scalar rows pair into tuples; length mismatch is an error.
    assert rd.from_items([1, 2]).zip(rd.from_items([3, 4])).take_all() \
        == [(1, 3), (2, 4)]
    with pytest.raises(ValueError):
        rd.from_items([1, 2, 3]).zip(rd.from_items([1])).take_all()

def test_column_ops_and_unique():
    ds = rd.from_items([{"a": i, "b": i % 4} for i in range(12)])
    with_c = ds.add_column("c", lambda r: r["a"] * 2)
    assert with_c.take(1)[0] == {"a": 0, "b": 0, "c": 0}
    assert with_c.drop_columns(["a", "b"]).take(1) == [{"c": 0}]
    assert with_c.select_columns(["b"]).take(2) == [{"b": 0}, {"b": 1}]
    assert ds.unique("b") == [0, 1, 2, 3]

def test_groupby_none_values():
    """None = missing (reference ignore_nulls): sums/means skip Nones but
    count() still counts the rows."""
    ds = rd.from_items([{"g": 1, "v": None}, {"g": 1, "v": 2.0},
                        {"g": 2, "v": None}])
    assert ds.groupby("g").sum("v").take_all() == [
        {"g": 1, "sum(v)": 2.0}, {"g": 2, "sum(v)": None}]
    assert ds.groupby("g").mean("v").take_all() == [
        {"g": 1, "mean(v)": 2.0}, {"g": 2, "mean(v)": None}]
    assert ds.groupby("g").count().take_all() == [
        {"g": 1, "count()": 2}, {"g": 2, "count()": 1}]

def test_push_shuffle_preserves_rows_and_is_seeded():
    """random_shuffle runs as the two-stage push shuffle: rows preserved,
    order changed, deterministic per seed, no driver materialization of
    the whole dataset in one block."""
    ds = rd.from_items(list(range(200)))
    a = ds.random_shuffle(seed=7)
    rows_a = a.take_all()
    assert sorted(rows_a) == list(range(200))
    assert rows_a != list(range(200))
    assert a.num_blocks() == ds.num_blocks()  # partitions preserved
    b = ds.random_shuffle(seed=7).take_all()
    assert rows_a == b  # seeded determinism
    c = ds.random_shuffle(seed=8).take_all()
    assert rows_a != c

def test_repartition_shuffle():
    ds = rd.from_items(list(range(120)))
    out = ds.repartition(5, shuffle=True)
    assert out.num_blocks() == 5
    assert sorted(out.take_all()) == list(range(120))

def test_map_groups_equal_keys_across_types():
    """np.int64(1), 1 and 1.0 are one logical group: the hash partitioner
    must route them to the same partition (regression: pickle-based
    hashing split them)."""
    ds = rd.from_items([{"k": np.int64(1), "v": 1},
                        {"k": 1, "v": 10},
                        {"k": 1.0, "v": 100},
                        {"k": 2, "v": 5}])
    out = ds.groupby(lambda r: r["k"]).map_groups(
        lambda rows: {"k": rows[0]["k"], "total": sum(r["v"] for r in rows)})
    rows = sorted(out.take_all(), key=lambda r: float(r["k"]))
    assert [r["total"] for r in rows] == [111, 5]

def test_dataset_stats_per_op():
    """ds.stats() reports per-operator blocks/rows/wall after execution
    (reference Dataset.stats, data/_internal/stats.py)."""
    from ray_tpu_torch import data

    def double(r):
        return {"id": r["id"] * 2}

    ds = data.range(100, parallelism=4).map(double).filter(
        lambda r: r["id"] % 4 == 0)
    out = ds.materialize()
    assert sorted(r["id"] for r in out.take_all())[:3] == [0, 4, 8]
    stats = out.stats()
    assert stats is not None
    names = [op["name"] for op in stats.ops]
    assert any(n.startswith("Map(double)") for n in names), names
    assert any(n.startswith("Filter(") for n in names), names
    read_ops = [op for op in stats.ops if op["index"] == -1]
    assert read_ops and read_ops[0]["blocks"] == 4
    map_op = next(op for op in stats.ops if op["name"] == "Map(double)")
    assert map_op["rows"] == 100 and map_op["blocks"] == 4
    assert "blocks" in repr(stats) and "wall" in repr(stats)

def test_dataset_stats_disabled():
    from ray_tpu_torch import data
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    ctx.enable_stats = False
    try:
        ds = data.range(10, parallelism=2).map(lambda x: x)
        ds = ds.materialize()
        assert ds.stats() is None
    finally:
        ctx.enable_stats = True

# --------------------------------------------------------------------------- #
# From tests/test_data_query.py
# --------------------------------------------------------------------------- #


def _ref_sort(rows, key, descending=False):
    """Driver-side stable reference (what the distributed sort must
    reproduce row-for-row)."""
    keyf = key if callable(key) else (lambda r: r[key])
    return sorted(rows, key=keyf, reverse=descending)

@pytest.mark.parametrize("parallelism", [1, 3, 7])
@pytest.mark.parametrize("seed", [0, 11])
def test_sort_row_identity_across_partition_counts(parallelism, seed):
    rng = np.random.default_rng(seed)
    rows = [{"k": int(rng.integers(0, 20)), "v": i} for i in range(200)]
    ds = rd.from_items(rows, parallelism=parallelism).sort(key="k")
    got = ds.take_all()
    # Stable: equal keys keep input order — byte-for-byte row identity,
    # not just key order.
    assert got == _ref_sort(rows, "k")

def test_sort_descending_is_stable():
    rows = [{"k": i % 5, "v": i} for i in range(100)]
    ds = rd.from_items(rows, parallelism=4).sort(key="k", descending=True)
    assert ds.take_all() == _ref_sort(rows, "k", descending=True)

def test_sort_callable_key_and_plain_values():
    vals = [7, 3, 9, 1, 3, 8, 0, 5]
    ds = rd.from_items(vals, parallelism=3).sort(key=lambda x: -x)
    assert ds.take_all() == sorted(vals, reverse=True)
    # Plain comparable values need no key at all.
    assert rd.from_items(vals, parallelism=2).sort().take_all() == \
        sorted(vals)

def test_sort_string_keys_columnar_path():
    rows = [{"k": f"key-{i % 7:02d}", "v": i} for i in range(80)]
    ds = rd.from_items(rows, parallelism=4).sort(key="k")
    assert ds.take_all() == _ref_sort(rows, "k")

def test_sort_single_key_and_skew():
    # All-equal keys: one range partition swallows everything; output is
    # the input (stability) regardless of boundary degeneracy.
    rows = [{"k": 1, "v": i} for i in range(60)]
    assert rd.from_items(rows, parallelism=4).sort(key="k").take_all() \
        == rows
    # 90% of rows share one key: the skewed partition still sorts
    # correctly and equal keys never split across partitions.
    rng = np.random.default_rng(3)
    skewed = [{"k": 5 if rng.random() < 0.9 else int(rng.integers(0, 100)),
               "v": i} for i in range(300)]
    got = rd.from_items(skewed, parallelism=5).sort(key="k").take_all()
    assert got == _ref_sort(skewed, "k")

def test_sort_empty_dataset():
    assert rd.from_items([{"k": 1}]).filter(lambda r: False) \
        .sort(key="k").take_all() == []

def test_sort_driver_sample_bytes_bounded():
    """The driver's entire per-row footprint is the boundary sample —
    bounded by `query_sort_sample_rows`, measured and asserted, and the
    output is STILL row-identical (equal keys never split, local sorts
    are stable, so any sample draw yields the same global order)."""
    ctx = DataContext.get_current()
    old = ctx.sort_sample_rows
    try:
        ctx.sort_sample_rows = 32
        rows = [{"k": int(np.random.default_rng(9).integers(0, 50)),
                 "v": i} for i in range(5000)]
        ds = rd.from_items(rows, parallelism=8).sort(key="k")
        got = ds.take_all()
        assert got == _ref_sort(rows, "k")
        stats = ds.last_sort_stats
        assert 0 < stats["sample_rows"] <= 32
        # 32 int keys serialize well under this; 5000 rows would not.
        assert stats["driver_sample_bytes"] < 16 * 1024
        assert ds.last_shuffle_stats["input_blocks"] == 8
    finally:
        ctx.sort_sample_rows = old

def test_sort_chains_with_downstream_transforms():
    rows = [{"k": i % 4, "v": i} for i in range(40)]
    ds = rd.from_items(rows, parallelism=4).sort(key="k") \
        .map(lambda r: {"k": r["k"], "v2": r["v"] * 2})
    got = ds.take_all()
    assert got == [{"k": r["k"], "v2": r["v"] * 2}
                   for r in _ref_sort(rows, "k")]

@pytest.mark.parametrize("parallelism", [1, 4, 9])
def test_groupby_aggregate_matches_reference(parallelism):
    rng = np.random.default_rng(parallelism)
    rows = [{"g": int(rng.integers(0, 12)), "x": float(rng.normal())}
            for _ in range(300)]
    ds = rd.from_items(rows, parallelism=parallelism)
    got = {r["g"]: r for r in ds.groupby("g").sum("x").take_all()}
    keys = sorted({r["g"] for r in rows})
    assert sorted(got) == keys
    for k in keys:
        want = sum(r["x"] for r in rows if r["g"] == k)
        assert got[k]["sum(x)"] == pytest.approx(want)

def test_groupby_multi_aggregate_single_pass():
    from ray_tpu_torch.data.query import Count, Max, Mean, Min, Sum

    rows = [{"g": i % 3, "x": i} for i in range(30)]
    out = rd.from_items(rows, parallelism=4).groupby("g").aggregate(
        Count(), Sum("x"), Mean("x"), Min("x"), Max("x")).take_all()
    assert [r["g"] for r in out] == [0, 1, 2]
    for r in out:
        vals = [row["x"] for row in rows if row["g"] == r["g"]]
        assert r["count()"] == len(vals)
        assert r["sum(x)"] == sum(vals)
        assert r["mean(x)"] == pytest.approx(sum(vals) / len(vals))
        assert r["min(x)"] == min(vals)
        assert r["max(x)"] == max(vals)

def test_groupby_custom_aggregate_fn():
    from ray_tpu_torch.data.query import AggregateFn

    # Sum of squares as a UDF: init/accumulate/merge/finalize compose
    # through partial pre-aggregation exactly like the built-ins.
    sumsq = AggregateFn(
        init=lambda: 0.0,
        accumulate=lambda s, row: s + row["x"] ** 2,
        merge=lambda a, b: a + b,
        name="sumsq(x)")
    rows = [{"g": i % 4, "x": i} for i in range(40)]
    out = rd.from_items(rows, parallelism=5).groupby("g") \
        .aggregate(sumsq).take_all()
    for r in out:
        want = sum(row["x"] ** 2 for row in rows if row["g"] == r["g"])
        assert r["sumsq(x)"] == pytest.approx(want)

def test_groupby_single_key_and_empty():
    rows = [{"g": "only", "x": i} for i in range(25)]
    out = rd.from_items(rows, parallelism=4).groupby("g").count() \
        .take_all()
    assert out == [{"g": "only", "count()": 25}]
    empty = rd.from_items(rows).filter(lambda r: False) \
        .groupby("g").count().take_all()
    assert empty == []

def _ref_join(left, right, left_on, right_on, how):
    """Driver-side nested-loop reference with the zip() `_1` collision
    suffix contract."""
    out = []
    rcols = []
    for rrow in right:
        for c in rrow:
            if c not in rcols:
                rcols.append(c)
    for lrow in left:
        matches = [r for r in right if r[right_on] == lrow[left_on]]
        if not matches and how == "left":
            row = dict(lrow)
            for c in rcols:
                if c != right_on:
                    row[c + "_1" if c in lrow else c] = None
            out.append(row)
        for rrow in matches:
            row = dict(lrow)
            for c, v in rrow.items():
                if c == right_on:
                    continue
                row[c + "_1" if c in lrow else c] = v
            out.append(row)
    return out

def _rows_set(rows):
    return sorted(tuple(sorted(r.items())) for r in rows)

@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_hash_and_broadcast_row_identity(how):
    left = [{"id": i % 6, "lv": i} for i in range(40)]
    # Duplicate build keys (cartesian per key) + a key with no probe
    # match + a colliding non-key column name.
    right = [{"id": 0, "rv": 100, "lv": -1}, {"id": 0, "rv": 101},
             {"id": 2, "rv": 102}, {"id": 99, "rv": 103}]
    want = _rows_set(_ref_join(left, right, "id", "id", how))
    ctx = DataContext.get_current()
    old = ctx.broadcast_join_bytes
    try:
        lds = rd.from_items(left, parallelism=4)
        rds = rd.from_items(right, parallelism=2)
        ctx.broadcast_join_bytes = 1 << 30
        bds = lds.join(rds, on="id", how=how)
        assert _rows_set(bds.take_all()) == want
        assert bds.last_join_stats["strategy"] == "broadcast"

        ctx.broadcast_join_bytes = 0
        hds = lds.join(rds, on="id", how=how)
        assert _rows_set(hds.take_all()) == want
        assert hds.last_join_stats["strategy"] == "hash"
        assert hds.last_join_stats["left_shuffle"]["input_blocks"] > 0
    finally:
        ctx.broadcast_join_bytes = old

def test_join_build_side_exactly_at_threshold():
    """The strategy flips exactly at `query_broadcast_join_bytes`: a
    build side AT the threshold broadcasts, one byte under it forces the
    hash exchange — and both produce identical rows."""
    left = [{"id": i % 8, "lv": i} for i in range(64)]
    right = [{"id": i, "rv": i * 10} for i in range(8)]
    lds = rd.from_items(left, parallelism=4)
    rds = rd.from_items(right, parallelism=2)
    ctx = DataContext.get_current()
    old = ctx.broadcast_join_bytes
    try:
        probe = lds.join(rds, on="id")
        want = _rows_set(probe.take_all())
        build_bytes = probe.last_join_stats["build_bytes"]
        assert build_bytes > 0

        ctx.broadcast_join_bytes = build_bytes
        at = lds.join(rds, on="id")
        assert _rows_set(at.take_all()) == want
        assert at.last_join_stats["strategy"] == "broadcast"

        ctx.broadcast_join_bytes = build_bytes - 1
        under = lds.join(rds, on="id")
        assert _rows_set(under.take_all()) == want
        assert under.last_join_stats["strategy"] == "hash"
    finally:
        ctx.broadcast_join_bytes = old

def test_join_tuple_on_and_validation():
    left = [{"lid": i, "a": i * 2} for i in range(6)]
    right = [{"rid": i, "b": i * 3} for i in range(0, 12, 2)]
    out = rd.from_items(left, parallelism=2).join(
        rd.from_items(right, parallelism=2), on=("lid", "rid")) \
        .take_all()
    assert _rows_set(out) == _rows_set(
        _ref_join(left, right, "lid", "rid", "inner"))
    with pytest.raises(ValueError):
        rd.from_items(left).join(rd.from_items(right), on=("lid",))
    with pytest.raises(ValueError):
        rd.from_items(left).join(rd.from_items(right), on="lid",
                                 how="outer")

def test_join_empty_sides():
    left = [{"id": i} for i in range(5)]
    none = rd.from_items(left).filter(lambda r: False)
    assert rd.from_items(left).join(none, on="id").take_all() == []
    got = none.join(rd.from_items(left), on="id", how="inner").take_all()
    assert got == []

@pytest.fixture()
def tenant_cap():
    from ray_tpu_torch.data.streaming.budget import reset_tenant_stats

    ctx = DataContext.get_current()
    old_tenant = ctx.tenant
    GLOBAL_CONFIG._overrides["data_tenant_budget_bytes"] = 100
    reset_tenant_stats()
    try:
        yield ctx
    finally:
        ctx.tenant = old_tenant
        GLOBAL_CONFIG._overrides.pop("data_tenant_budget_bytes", None)
        reset_tenant_stats()

def test_tenant_cap_rejects_with_backpressure(tenant_cap):
    """Admission past the tenant cap is refused (visible in
    `tenant_stats`), spanning BUDGETS: two pipelines of one tenant share
    the cap even though each is under its own pipeline budget."""
    from ray_tpu_torch.data.streaming.budget import ByteBudget, tenant_stats

    tenant_cap.tenant = "tenant-a"
    a, b = ByteBudget(10_000), ByteBudget(10_000)
    assert a.try_acquire("map", 80)
    assert b.try_acquire("map", 15)  # 95 in flight: still under the cap
    assert not b.try_acquire("map", 50)  # would cross 100: refused
    st = tenant_stats()["tenant-a"]
    assert st["rejections"] >= 1
    assert st["bytes_in_flight"] == 95
    # Releasing in ONE budget unblocks the OTHER (same tenant).
    a.release("map", 80)
    assert b.try_acquire("map", 50)
    assert tenant_stats()["tenant-a"]["bytes_in_flight"] == 65

def test_tenant_progress_guarantee_never_deadlocks(tenant_cap):
    """A tenant with nothing in flight is ALWAYS admitted (even over the
    cap) — mirrors the per-op progress guarantee, so one oversized block
    degrades to window-at-a-time instead of wedging the pipeline."""
    from ray_tpu_torch.data.streaming.budget import ByteBudget

    tenant_cap.tenant = "tenant-big"
    b = ByteBudget(10_000)
    assert b.try_acquire("map", 5_000)  # 50x the cap: idle tenant admits
    assert not b.try_acquire("map", 1)  # now it waits like everyone
    b.release("map", 5_000)
    assert b.try_acquire("map", 1)

def test_tenant_blocking_acquire_wakes_on_cross_budget_release(tenant_cap):
    from ray_tpu_torch.data.streaming.budget import ByteBudget

    tenant_cap.tenant = "tenant-w"
    a, b = ByteBudget(10_000), ByteBudget(10_000)
    assert a.try_acquire("map", 90)
    done = []

    def blocked():
        done.append(b.acquire("map", 90, timeout=10.0))

    assert b.try_acquire("map", 5)  # b must have in-flight bytes to wait
    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.1)
    a.release("map", 90)  # cross-budget release, observed via the poll
    t.join(timeout=10.0)
    assert done == [True]

def test_tenant_resolution_defaults(tenant_cap, monkeypatch):
    from ray_tpu_torch.data.streaming.budget import ByteBudget

    monkeypatch.delenv("RAY_TPU_TORCH_JOB_ID", raising=False)
    tenant_cap.tenant = None
    assert ByteBudget(10).tenant == "default"
    monkeypatch.setenv("RAY_TPU_TORCH_JOB_ID", "job-42")
    assert ByteBudget(10).tenant == "job-42"
    tenant_cap.tenant = "explicit"
    assert ByteBudget(10).tenant == "explicit"

def test_tenant_cap_off_by_default(tenant_cap):
    from ray_tpu_torch.data.streaming.budget import ByteBudget, tenant_stats

    GLOBAL_CONFIG._overrides["data_tenant_budget_bytes"] = 0
    tenant_cap.tenant = "tenant-free"
    b = ByteBudget(10_000)
    assert b.try_acquire("map", 4_000)
    assert b.try_acquire("map", 4_000)  # no cap: only the budget gates
    # Bytes still tracked for observability even with the cap off.
    assert tenant_stats()["tenant-free"]["bytes_in_flight"] == 8_000

def test_iter_shards_locality_hit_accounting():
    """Single-node cluster, blocks past the 100 KiB inline threshold:
    every block the coordinator hands out is resident on the consumer's
    node, so the ingest stats must show hits and zero misses — and with
    routing off, the same handouts all count as misses."""
    ctx = DataContext.get_current()
    old = ctx.locality_routing
    try:
        # 4 blocks x 500 rows x 32 float64 = ~128 KiB each: real store
        # residency (inline blocks have no directory entry and would
        # honestly count as misses).
        ds = rd.range_tensor(2000, shape=(32,), parallelism=4) \
            .materialize()
        ctx.locality_routing = True
        shard, = rd.DataIterator(ds).iter_shards(1, prefetch=0)
        rows = sum(len(b["data"]) for b in shard.iter_batches(
            batch_size=500))
        assert rows == 2000
        stats = shard.ingest_stats()
        assert stats["locality_hits"] == 4
        assert stats["locality_misses"] == 0

        ctx.locality_routing = False
        shard2, = rd.DataIterator(ds).iter_shards(1, prefetch=0)
        rows = sum(len(b["data"]) for b in shard2.iter_batches(
            batch_size=500))
        assert rows == 2000
        stats2 = shard2.ingest_stats()
        assert stats2["locality_hits"] == 0
        assert stats2["locality_misses"] == 4
    finally:
        ctx.locality_routing = old

def test_split_coordinator_locality_never_starves():
    """Locality reorders the handout but every split still gets blocks
    and every block is handed out exactly once."""
    ds = rd.range_tensor(2000, shape=(32,), parallelism=4).materialize()
    it_a, it_b = ds.streaming_split(2)
    got_a = [b["data"].sum() for b in it_a.iter_batches(batch_size=500)]
    got_b = [b["data"].sum() for b in it_b.iter_batches(batch_size=500)]
    assert len(got_a) + len(got_b) == 4
    la, lb = it_a.locality_stats(), it_b.locality_stats()
    handed = (la["locality_hits"] + la["locality_misses"]
              + lb["locality_hits"] + lb["locality_misses"])
    assert handed == 4

_CHUNK = 128 * 1024

# --------------------------------------------------------------------------- #
# From tests/test_data_streaming.py
# --------------------------------------------------------------------------- #


def test_budget_admission_and_release():
    b = ByteBudget(100)
    assert b.try_acquire("map", 60)
    assert b.try_acquire("map", 30)
    # Over budget with bytes in flight: refused.
    assert not b.try_acquire("map", 30)
    b.release("map", 60)
    assert b.try_acquire("map", 30)
    stats = b.stats()
    assert stats["ops"]["map"]["blocks"] == 3
    assert stats["ops"]["map"]["bytes_hwm"] == 90
    assert stats["used_bytes"] == 60

def test_budget_progress_guarantee_admits_oversized_block():
    """A block larger than the whole budget must admit when the op has
    nothing in flight — degrade to window-at-a-time, never deadlock."""
    b = ByteBudget(10)
    assert b.try_acquire("map", 1000)
    assert not b.try_acquire("map", 1)  # now it has to wait
    b.release("map", 1000)
    assert b.try_acquire("map", 1)

def test_budget_cross_op_progress():
    """One op hogging the budget must not permanently starve another:
    the starved op (nothing in flight) is admitted over budget."""
    b = ByteBudget(100)
    assert b.try_acquire("map", 100)
    assert b.try_acquire("reduce", 50)  # progress guarantee
    assert not b.try_acquire("reduce", 10)

def test_budget_adjust_corrects_estimate():
    b = ByteBudget(100)
    b.try_acquire("map", 10)
    b.adjust("map", 40)  # sealed size turned out to be 50
    assert b.used == 50
    b.release("map", 50)
    assert b.used == 0

def test_budget_release_op_drains_charges_and_reset_drains_ledger():
    b = ByteBudget(100)
    b.try_acquire("map", 70)
    b.release_op("map")
    assert b.used == 0
    # The account survives for stats(); reset() is the full drain.
    assert b.stats()["ops"]["map"]["bytes_in_flight"] == 0
    b.reset()
    assert b.stats()["ops"] == {}

def test_budget_blocking_acquire_wakes_on_release():
    b = ByteBudget(100)
    assert b.acquire("map", 100)
    done = []

    def blocked():
        done.append(b.acquire("map", 50, timeout=5.0))

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.05)
    b.release("map", 100)
    t.join(timeout=5.0)
    assert done == [True]
    assert b.stats()["ops"]["map"]["blocked_s"] > 0

def test_budget_negotiated_respects_config():
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    ctx = DataContext.get_current()
    old = ctx.inflight_budget_bytes
    try:
        ctx.inflight_budget_bytes = 12345
        assert ByteBudget.negotiated().total == 12345
        # None = fall through to the GLOBAL_CONFIG flag (refresh()-aware
        # memoized read); explicit set wins over the default.
        ctx.inflight_budget_bytes = None
        GLOBAL_CONFIG.data_inflight_budget_bytes = 54321
        try:
            assert ByteBudget.negotiated().total == 54321
        finally:
            GLOBAL_CONFIG._overrides.pop("data_inflight_budget_bytes", None)
        # Flag default (0) = negotiate against the store: nonzero, and no
        # bigger than the store itself.
        negotiated = ByteBudget.negotiated().total
        assert negotiated >= 64 * 1024 * 1024
    finally:
        ctx.inflight_budget_bytes = old

def test_windowed_shuffle_matches_seeded_rows():
    """A tiny budget forces multiple windows; the row-level output must
    be IDENTICAL to the same seed under a huge budget (windowing is
    invisible to determinism)."""
    ctx = DataContext.get_current()
    old = ctx.inflight_budget_bytes
    try:
        ctx.inflight_budget_bytes = 1 << 30
        wide = rd.range(300, parallelism=6).random_shuffle(seed=11)
        rows_wide = [r["id"] for r in wide.take_all()]

        ctx.inflight_budget_bytes = 4096  # a few KB: forces windows
        narrow = rd.range(300, parallelism=6).random_shuffle(seed=11)
        rows_narrow = [r["id"] for r in narrow.take_all()]
        assert rows_narrow == rows_wide
        assert sorted(rows_narrow) == list(range(300))
        assert narrow.last_shuffle_stats["windows"] > 1
        assert wide.last_shuffle_stats["windows"] == 1
    finally:
        ctx.inflight_budget_bytes = old

def test_windowed_shuffle_reexecutes_per_epoch():
    """Re-iterating a shuffled dataset RE-WINDOWS (re-runs the exchange)
    instead of reusing materialized refs — multi-epoch ingest must not
    pin the whole dataset."""
    ds = rd.range(120, parallelism=4).random_shuffle(seed=3)
    first = [r["id"] for r in ds.iter_rows()]
    stats_first = dict(ds.last_shuffle_stats)
    second = [r["id"] for r in ds.iter_rows()]
    assert sorted(first) == sorted(second) == list(range(120))
    assert first == second  # seeded: epochs agree
    assert ds._materialized_refs is None
    assert ds.last_shuffle_stats["input_blocks"] == \
        stats_first["input_blocks"]
    # materialize() still pins an epoch when asked.
    mat = ds.materialize()
    assert mat._materialized_refs is not None

def test_shuffle_backpressure_accounting():
    ctx = DataContext.get_current()
    old = ctx.inflight_budget_bytes
    try:
        ctx.inflight_budget_bytes = 4096
        ds = rd.range(200, parallelism=4).random_shuffle(seed=5)
        assert sorted(r["id"] for r in ds.take_all()) == list(range(200))
        stats = ds.stats()
        bp = stats.backpressure
        assert bp is not None
        # Stage ledger keys are instance-unique ("ShuffleMap#<n>") so
        # sibling executions sharing a budget can't cross-release.
        shuffle_ops = {op: acct for op, acct in bp["ops"].items()
                       if op.startswith("Shuffle")}
        assert shuffle_ops, bp["ops"]
        assert all(acct["bytes_in_flight"] == 0
                   for acct in shuffle_ops.values())
        assert any(acct["blocks"] > 0 for acct in bp["ops"].values())
        assert "backpressure" in repr(stats)
    finally:
        ctx.inflight_budget_bytes = old

def test_map_pipeline_budget_accounting():
    ds = rd.range(100, parallelism=4).map(lambda r: {"id": r["id"] + 1})
    assert ds.count() == 100
    bp = ds.stats().backpressure
    assert bp is not None and bp["total_bytes"] > 0
    (op_name, acct), = [kv for kv in bp["ops"].items()]
    assert acct["blocks"] == 4
    assert acct["bytes_in_flight"] == 0  # everything released

def test_shuffle_mixed_block_representations():
    """A union of columnar and row parents shuffles correctly: the
    columnar fast path's dict buckets must expand to ROWS in a mixed
    reduce partition (regression: extending the raw dict spliced column
    names into the data)."""
    cols = rd.from_numpy(np.arange(40, dtype=np.int64), column="id")
    rows = rd.from_items([{"id": int(i)} for i in range(40, 60)])
    out = cols.union(rows).random_shuffle(seed=6)
    got = sorted(int(r["id"]) for r in out.iter_rows())
    assert got == list(range(60))

def test_lineage_recompute_is_bounded():
    import ray_tpu_torch

    def make_block(lo, hi):
        return [{"id": i} for i in range(lo, hi)]

    lineage = BlockLineage(max_recomputes_per_block=2)
    ref = ray_tpu_torch.remote(make_block).remote(0, 5)
    lineage.record(ref, make_block, (0, 5), [])
    assert len(lineage) == 1
    new_ref = lineage.recompute(ref)
    assert ray_tpu_torch.get(new_ref) == make_block(0, 5)
    acct = lineage.accounting()
    assert acct["dataplane_recomputed_blocks"] == 1
    # Attempt budget: the same recipe re-runs at most max_recomputes.
    newer = lineage.recompute(new_ref)
    from ray_tpu_torch.exceptions import ObjectLostError

    with pytest.raises(ObjectLostError):
        lineage.recompute(newer)
    lineage.clear()
    assert len(lineage) == 0

def test_lineage_registry_is_bounded():
    """Recipes pin their ref args, so the registry is a bounded FIFO —
    a ref-taking consumer can't pin a whole epoch of intermediates."""
    class _FakeRef:
        def __init__(self, i):
            self.object_id = type("_O", (), {
                "binary": staticmethod(lambda i=i: b"%08d" % i)})()

    lineage = BlockLineage(max_recomputes_per_block=1)
    for i in range(BlockLineage.MAX_RECORDS + 40):
        lineage.record(_FakeRef(i), None, (i,), [])
    assert len(lineage) == BlockLineage.MAX_RECORDS

def test_executor_records_replayable_lineage_only():
    """Recipes with ObjectRef args are the core tier's business (data-tier
    records would pin upstream blocks); ref-free recipes are recorded
    while the execution runs and drain when it finishes."""
    ds = rd.range(60, parallelism=3).map(lambda r: {"id": r["id"]})
    seen = []
    for _ in ds._iter_block_refs():
        seen.append(len(ds._lineage))
    assert max(seen) > 0  # read recipes (range args) were recorded
    assert len(ds._lineage) == 0  # cleared with the execution

def _slow_blocks(n, delay_s, rows_per_block=8):
    for b in range(n):
        time.sleep(delay_s)
        yield {"id": np.arange(b * rows_per_block,
                               (b + 1) * rows_per_block)}

class _SlowSource:
    """Iterable block source with a per-block production delay."""

    def __init__(self, n, delay_s):
        self.n = n
        self.delay_s = delay_s

    def __iter__(self):
        return _slow_blocks(self.n, self.delay_s)

def test_shard_iterator_accounts_stall_and_steps():
    it = ShardIterator(_SlowSource(6, 0.01), prefetch=2)
    batches = list(it.iter_batches(batch_size=8))
    assert len(batches) == 6
    stats = it.ingest_stats()
    assert stats["steps"] == 6
    assert stats["epochs"] == 1
    assert stats["prefetch_depth"] == 2
    assert 0.0 <= stats["stall_frac"] <= 1.0
    assert stats["stall_ms_total"] >= 0.0

def test_shard_iterator_prefetch_hides_producer_latency():
    """Double-buffered prefetch overlaps block production with the
    consuming step: stall with prefetch on must undercut prefetch off
    (the A/B the ingest bench gates on)."""
    def consume(prefetch):
        it = ShardIterator(_SlowSource(10, 0.02), prefetch=prefetch)
        for _ in it.iter_batches(batch_size=8):
            time.sleep(0.02)  # the "step"
        return it.ingest_stats()

    stalled = consume(prefetch=0)
    overlapped = consume(prefetch=2)
    assert overlapped["stall_ms_total"] < stalled["stall_ms_total"], \
        (overlapped, stalled)

def test_shard_iterator_abandoned_consumer_reaps_pump():
    """Breaking out of iter_batches early (max_steps) must not leak the
    prefetch thread: even the terminal sentinel put yields to stop()."""
    before = {t.name for t in threading.enumerate()}
    it = ShardIterator(_SlowSource(4, 0.0), prefetch=1)
    for _ in it.iter_batches(batch_size=8):
        break  # abandon with the producer parked on a full queue
    deadline = time.monotonic() + 6
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t.name == "ingest-prefetch" and t.name not in before]
        if not leaked:
            break
        time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t.name == "ingest-prefetch"], "prefetch thread leaked"

def test_shard_iterator_multi_epoch_and_pickle():
    ds = rd.range(64, parallelism=4)
    shard_a, shard_b = rd.DataIterator(ds).iter_shards(2, prefetch=2)
    import cloudpickle

    shard_b = cloudpickle.loads(cloudpickle.dumps(shard_b))  # ships to a worker
    rows_a = [r["id"] for r in shard_a.iter_rows()]
    rows_b = [r["id"] for r in shard_b.iter_rows()]
    assert sorted(rows_a + rows_b) == list(range(64))
    # Second epoch re-drives the shared execution.
    rows_a2 = [r["id"] for r in shard_a.iter_rows()]
    rows_b2 = [r["id"] for r in shard_b.iter_rows()]
    assert sorted(rows_a2 + rows_b2) == list(range(64))
    assert shard_a.ingest_stats()["epochs"] == 2

def test_stats_collector_mailbox_bounded_and_prunes():
    from ray_tpu_torch.data.stats import _StatsCollector

    c = _StatsCollector()
    # Keyed state is capped: a sender inventing unbounded op names
    # degrades to a drop counter, not unbounded actor memory.
    for i in range(c.MAX_OP_ENTRIES + 50):
        c.record([(0, f"op{i}", 0.001, 1)])
    summary = c.summary()
    assert len(summary["ops"]) == c.MAX_OP_ENTRIES
    assert summary["dropped_records"] == 50
    # Finished-op prune: per-window stage records fold into one rollup.
    c2 = _StatsCollector()
    for w in range(5):
        c2.record_stage([(-2, f"ShuffleMap[window {w}]", 0.1, 10)])
    assert len(c2.summary()["ops"]) == 5
    c2.fold(-2, "ShuffleMap")
    ops = c2.summary()["ops"]
    assert len(ops) == 1
    assert ops[0]["name"] == "ShuffleMap"
    assert ops[0]["blocks"] == 5 and ops[0]["rows"] == 50
    # record_stage never inflates the blocks_recorded flush barrier.
    assert c2.summary()["blocks_recorded"] == 0

def test_shuffle_stage_records_fold_into_rollup():
    ctx = DataContext.get_current()
    old = ctx.inflight_budget_bytes
    try:
        ctx.inflight_budget_bytes = 4096  # multiple windows
        ds = rd.range(300, parallelism=6).random_shuffle(seed=4)
        assert ds.count() == 300
        stats = ds.stats()
        assert stats is not None
        names = [op["name"] for op in stats.ops]
        assert "ShuffleMap" in names
        assert "ShuffleReduce" in names
        # Per-window records were pruned after the fold.
        assert not any("window" in n for n in names), names
    finally:
        ctx.inflight_budget_bytes = old

# --------------------------------------------------------------------------- #
# From tests/test_data_partitioning.py
# --------------------------------------------------------------------------- #


def _write_partitioned_csv(base):
    import pandas as pd

    for year, country, vals in [("2023", "de", [1, 2]),
                                ("2023", "us", [3]),
                                ("2024", "de", [4, 5, 6])]:
        d = os.path.join(base, f"year={year}", f"country={country}")
        os.makedirs(d, exist_ok=True)
        pd.DataFrame({"v": vals}).to_csv(os.path.join(d, "part.csv"),
                                         index=False)

def test_partitioning_parse_hive_and_dir(tmp_path):
    p = data.Partitioning("hive")
    assert p.parse("/x/year=2024/country=de/f.parquet") == {
        "year": "2024", "country": "de"}
    assert p.parse("/plain/path/f.parquet") == {}

    p2 = data.Partitioning("dir", field_names=["year", "country"])
    assert p2.parse("/data/2024/de/f.csv") == {"year": "2024",
                                               "country": "de"}
    with pytest.raises(ValueError, match="field_names"):
        data.Partitioning("dir")
    with pytest.raises(ValueError, match="style"):
        data.Partitioning("banana")

def test_read_csv_hive_partitioned(tmp_path):
    pytest.importorskip("pandas")
    base = str(tmp_path / "tbl")
    _write_partitioned_csv(base)
    ds = data.read_csv(base, partitioning=data.Partitioning("hive"))
    rows = ds.take_all()
    assert len(rows) == 6
    assert all({"v", "year", "country"} <= set(r.keys()) for r in rows)
    de_2024 = [r["v"] for r in rows
               if r["year"] == "2024" and r["country"] == "de"]
    assert sorted(de_2024) == [4, 5, 6]

def test_partition_filter_prunes_files(tmp_path):
    pytest.importorskip("pandas")
    base = str(tmp_path / "tbl")
    _write_partitioned_csv(base)
    ds = data.read_csv(
        base, partitioning=data.Partitioning("hive"),
        partition_filter=lambda parts: parts.get("year") == "2023")
    rows = ds.take_all()
    assert sorted(r["v"] for r in rows) == [1, 2, 3]
    with pytest.raises(FileNotFoundError, match="partition_filter"):
        data.read_csv(base, partitioning=data.Partitioning("hive"),
                      partition_filter=lambda parts: False)

def test_webdataset_round_trip(tmp_path):
    shard_dir = str(tmp_path / "wds")
    rows = [{"__key__": f"{i:04d}", "txt": f"hello {i}", "cls": i,
             "json": {"idx": i}, "flag": bool(i % 2)} for i in range(10)]
    ds = data.from_items(rows, parallelism=2)
    shards = ds.write_webdataset(shard_dir)
    assert len(shards) == 2
    assert all(tarfile.is_tarfile(s) for s in shards)

    back = data.read_webdataset(os.path.join(shard_dir, "*.tar"))
    got = sorted(back.take_all(), key=lambda r: r["__key__"])
    assert len(got) == 10
    assert got[3]["txt"] == "hello 3"
    assert got[3]["cls"] == 3
    assert got[3]["json"] == {"idx": 3}
    assert got[3]["flag"] == b"1"  # bools write as ints (cls-decodable)

def test_read_mongo_gated():
    try:
        import pymongo  # noqa: F401

        pytest.skip("pymongo installed; the import gate cannot fire "
                    "(and no mongod is available to connect to)")
    except ImportError:
        pass
    ds = data.read_mongo("mongodb://localhost", "db", "coll")
    with pytest.raises(Exception, match="pymongo"):
        ds.take_all()

# --------------------------------------------------------------------------- #
# Both runtimes side by side; a node removed mid-shuffle
# --------------------------------------------------------------------------- #


def test_seeded_shuffle_under_both_packages():
    # The JAX package's cluster and the port's up at once in this process:
    # the same seeded shuffle gives the same rows in the same order, since
    # both scatter and permute with the same numpy generators and seeds.
    import ray_tpu
    from ray_tpu import data as jrd

    items = [{"id": i, "x": i * 0.5} for i in range(300)]
    ray_tpu.init(num_cpus=2)
    try:
        want = jrd.from_items(items, parallelism=4).random_shuffle(
            seed=7).take_all()
    finally:
        ray_tpu.shutdown()
    got = rd.from_items(items, parallelism=4).random_shuffle(
        seed=7).take_all()
    assert got == want
    assert got != items and sorted(r["id"] for r in got) == list(range(300))


class _Where:
    """A pool actor's UDF: each row with the cards its process sees."""

    def __call__(self, batch):
        n = len(batch["id"])
        return dict(batch, pool=np.full(
            n, os.environ.get("CUDA_VISIBLE_DEVICES", "unset")))


def test_pool_actors_take_with_resources_and_reads_stay_on_cpu():
    # The scoring pattern of BatchPredictor on one card: with_resources on
    # the actor-pool stage grants its actors the GPU, while the upstream
    # read tasks (the stage's parent) keep running on CPU workers, which
    # see no card.
    def where_read(batch):
        return dict(batch, reader=np.full(
            len(batch["id"]), os.environ.get("CUDA_VISIBLE_DEVICES",
                                             "unset")))

    ds = rd.range(64, parallelism=4).map_batches(where_read)
    out = ds.map_batches(_Where, batch_size=8,
                         compute=port_dataset.ActorPoolStrategy(size=1)) \
        .with_resources(num_gpus=1).take_all()
    assert sorted(r["id"] for r in out) == list(range(64))
    assert {str(r["pool"]) for r in out} == {"0"}
    assert {str(r["reader"]) for r in out} == {""}


def test_node_removed_mid_shuffle_recovers_by_recompute(cluster):
    # Two worker nodes hold every task of the pipeline (the "churn"
    # resource pins them there); the one holding the most blocks is
    # removed after the second batch. The epoch completes with every row
    # once, the lost blocks are recomputed, and no more than the removed
    # node's resident blocks plus one per partition are.
    from ray_tpu_torch.data.streaming.lineage import core_reconstructions

    nodes = [cluster.add_node(num_cpus=2, resources={"churn": 4})
             for _ in range(2)]
    cluster.wait_for_nodes()
    try:
        n_parts = 4
        # 500 rows x 40 float64 a block: past the 100 KiB inline
        # threshold, so blocks are store state on the worker nodes.
        ds = rd.range_tensor(2000, shape=(40,), parallelism=n_parts) \
            .with_resources(num_cpus=1, resources={"churn": 1}) \
            .random_shuffle(seed=9)
        base = core_reconstructions()
        seen = []
        removed = {}
        for i, batch in enumerate(ds.iter_batches(batch_size=250)):
            seen.append(batch["data"][:, 0])
            if i == 1:
                victim = max(nodes, key=lambda r:
                             r.store.stats()["num_objects"])
                removed["resident"] = victim.store.stats()["num_objects"]
                cluster.remove_node(victim)
                nodes.remove(victim)
        ids = np.sort(np.concatenate(seen))
        np.testing.assert_array_equal(ids, np.arange(2000, dtype=np.float64))
        recomputed = core_reconstructions() - base + (
            ds._lineage.recomputed_blocks if ds._lineage else 0)
        assert removed["resident"] > 0
        assert 1 <= recomputed <= removed["resident"] + n_parts, \
            (recomputed, removed)
        for raylet in cluster.raylets:
            assert raylet.store.stats()["num_unsealed"] == 0
    finally:
        for node in nodes:
            cluster.remove_node(node)
