"""Data iterators: batching, prefetch, and coordinated streaming splits.

Equivalent of the reference's `DataIterator` (`python/ray/data/iterator.py`),
the prefetching batcher (`_internal/block_batching/iter_batches.py`) and
`StreamSplitDataIterator` (`_internal/iterator/stream_split_iterator.py:41`):
`streaming_split(n)` starts ONE coordinator actor that drives a single
streaming execution and hands blocks to whichever consumer asks first, so
fast train workers pull more data instead of idling on a static shard.
"""

from __future__ import annotations

import gc
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import BlockAccessor


def batch_blocks(blocks: Iterator[Any], batch_size: int,
                 drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Re-chunk a stream of blocks into exact-size numpy-dict batches."""
    carry: Optional[Dict[str, np.ndarray]] = None
    for block in blocks:
        batch = BlockAccessor(block).to_batch()
        if not batch or len(next(iter(batch.values()))) == 0:
            continue
        if carry is not None:
            batch = {k: np.concatenate([carry[k], batch[k]]) for k in batch}
            carry = None
        n = len(next(iter(batch.values())))
        start = 0
        while n - start >= batch_size:
            yield {k: v[start:start + batch_size] for k, v in batch.items()}
            start += batch_size
        if start < n:
            carry = {k: v[start:] for k, v in batch.items()}
    if carry is not None and not drop_last:
        yield carry


def send_frees_now() -> None:
    """Send this process's pending frees now rather than on the owner's
    batching timer, for a process that may end before the timer fires:
    blocks it owns, or borrows through the refs its objects carry, would
    then stay in the store."""
    import ray_tpu_torch

    runtime = getattr(ray_tpu_torch, "_global_runtime", None)
    if runtime is not None:
        runtime._flush_free_buffer()


class DataIterator:
    """Per-consumer view of a Dataset (whole dataset, no split)."""

    def __init__(self, dataset):
        self._dataset = dataset

    def iter_batches(self, *, batch_size: int = 256, drop_last: bool = False,
                     prefetch_batches: int = 1
                     ) -> Iterator[Dict[str, np.ndarray]]:
        yield from batch_blocks(self._dataset._iter_block_values(),
                                batch_size, drop_last)

    def iter_rows(self) -> Iterator[Any]:
        yield from self._dataset.iter_rows()

    def iter_shards(self, n: int, *, prefetch: Optional[int] = None,
                    equal: bool = False) -> List["Any"]:
        """n coordinated per-host shards over ONE shared streaming
        execution, each double-buffer-prefetching `prefetch` blocks
        (default `data_prefetch_shards`) ahead of its consumer with
        step-stall accounting — the train ingest path (see
        ray_tpu_torch/data/streaming/ingest.py)."""
        from ray_tpu_torch.data.streaming.ingest import iter_shards

        return iter_shards(self._dataset, n, prefetch=prefetch, equal=equal)

    def materialize(self):
        return self._dataset.materialize()


class _SplitCoordinator:
    """Actor driving one streaming execution for n consumers.

    Blocks are handed out first-come-first-served; `equal` slices each block
    so no consumer can run ahead by more than one block.

    Locality-aware handout: the coordinator keeps a small lookahead of
    produced refs and, when a consumer identifies its node, prefers a
    ref ALREADY RESIDENT there (one batched directory RPC over the
    lookahead — the consumer's pull then reads local shared memory
    instead of the wire). Any consumer still receives SOME block on
    every call — locality reorders the handout, it never starves a
    split — and every block is handed out exactly once.
    """

    _LOOKAHEAD = 4

    def __init__(self, ds_blob: bytes, n: int, equal: bool):
        import cloudpickle

        self._ds = cloudpickle.loads(ds_blob)
        self._n = n
        self._equal = equal
        self._epoch = -1
        self._iter: Optional[Iterator[Any]] = None
        self._ahead: List[Any] = []
        self._locality = {"locality_hits": 0, "locality_misses": 0}
        self._lock = threading.Lock()

    def _pick_local(self, node_hex: Optional[str]):
        """(lookahead index, is_local) of a block resident on the
        consumer's node; (0, False) — FIFO head, counted as a miss —
        when nothing is local or locations are unknown. The routing
        knob is NOT re-checked here: it resolves on the CONSUMER
        (see StreamSplitDataIterator._iter_blocks — a consumer with
        routing off advertises no node), because this actor may run in
        a reused worker process whose DataContext carries another
        consumer's override. One batched directory RPC over the whole
        lookahead."""
        if not node_hex or not self._ahead:
            return 0, False
        from ray_tpu_torch.data.query import locality

        for i, entry in enumerate(locality.locations_batch(self._ahead)):
            if entry.get("known") and node_hex in (entry.get("nodes") or ()):
                return i, True
        return 0, False

    def next_block(self, split_id: int, epoch: int,
                   node_hex: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            if self._ds is None:  # released
                return {"end": True}
            if epoch > self._epoch:
                self._epoch = epoch
                # Hand out REFS, not values: the consumer pulls the block
                # to ITS host over the transfer plane's location-aware
                # pipelined pull (locality routing), instead of every
                # block transiting this actor's response path by value.
                self._iter = self._ds._iter_block_refs()
                self._ahead = []
            if epoch < self._epoch or self._iter is None:
                return {"end": True}
            while len(self._ahead) < self._LOOKAHEAD:
                try:
                    self._ahead.append(next(self._iter))
                except StopIteration:
                    break
            if not self._ahead:
                return {"end": True}
            idx, local = self._pick_local(node_hex)
            self._locality[
                "locality_hits" if local else "locality_misses"] += 1
            return {"ref": self._ahead.pop(idx), "local": local}

    def release(self) -> None:
        """Close the shared execution and drop the blocks held for it
        (the lookahead, and whatever the pipeline has in flight), so this
        actor, their owner, frees them; a consumer still asking gets the
        end of its epoch."""
        with self._lock:
            it, self._iter, self._ahead = self._iter, None, []
            # A barrier dataset (a union, a materialized parent) caches
            # the refs of its inputs: drop the dataset too, keeping only
            # what stats() reports.
            self._shuffle = dict(
                getattr(self._ds, "last_shuffle_stats", None) or {})
            self._ds = None
        if it is not None:
            it.close()
        # The pipeline's generators and closures hold refs in cycles, and
        # close() ends this actor next.
        gc.collect()
        send_frees_now()

    def stats(self) -> Dict[str, Any]:
        """Epoch, handout locality, and the pipeline's shuffle accounting
        (windows, bytes) when the split dataset ends in a shuffle."""
        shuffle = (self._shuffle if self._ds is None else
                   getattr(self._ds, "last_shuffle_stats", None))
        return {"epoch": self._epoch, "n": self._n, **self._locality,
                "shuffle": dict(shuffle or {})}


class StreamSplitDataIterator:
    """One of n coordinated consumers; picklable (ships to train workers)."""

    def __init__(self, coordinator, split_id: int, n: int):
        self._coordinator = coordinator
        self._split_id = split_id
        self._n = n
        self._epoch = 0
        # This consumer's view of the coordinator's routing decisions:
        # a hit = the handed block was already resident on this node
        # (the pull below reads shared memory, not the wire).
        self._locality = {"locality_hits": 0, "locality_misses": 0}

    def locality_stats(self) -> Dict[str, int]:
        return dict(self._locality)

    def split_stats(self) -> Dict[str, Any]:
        """The coordinator's accounting of the shared execution (one
        round trip): see `_SplitCoordinator.stats`."""
        import ray_tpu_torch

        return ray_tpu_torch.get(self._coordinator.stats.remote())

    def close(self) -> None:
        """Release the shared execution and the blocks it holds, then end
        the coordinator (a graceful exit, which sends its pending frees).
        Every split of the dataset shares it: closing one closes all, and
        closing again does nothing."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import RayActorError

        try:
            ray_tpu_torch.get(self._coordinator.release.remote())
        except RayActorError:
            return  # closed through another split
        self._coordinator.__ray_terminate__()

    def iter_batches(self, *, batch_size: int = 256, drop_last: bool = False,
                     prefetch_batches: int = 1
                     ) -> Iterator[Dict[str, np.ndarray]]:
        yield from batch_blocks(self._iter_blocks(), batch_size, drop_last)

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_blocks():
            yield from BlockAccessor(block).rows()

    def _iter_blocks(self) -> Iterator[Any]:
        import ray_tpu_torch
        from ray_tpu_torch.data.query import locality

        epoch = self._epoch
        self._epoch += 1
        # Identify this node ONCE per epoch; the coordinator then hands
        # this consumer blocks already resident here when it can. The
        # routing knob is resolved HERE (consumer side) — the
        # coordinator may run in another process whose DataContext never
        # saw a driver-side override; not advertising a node disables
        # routing for this consumer regardless of where the coordinator
        # lives.
        from ray_tpu_torch.data.context import DataContext

        node_hex = (locality.local_node_hex()
                    if DataContext.get_current().resolved_locality_routing()
                    else None)
        while True:
            resp = ray_tpu_torch.get(
                self._coordinator.next_block.remote(self._split_id, epoch,
                                                    node_hex))
            if resp.get("end"):
                return
            if "ref" in resp:
                self._locality[
                    "locality_hits" if resp.get("local")
                    else "locality_misses"] += 1
                # Locality pull: materialize on THIS host via the
                # transfer plane (chunked, striped across holders) — a
                # hit short-circuits to a local shared-memory read.
                yield ray_tpu_torch.get(resp["ref"])
            else:
                yield resp["block"]

    def __reduce__(self):
        return (StreamSplitDataIterator,
                (self._coordinator, self._split_id, self._n))


def make_streaming_splits(dataset, n: int, equal: bool = False
                          ) -> List[StreamSplitDataIterator]:
    import cloudpickle

    import ray_tpu_torch

    blob = cloudpickle.dumps(dataset)
    coordinator = ray_tpu_torch.remote(_SplitCoordinator).options(
        max_concurrency=max(2, n)).remote(blob, n, equal)
    return [StreamSplitDataIterator(coordinator, i, n) for i in range(n)]
