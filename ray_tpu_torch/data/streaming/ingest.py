"""Train ingest: per-host double-buffered prefetch with step-stall accounting.

A training step that waits on its next batch burns accelerator time; the
contract of this module is that input never stalls the step. A
`ShardIterator` wraps one consumer's view of a streaming execution (a
`StreamSplitDataIterator` from `streaming_split`, or a whole-dataset
iterator) and:

- runs a PREFETCH thread that pulls the next `data_prefetch_shards` blocks
  (default 2 — double buffering) into a bounded queue ahead of the
  consumer. The pull is `ray_tpu_torch.get` on this host, so the block rides the
  transfer plane's location-aware pipelined pull straight into the local
  store BEFORE the step needs it (locality routing is the transfer
  plane's: pulls stripe across every node holding a copy);
- accounts every batch handed out: `stall_ms` (time the consumer waited on
  the queue — input-bound time) vs `step_ms` (time between batch requests
  — compute time), so `ingest_stats()` answers "is input stalling the
  step" with numbers (`stall_frac` < 0.10 is the bound the ingest
  benchmark holds);
- re-windows on re-iteration: a second epoch re-drives the shared
  streaming execution (the split coordinator bumps its epoch and the
  windowed shuffle re-runs) instead of re-materializing the dataset.

Picklable: prefetch state is created lazily on first iteration, so a
ShardIterator ships to a train worker and runs its prefetch thread there
(per-host buffering, not driver-side).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.iterator import batch_blocks, send_frees_now

_END = object()


class _IngestClock:
    """Stall/step accounting for one consumer.

    The FIRST batch of an epoch is accounted separately
    (`first_batch_ms`): nothing can overlap a pipeline's cold start, so
    folding it into stall would misattribute fill latency as per-step
    input starvation. `stall_frac` is the steady-state number — the one
    the "input never stalls the step" contract gates on."""

    def __init__(self):
        self.steps = 0
        self.stall_ms_total = 0.0
        self.step_ms_total = 0.0
        self.first_batch_ms = 0.0
        self._epoch_first = True
        self._last_yield: Optional[float] = None

    def epoch(self):
        self._epoch_first = True
        self._last_yield = None

    def request(self) -> float:
        now = time.perf_counter()
        if self._last_yield is not None:
            self.step_ms_total += (now - self._last_yield) * 1000.0
        return now

    def delivered(self, t_request: float):
        now = time.perf_counter()
        waited = (now - t_request) * 1000.0
        if self._epoch_first:
            self.first_batch_ms += waited
            self._epoch_first = False
        else:
            self.stall_ms_total += waited
        self.steps += 1
        self._last_yield = now

    def stats(self) -> Dict[str, Any]:
        busy = self.stall_ms_total + self.step_ms_total
        steady = max(0, self.steps - 1)
        return {
            "steps": self.steps,
            "stall_ms_total": round(self.stall_ms_total, 3),
            "step_ms_total": round(self.step_ms_total, 3),
            "first_batch_ms": round(self.first_batch_ms, 3),
            "stall_ms_per_step": round(
                self.stall_ms_total / steady, 3) if steady else 0.0,
            "stall_frac": round(self.stall_ms_total / busy, 4) if busy
            else 0.0,
        }


class ShardIterator:
    """Prefetching, stall-accounting view of a stream of blocks."""

    def __init__(self, source: Any, prefetch: Optional[int] = None):
        self._source = source
        self._prefetch = prefetch
        self._clock = _IngestClock()
        self._epochs = 0

    # ------------------------------------------------------------- plumbing

    def _resolved_prefetch(self) -> int:
        if self._prefetch is not None:
            return self._prefetch
        from ray_tpu_torch.data.context import DataContext

        return DataContext.get_current().resolved_prefetch_shards()

    def _source_blocks(self) -> Iterator[Any]:
        src = self._source
        if hasattr(src, "_iter_blocks"):        # StreamSplitDataIterator
            return src._iter_blocks()
        if hasattr(src, "_iter_block_values"):  # Dataset
            return src._iter_block_values()
        return iter(src)

    def _pumped(self, make_iter) -> Iterator[Any]:
        """Items from `make_iter()`, produced ahead by the prefetch
        thread. The bounded queue IS the double buffer (budget: the
        producer parks on put() when the consumer falls behind; depth =
        prefetch knob) and drains to termination on both normal
        exhaustion and generator close. Everything upstream of the queue
        — the coordinator round trip, the transfer-plane pull AND the
        block->batch conversion — overlaps with the consumer's step."""
        depth = self._resolved_prefetch()
        if depth <= 0:
            yield from make_iter()
            return
        buf: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def _put(item) -> bool:
            """Stop-aware bounded put — EVERY producer write, including
            the terminal sentinel and the error relay, must yield to an
            abandoned consumer's stop() or the thread (and its pinned
            blocks) leaks past the join."""
            while not stop.is_set():
                try:
                    buf.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def _pump():
            try:
                for item in make_iter():
                    if not _put(item):
                        return
                _put(_END)
            except BaseException as e:  # noqa: BLE001 — surface to consumer
                _put(e)

        thread = threading.Thread(target=_pump, name="ingest-prefetch",
                                  daemon=True)
        thread.start()
        try:
            while True:
                item = buf.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=5.0)
            # The epoch's handout replies carry its blocks' refs; a loop
            # that stops after N steps may end its process next.
            send_frees_now()

    def _iter_blocks(self) -> Iterator[Any]:
        self._epochs += 1
        yield from self._pumped(self._source_blocks)

    # ------------------------------------------------------------ consumers

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False,
                     prefetch_batches: Optional[int] = None
                     ) -> Iterator[Dict[str, Any]]:
        if prefetch_batches is not None:
            self._prefetch = prefetch_batches
        self._epochs += 1
        clock = self._clock
        clock.epoch()
        batches = self._pumped(
            lambda: batch_blocks(self._source_blocks(), batch_size,
                                 drop_last))
        while True:
            t_req = clock.request()
            try:
                batch = next(batches)
            except StopIteration:
                return
            clock.delivered(t_req)
            yield batch

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_blocks():
            yield from BlockAccessor(block).rows()

    # ----------------------------------------------------------- accounting

    def ingest_stats(self) -> Dict[str, Any]:
        out = self._clock.stats()
        out["epochs"] = self._epochs
        out["prefetch_depth"] = self._resolved_prefetch()
        # Locality routing outcome of the underlying split (coordinator
        # handed blocks already resident on this node vs remote pulls);
        # absent for sources that don't track it.
        src = self._source
        if hasattr(src, "locality_stats"):
            out.update(src.locality_stats())
        return out

    def split_stats(self) -> Dict[str, Any]:
        """The shared execution's accounting (`_SplitCoordinator.stats`:
        epoch, locality, the shuffle's windows and bytes) for a split
        source; empty for other sources."""
        stats_fn = getattr(self._source, "split_stats", None)
        return stats_fn() if stats_fn is not None else {}

    def close(self) -> None:
        """Release the source's shared execution, where it has one (a
        split's coordinator); the driver calls it when training ends."""
        close = getattr(self._source, "close", None)
        if close is not None:
            close()

    def __reduce__(self):
        return (ShardIterator, (self._source, self._prefetch))


def iter_shards(dataset, n: int, *, prefetch: Optional[int] = None,
                equal: bool = False) -> List[ShardIterator]:
    """n coordinated prefetching shards over ONE shared streaming
    execution — the train ingest entry point (`DataIterator.iter_shards`)."""
    splits = dataset.streaming_split(n, equal=equal)
    return [ShardIterator(s, prefetch) for s in splits]
