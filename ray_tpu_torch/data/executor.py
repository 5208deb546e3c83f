"""Streaming executor: pull-based block pipeline with byte-budget backpressure.

Equivalent of the reference's `StreamingExecutor`
(`python/ray/data/_internal/execution/streaming_executor.py:48` and the
control loop in `streaming_executor_state.py:259-364`), redesigned around
this framework's one-hop task dispatch:

- consecutive 1:1 block transforms are FUSED into one remote call per block
  (the reference's operator fusion rule), so a read->map->filter pipeline
  costs one task per block;
- at most `max_tasks_in_flight_per_op` tasks run concurrently, and the
  pipeline's in-flight OUTPUT is bounded in BYTES, not blocks: every
  submission charges the execution's ByteBudget with the op's moving size
  estimate (corrected to the sealed size once the directory knows it) and
  the pump stalls while the pipeline is over budget — see
  ray_tpu_torch/data/streaming/budget.py for the budget model and the per-op
  backpressure accounting surfaced by `ds.stats()`;
- blocks are yielded as ObjectRefs in SUBMISSION order (streaming, like
  the reference's ordered bundles): consumers start before the read
  finishes and iteration order is deterministic;
- each submitted block records its lineage recipe (producer, args, fused
  transforms), so a lost block recomputes instead of failing the pipeline
  (streaming/lineage.py; ref-valued args stay pinned until delivery —
  that is the recovery window).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)


def _fused_apply(fns, producer, *args):
    """Remote body: run the producer (read task or identity on a block),
    then thread the block through every fused transform."""
    block = producer(*args) if producer is not None else args[0]
    for fn in fns:
        block = fn(block)
    return block


def _fused_apply_stats(fns, collector, producer, *args):
    """Stats-collecting remote body: same as _fused_apply, plus one
    fire-and-forget per-op timing record to the collector actor (whose
    keyed state is bounded — see data/stats.py)."""
    from ray_tpu_torch.data.stats import timed_apply

    block, records = timed_apply(fns, producer, args)
    try:
        collector.record.remote(records)
    except Exception:  # noqa: BLE001 — stats must never fail the block
        pass
    return block


class StreamingExecutor:
    """Pumps (producer, args) work items through fused transforms."""

    def __init__(self, transforms: List[Callable],
                 max_in_flight: Optional[int] = None,
                 max_buffered: Optional[int] = None,
                 resources: Optional[dict] = None,
                 stats_collector: Optional[Any] = None,
                 lineage: Optional[Any] = None,
                 op_name: Optional[str] = None):
        from ray_tpu_torch.data.context import DataContext

        ctx = DataContext.get_current()
        self._transforms = transforms
        self._max_in_flight = max_in_flight or ctx.max_tasks_in_flight_per_op
        self._max_buffered = max_buffered or ctx.max_buffered_blocks_per_op
        self._resources = resources
        self._stats = stats_collector
        self._lineage = lineage
        from ray_tpu_torch.data.streaming.budget import unique_op

        self._op = unique_op(op_name or (
            "+".join(getattr(fn, "_op_name", None)
                     or getattr(fn, "__name__", "fn")
                     for fn in transforms) if transforms else "Read"))
        self._est_bytes = float(ctx.target_min_block_size)
        self.last_budget_stats: Optional[dict] = None

    def _observe_size(self, budget, charged: int, ref) -> int:
        """Correct the in-flight charge to the sealed size and feed the
        op's size estimate (EMA) for future admissions."""
        from ray_tpu_torch.data.streaming.shuffle import _block_size

        actual = _block_size(ref)
        if actual is None:
            return charged
        self._est_bytes = 0.8 * self._est_bytes + 0.2 * actual
        budget.adjust(self._op, actual - charged)
        return actual

    def execute(self, work: Iterator[Tuple[Optional[Callable], tuple]]
                ) -> Iterator[Any]:
        """work: iterator of (producer, args). Yields block ObjectRefs in
        submission order (streaming)."""
        import ray_tpu_torch
        from ray_tpu_torch.data.streaming.budget import pipeline_budget

        if self._stats is not None:
            base = ray_tpu_torch.remote(_fused_apply_stats)
            extra = (self._stats.actor,)
        else:
            base = ray_tpu_torch.remote(_fused_apply)
            extra = ()
        remote_fn = base.options(**self._resources) if self._resources \
            else base

        with pipeline_budget() as budget:
            try:
                yield from self._pump(budget, remote_fn, extra, iter(work))
            finally:
                budget.release_op(self._op)
                self.last_budget_stats = budget.stats()

    def _pump(self, budget, remote_fn, extra, work_iter) -> Iterator[Any]:
        import time as _time

        import ray_tpu_torch

        in_flight: dict = {}          # ref -> (submission index, charge)
        buffered: dict = {}           # submission index -> (ref, charge)
        submitted = 0
        emit = 0                      # next index to yield (ordered)
        exhausted = False
        blocked_since: Optional[float] = None
        pending: Optional[tuple] = None  # work item awaiting admission
        while True:
            # Submit while under the task cap; the byte budget is the
            # primary backpressure. try_acquire + drain-on-refusal: a
            # blocking acquire here would deadlock the single-threaded
            # pump (its own yield path is what releases charges).
            while (not exhausted and len(in_flight) < self._max_in_flight
                   and len(buffered) + len(in_flight) < self._max_buffered):
                if pending is None:
                    try:
                        pending = next(work_iter)
                    except StopIteration:
                        exhausted = True
                        break
                charge = int(self._est_bytes)
                if not budget.try_acquire(self._op, charge):
                    if blocked_since is None:
                        blocked_since = _time.perf_counter()
                    break  # over budget: drain/yield below, retry after
                if blocked_since is not None:
                    budget.note_blocked(
                        self._op, _time.perf_counter() - blocked_since)
                    blocked_since = None
                producer, args = pending
                pending = None
                ref = remote_fn.remote(self._transforms, *extra,
                                       producer, *args)
                if self._lineage is not None:
                    # Ref-valued args stay pinned by the recipe until the
                    # block is delivered (resolve() forgets on success) —
                    # the recovery window for a dependency dying under a
                    # "completed" task.
                    self._lineage.record(ref, producer, args,
                                         self._transforms)
                in_flight[ref] = (submitted, charge)
                submitted += 1
            # Yield strictly in submission order (the reference's streaming
            # executor preserves block order): later-finished blocks buffer
            # until their predecessors emit — iteration is deterministic.
            if emit in buffered:
                ref, charge = buffered.pop(emit)
                budget.release(self._op, charge)
                yield ref
                emit += 1
                continue
            if not in_flight:
                if exhausted and not buffered:
                    return
                if not buffered:
                    continue
            ready, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                    timeout=10.0)
            for r in ready:
                idx, charge = in_flight.pop(r)
                buffered[idx] = (r, self._observe_size(budget, charge, r))


def apply_transforms_local(transforms: List[Callable], block: Any) -> Any:
    for fn in transforms:
        block = fn(block)
    return block
