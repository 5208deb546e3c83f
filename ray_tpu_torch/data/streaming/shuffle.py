"""Windowed push shuffle: all-to-all under a byte budget.

A one-shot `Dataset._push_shuffle` materialized every parent block, then
submitted ALL map tasks and ALL reduce tasks at once — fine for toy data,
an OOM for a working set past memory, and a whole-pipeline restart if any
of it died. This module re-runs the same two-stage exchange (reference
`push_based_shuffle.py`) as a *windowed* streaming plan:

- **Map windows.** Parent blocks stream in (never materialized as a list)
  and are grouped into windows whose estimated bytes fit a slice of the
  pipeline's ByteBudget. A window's scatter tasks run with budget-charged
  admission and the next window starts only once the previous window's
  outputs are SEALED — sealed buckets are spillable, so a shuffle whose
  working set exceeds memory degrades into windows that flow through the
  object store's disk tier instead of OOMing. Unsealed (in-flight) bytes
  stay bounded by the budget at all times.
- **Reduce.** After the map barrier (inherent to all-to-all), each output
  partition's buckets concat-reduce with bounded in-flight admission;
  partitions yield in order and their bucket refs drop as soon as the
  reduce lands (eager free of intermediates).
- **Recovery.** Every map/reduce task spec is retained by the owner, so a
  node death mid-shuffle recomputes only the lost partitions through the
  core lineage tier (`runtime._try_reconstruct`) — bounded by the dead
  node's resident block count, never a restart. `BlockLineage.accounting`
  reads the recompute evidence.

Row-level output is IDENTICAL to the unwindowed exchange for a given
(mode, seed): scatter draws are salted by each block's global index and
reduces by partition index, so windowing is invisible to determinism.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterator, List, Optional

logger = logging.getLogger(__name__)


def _block_size(ref: Any) -> Optional[int]:
    """Best-effort sealed size of a completed block: the owner's own
    completion record first (free — the worker pushed it with the
    result), the object directory as fallback. Never on the per-block
    hot path unless the local record is missing."""
    import ray_tpu_torch

    runtime = getattr(ray_tpu_torch, "_global_runtime", None)
    if runtime is None:
        return None
    size = runtime.local_result_size(ref.object_id)
    if size:
        return size
    try:
        entry = runtime.gcs.call("object_locations_get",
                                 {"object_id": ref.object_id}, timeout=5)
    except Exception:  # noqa: BLE001 — size is an estimate, never fatal
        return None
    if not entry.get("known"):
        return None
    return int(entry["size"]) or None


def iter_shuffled_refs(parent_refs: Iterator[Any], n_out: int, *,
                       mode: str, seed: Optional[int],
                       key_fn: Optional[Callable],
                       budget, stage_stats=None,
                       stats: Optional[Dict[str, Any]] = None,
                       resources: Optional[Dict[str, Any]] = None,
                       lineage=None) -> Iterator[Any]:
    """Run the windowed two-stage exchange; yields reduce-output refs in
    partition order. `stats` (optional dict) is filled with window/bytes
    accounting; `stage_stats` (optional CollectorHandle) receives
    per-window stage records, folded into one rollup per stage at the
    end (finished-window records are pruned, not retained). `lineage`
    (optional BlockLineage) records each reduce partition's recipe —
    bucket refs included — so a partition whose node dies recomputes
    bottom-up instead of failing the epoch."""
    import ray_tpu_torch
    from ray_tpu_torch.data.context import DataContext
    from ray_tpu_torch.data.dataset import (_shuffle_map_block,
                                      _shuffle_reduce_blocks)

    from ray_tpu_torch.data.streaming.budget import unique_op

    ctx = DataContext.get_current()
    op_map = unique_op("ShuffleMap")
    op_red = unique_op("ShuffleReduce")
    max_in_flight = ctx.max_tasks_in_flight_per_op
    est_default = ctx.target_min_block_size
    window_bytes = max(budget.total // 4, 1)
    smap = ray_tpu_torch.remote(_shuffle_map_block)
    sred = ray_tpu_torch.remote(_shuffle_reduce_blocks)
    if resources:
        # Stage tasks honor Dataset.with_resources like fused tasks do.
        smap = smap.options(**resources)
        sred = sred.options(**resources)

    import time as _time

    buckets: List[List[Any]] = [[] for _ in range(n_out)]
    in_flight: Dict[Any, int] = {}   # sentinel ref -> charged bytes
    windows = 0
    cur_bytes = 0
    cur_blocks = 0
    total_bytes = 0
    total_blocks = 0
    win_t0 = _time.perf_counter()

    def _complete(refs):
        for r in refs:
            budget.release(op_map, in_flight.pop(r))

    def _drain(to: int):
        while len(in_flight) > to:
            ready, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                    timeout=30.0)
            _complete(ready)

    def _close_window():
        nonlocal windows, cur_bytes, cur_blocks, win_t0
        _drain(0)  # window barrier: outputs sealed => spillable
        if stage_stats is not None:
            stage_stats.record_stage(
                [(-2, f"ShuffleMap[window {windows}]",
                  _time.perf_counter() - win_t0, cur_blocks)])
        windows += 1
        cur_bytes = 0
        cur_blocks = 0
        win_t0 = _time.perf_counter()

    def _admit(op: str, size: int, drain) -> None:
        """try_acquire + drain-on-refusal (a blocking acquire would
        deadlock the single-threaded stage driver — its own drain is what
        releases charges). The budget's progress guarantee admits once
        the op has nothing charged, so this terminates."""
        t0 = None
        while not budget.try_acquire(op, size):
            if t0 is None:
                t0 = _time.perf_counter()
            drain()
        if t0 is not None:
            budget.note_blocked(op, _time.perf_counter() - t0)

    try:
        for salt, ref in enumerate(parent_refs):
            size = _block_size(ref) or est_default
            if cur_blocks and cur_bytes + size > window_bytes:
                _close_window()
            _admit(op_map, size,
                   lambda: _drain(max(0, len(in_flight) - 1)))
            out = smap.options(num_returns=n_out).remote(
                ref, n_out, mode, seed, salt, key_fn)
            outs = [out] if n_out == 1 else list(out)
            for j, b in enumerate(outs):
                buckets[j].append(b)
            in_flight[outs[0]] = size
            cur_bytes += size
            cur_blocks += 1
            total_bytes += size
            total_blocks += 1
            _drain(max_in_flight - 1)
        if cur_blocks:
            _close_window()
    finally:
        # Error paths must not leave charges behind (the budget may be
        # shared by sibling stages of the same execution).
        _drain(0)
        budget.release_op(op_map)

    if stats is not None:
        stats.update({"windows": windows, "input_blocks": total_blocks,
                      "input_bytes": total_bytes,
                      "window_bytes": window_bytes})
    if stage_stats is not None:
        stage_stats.fold(-2, "ShuffleMap")

    # ---- reduce: bounded in-flight, yield in partition order -------------
    # Locality routing: each partition's reduce concats buckets already
    # scattered across the cluster — pin it (softly) to the node holding
    # the most bucket bytes so the concat reads shared memory instead of
    # dragging buckets over the wire. Advisory: any directory miss falls
    # back to default placement (query/locality.py).
    from ray_tpu_torch.data.query import locality
    route_reduces = ctx.resolved_locality_routing()
    est_part = max(total_bytes // max(1, n_out), 1)
    reduce_in_flight: Dict[Any, int] = {}  # ref -> partition index
    ready_parts: Dict[int, Any] = {}
    emit = 0
    red_t0 = _time.perf_counter()

    def _reap(block: bool):
        while reduce_in_flight:
            ready, _ = ray_tpu_torch.wait(list(reduce_in_flight), num_returns=1,
                                    timeout=30.0 if block else 0.0)
            for r in ready:
                j = reduce_in_flight.pop(r)
                ready_parts[j] = r
                buckets[j] = []  # intermediates freed as soon as consumed
            if ready or not block:
                return

    next_submit = 0
    t_blocked = None
    try:
        while emit < n_out:
            # Yield ready partitions in order FIRST: the yield is what
            # releases their charges, so it must never sit behind a
            # refused admission.
            if emit in ready_parts:
                yield ready_parts.pop(emit)
                budget.release(op_red, est_part)
                emit += 1
                continue
            if (next_submit < n_out
                    and len(reduce_in_flight) < max_in_flight
                    and budget.try_acquire(op_red, est_part)):
                if t_blocked is not None:
                    budget.note_blocked(
                        op_red, _time.perf_counter() - t_blocked)
                    t_blocked = None
                part_buckets = buckets[next_submit]
                sred_part = sred
                if route_reduces and part_buckets:
                    opts = locality.reduce_affinity(part_buckets)
                    if opts is not None:
                        # .options() merges, so resources survive the pin.
                        sred_part = sred.options(**opts)
                red_ref = sred_part.remote(mode, seed, next_submit,
                                           *part_buckets)
                if lineage is not None:
                    lineage.record(
                        red_ref, _shuffle_reduce_blocks,
                        (mode, seed, next_submit, *part_buckets), [])
                reduce_in_flight[red_ref] = next_submit
                next_submit += 1
                continue
            if next_submit < n_out and t_blocked is None \
                    and len(reduce_in_flight) < max_in_flight:
                t_blocked = _time.perf_counter()  # refusal was the budget's
            _reap(block=True)
    finally:
        budget.release_op(op_red)
        if stage_stats is not None:
            stage_stats.record_stage(
                [(-3, "ShuffleReduce", _time.perf_counter() - red_t0,
                  n_out)])
