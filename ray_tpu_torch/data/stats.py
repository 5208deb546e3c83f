"""Per-operator execution stats for Dataset pipelines.

Equivalent of the reference's `python/ray/data/_internal/stats.py`
(`DatasetStats` + the `_StatsActor` aggregation): every fused remote
block task times its producer and each transform, then pushes one
fire-and-forget per-op timing record to a zero-CPU collector actor; after an
execution `ds.stats()` renders a per-operator wall/rows/blocks summary
for diagnosing pipeline bottlenecks.

Boundedness (the RL011-style audit of this module): the collector is a
long-lived actor fed fire-and-forget by every worker, so BOTH of its keyed
stores are bounded. The op table caps at `MAX_OP_ENTRIES` — a sender
inventing unbounded op names (or a bug tagging records per block) degrades
to a `dropped_records` counter instead of unbounded actor memory — and
transient per-window stage records (the windowed shuffle emits one entry
per window while it runs, for live visibility) are PRUNED when the stage
finishes: `fold()` collapses them into one rollup entry, so finished ops
leave nothing behind.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple


def block_rows(block: Any) -> int:
    """Best-effort row count of a block (list, dict-of-columns, ndarray,
    DataFrame)."""
    try:
        if isinstance(block, dict):
            return len(next(iter(block.values()))) if block else 0
        return len(block)
    except TypeError:
        return 1


class _StatsCollector:
    """Zero-CPU actor accumulating (op_index, op_name, wall_s, rows)
    records; one batched push per executed block. Keyed state is bounded:
    see the module docstring."""

    MAX_OP_ENTRIES = 512

    def __init__(self):
        # (index, name) -> [blocks, rows_out, wall_s]
        self._ops: Dict[Tuple[int, str], List[float]] = {}
        self._batches = 0  # record() calls == executed blocks
        self._dropped = 0  # records refused by the op-entry cap
        self._started = time.time()

    def _add(self, entries: List[Tuple[int, str, float, int]]):
        for idx, name, wall, rows in entries:
            key = (idx, name)
            agg = self._ops.get(key)
            if agg is None:
                if len(self._ops) >= self.MAX_OP_ENTRIES:
                    self._dropped += 1
                    continue
                agg = self._ops[key] = [0, 0, 0.0]
            agg[0] += 1
            agg[1] += rows
            agg[2] += wall

    def record(self, entries: List[Tuple[int, str, float, int]]):
        self._batches += 1
        self._add(entries)

    def record_stage(self, entries: List[Tuple[int, str, float, int]]):
        """Driver-side stage records (shuffle windows): aggregated like
        record() but NOT counted as an executed block — stats() flush
        barriers compare blocks_recorded against executed blocks only."""
        self._add(entries)

    def fold(self, index: int, rollup_name: str):
        """Prune finished-op records: collapse every entry at `index`
        into one `(index, rollup_name)` rollup. The per-window entries a
        running stage emitted disappear; their sums survive."""
        dead = [k for k in self._ops if k[0] == index and k[1] != rollup_name]
        if not dead:
            return
        agg = self._ops.setdefault((index, rollup_name), [0, 0, 0.0])
        for key in dead:
            b, r, w = self._ops.pop(key)
            agg[0] += b
            agg[1] += r
            agg[2] += w

    def summary(self) -> Dict[str, Any]:
        ops = [{"index": idx, "name": name, "blocks": int(b),
                "rows": int(r), "wall_s": w}
               for (idx, name), (b, r, w) in sorted(self._ops.items())]
        return {"ops": ops, "blocks_recorded": self._batches,
                "dropped_records": self._dropped,
                "elapsed_s": time.time() - self._started}


class CollectorHandle:
    """Shared ownership wrapper: datasets (and their materialized
    derivatives) hold this; when the last holder is garbage-collected a
    weakref finalizer kills the actor — per-execution collectors would
    otherwise leak one worker process per epoch."""

    def __init__(self, actor):
        self.actor = actor

    def record_stage(self, entries):
        try:
            self.actor.record_stage.remote(entries)
        except Exception:  # noqa: BLE001 — stats must never fail the stage
            pass

    def fold(self, index: int, rollup_name: str):
        try:
            self.actor.fold.remote(index, rollup_name)
        except Exception:  # noqa: BLE001
            pass


class DatasetStats:
    """Rendered summary handed back by `ds.stats()`."""

    def __init__(self, summary: Dict[str, Any],
                 backpressure: Optional[Dict[str, Any]] = None):
        self._summary = summary
        self._backpressure = backpressure

    @property
    def ops(self) -> List[Dict[str, Any]]:
        return self._summary["ops"]

    @property
    def backpressure(self) -> Optional[Dict[str, Any]]:
        """Per-op byte-budget accounting of the LAST execution (None when
        the pipeline ran without a budget): blocks admitted, bytes
        high-water mark, and seconds blocked on the budget — the op with
        the largest blocked_s is where the pipeline is bound."""
        return self._backpressure

    def __repr__(self) -> str:
        lines = ["Dataset execution stats:"]
        for op in self.ops:
            wall = op["wall_s"]
            per_block = wall / op["blocks"] if op["blocks"] else 0.0
            lines.append(
                f"  {op['name']}: {op['blocks']} blocks, "
                f"{op['rows']} rows, {wall:.3f}s wall "
                f"({per_block * 1000:.1f}ms/block)")
        if self._summary.get("dropped_records"):
            lines.append(
                f"  (dropped {self._summary['dropped_records']} records "
                "past the op-entry cap)")
        bp = self._backpressure
        if bp and bp.get("ops"):
            lines.append(
                f"  backpressure (budget {bp['total_bytes']} bytes, "
                f"bound: {bp.get('bound_op')}):")
            for op, acct in sorted(bp["ops"].items()):
                lines.append(
                    f"    {op}: {acct['blocks']} blocks, "
                    f"hwm {acct['bytes_hwm']} bytes, "
                    f"blocked {acct['blocked_s']:.3f}s")
        lines.append(f"  total elapsed: {self._summary['elapsed_s']:.3f}s")
        return "\n".join(lines)


def timed_apply(fns: List[Any], producer, args: tuple
                ) -> Tuple[Any, List[Tuple[int, str, float, int]]]:
    """Run producer + fused transforms, timing each op. Returns the
    final block and the per-op records for this block."""
    records: List[Tuple[int, str, float, int]] = []
    t0 = time.perf_counter()
    block = producer(*args) if producer is not None else args[0]
    if producer is not None:
        records.append(
            (-1, getattr(producer, "_op_name", None)
             or f"Read({getattr(producer, '__name__', 'producer')})",
             time.perf_counter() - t0, block_rows(block)))
    for i, fn in enumerate(fns):
        t1 = time.perf_counter()
        block = fn(block)
        records.append(
            (i, getattr(fn, "_op_name", None)
             or getattr(fn, "__name__", "transform"),
             time.perf_counter() - t1, block_rows(block)))
    return block, records


def make_collector() -> Optional[CollectorHandle]:
    """Spawn the zero-CPU stats actor (None if the cluster is down),
    wrapped for GC-driven reaping."""
    import weakref

    import ray_tpu_torch

    try:
        actor = ray_tpu_torch.remote(_StatsCollector).options(num_cpus=0).remote()
    except Exception:  # noqa: BLE001 — stats must never break execution
        return None
    handle = CollectorHandle(actor)
    weakref.finalize(handle, reap_collector, actor)
    return handle


def reap_collector(actor) -> None:
    # GC-driven finalizer: may fire on ANY thread at ANY allocation,
    # including control-plane threads (GCS/raylet RPC handlers) during
    # the window between shutdown() and a later init(). It must never
    # go through ray_tpu_torch.kill(): _require_runtime() auto-inits when the
    # runtime is down, which from a control-plane thread deadlocks
    # against the in-progress init holding _init_lock (observed as
    # register_node stalls + missed-heartbeat node death in suite runs).
    # A dead runtime already reaped the actor; only reap on a live one.
    import ray_tpu_torch

    runtime = ray_tpu_torch._global_runtime
    if runtime is None:
        return
    try:
        runtime.kill_actor(actor._actor_id, no_restart=True)
    except Exception:  # noqa: BLE001 — cluster may already be down
        pass


def fetch(collector: Optional[CollectorHandle],
          expected_blocks: Optional[int] = None,
          timeout_s: float = 2.0,
          backpressure: Optional[Dict[str, Any]] = None
          ) -> Optional[DatasetStats]:
    """Summary snapshot. record() pushes are fire-and-forget from worker
    processes with no cross-client ordering vs this summary call, so
    when the caller knows how many blocks executed we poll until the
    collector has seen them all (or a short timeout)."""
    import ray_tpu_torch

    if collector is None:
        return None
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            summary = ray_tpu_torch.get(collector.actor.summary.remote(),
                                  timeout=10)
            if (not expected_blocks
                    or summary["blocks_recorded"] >= expected_blocks
                    or time.monotonic() >= deadline):
                return DatasetStats(summary, backpressure=backpressure)
            time.sleep(0.02)
    except Exception:  # noqa: BLE001
        return None
