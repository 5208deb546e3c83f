"""Block lineage: bounded recomputation of lost pipeline blocks.

Every block a streaming execution emits records its recipe — (producer,
args, fused transforms) — so a node death mid-pipeline recomputes only the
lost partitions, never the whole pipeline (Exoshuffle's case: shuffle as
lineage-recoverable application code on the task runtime, not a bespoke
service). Recovery is two-tier:

- The CORE tier recovers transparently: the owner retains every submitted
  task spec, and a `get` on a lost object re-executes the creating task
  bottom-up (`core/runtime.py _try_reconstruct`, bounded by
  `max_object_reconstructions` / `max_reconstruction_depth`). The runtime
  counts these in `reconstructions_total`.
- The DATA tier here is the fallback for blocks the core cannot replay
  (e.g. the creating task exhausted its reconstruction budget, or the
  block was driver-materialized): `resolve()` re-runs the recorded fused
  task as a fresh submission, bounded per block.

Both tiers feed `accounting()`, the recomputed-block evidence the chaos
plane asserts on: after a node kill mid-shuffle, recomputed blocks must be
≤ the dead node's resident partition count — bounded re-execution, never a
restart and never a hang.

Records are dropped as soon as a block is consumed (`forget`) and the
registry is cleared when the execution ends — keyed state drains with the
pipeline (the RL013 discipline this module exists to enforce elsewhere).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


def core_reconstructions() -> int:
    """The runtime's lifetime count of core-tier lineage re-executions."""
    import ray_tpu_torch

    runtime = getattr(ray_tpu_torch, "_global_runtime", None)
    return getattr(runtime, "reconstructions_total", 0) if runtime else 0


class _BlockRecord:
    __slots__ = ("producer", "args", "transforms", "attempts")

    def __init__(self, producer: Optional[Callable], args: tuple,
                 transforms: List[Callable]):
        self.producer = producer
        self.args = args
        self.transforms = transforms
        self.attempts = 0


class BlockLineage:
    """Driver-side registry: block ref -> recipe, with bounded recompute.

    The registry is a bounded FIFO (`MAX_RECORDS`): recipes whose args
    hold ObjectRefs PIN those upstream objects, and a consumer that takes
    refs without resolving them (materialize, the split coordinator)
    would otherwise pin a whole epoch of shuffle buckets. Eviction drops
    the OLDEST recipe — the consumption frontier stays covered, and
    blocks past it still have the core tier's retained task specs."""

    MAX_RECORDS = 128

    def __init__(self, max_recomputes_per_block: Optional[int] = None):
        from collections import OrderedDict

        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        self._records: "OrderedDict[bytes, _BlockRecord]" = OrderedDict()
        self._max_attempts = (max_recomputes_per_block
                              if max_recomputes_per_block is not None
                              else GLOBAL_CONFIG.max_object_reconstructions)
        self.recomputed_blocks = 0
        self._core_base = core_reconstructions()

    def __len__(self) -> int:
        return len(self._records)

    def record(self, ref: Any, producer: Optional[Callable], args: tuple,
               transforms: List[Callable]):
        self._records[ref.object_id.binary()] = _BlockRecord(
            producer, tuple(args), list(transforms))
        while len(self._records) > self.MAX_RECORDS:
            self._records.popitem(last=False)

    def forget(self, ref: Any):
        self._records.pop(ref.object_id.binary(), None)

    def clear(self):
        self._records.clear()

    # ----------------------------------------------------------- recovery

    def _heal_arg(self, arg: Any) -> Any:
        """Make one recipe argument fetchable again. A driver-side get on
        a lost ref is what triggers the CORE tier (the driver owns every
        pipeline task, so `_try_reconstruct` re-runs the creating task);
        if even that fails and the arg has its own recipe, recurse into
        the data tier. Loss-shaped errors only — a user exception inside
        a dependency propagates untouched."""
        from ray_tpu_torch.object_ref import ObjectRef

        if not isinstance(arg, ObjectRef):
            return arg
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import ObjectLostError, RaySystemError

        try:
            # Value discarded: the point is re-sealing the object so the
            # resubmitted task's worker can fetch it.
            ray_tpu_torch.get(arg)
            return arg
        except (ObjectLostError, RaySystemError):
            if arg.object_id.binary() in self._records:
                return self.recompute(arg)
            # No data-tier recipe (e.g. one bucket of a multi-return map
            # task), but the driver OWNS the creating task: have the core
            # re-execute it — this also covers tasks that "completed"
            # with a loss-shaped error because their own dependency died
            # (the core recursively rebuilds dead deps, bottom-up).
            runtime = getattr(ray_tpu_torch, "_global_runtime", None)
            if runtime is None or not runtime.reexecute_task_for(
                    arg.object_id):
                raise
            ray_tpu_torch.get(arg)  # wait out the re-execution (may re-raise)
            return arg

    def recompute(self, ref: Any) -> Any:
        """Re-submit the recorded fused task for a lost block; returns the
        NEW ref. Ref-valued args are healed first (core reconstruction,
        then recursive data-tier recompute), so a reduce whose bucket
        died re-runs only the lost maps, bottom-up. Raises KeyError when
        the block has no record and ObjectLostError once the per-block
        attempt budget is spent."""
        import ray_tpu_torch
        from ray_tpu_torch.data.executor import _fused_apply
        from ray_tpu_torch.exceptions import ObjectLostError

        rec = self._records[ref.object_id.binary()]
        if rec.attempts >= self._max_attempts:
            raise ObjectLostError(ref.object_id)
        rec.attempts += 1
        self.recomputed_blocks += 1
        logger.warning("block %s lost beyond core recovery: re-running its "
                       "fused task (data-tier attempt %d)",
                       ref.object_id.hex()[:12], rec.attempts)
        args = tuple(self._heal_arg(a) for a in rec.args)
        rec.args = args
        new_ref = ray_tpu_torch.remote(_fused_apply).remote(
            rec.transforms, rec.producer, *args)
        # The recipe now describes the new ref; retire the old key.
        self._records[new_ref.object_id.binary()] = rec
        self._records.pop(ref.object_id.binary(), None)
        return new_ref

    def resolve(self, ref: Any, timeout: Optional[float] = None) -> Any:
        """`ray_tpu_torch.get` with the data-tier fallback: the core recovers
        what it can transparently inside get(); anything still lost after
        that — including a task that "completed" with a loss-shaped error
        because its dependency died under it — re-runs from the recorded
        recipe, bounded per block. Successful delivery retires the
        recipe (and with it the pins on upstream refs)."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import ObjectLostError, RaySystemError

        while True:
            try:
                # RayTaskError(ObjectLostError) raises as an instance of
                # its cause (as_instanceof_cause), so one except arm sees
                # both direct loss and loss that poisoned a dependent
                # task's result.
                value = ray_tpu_torch.get(ref, timeout=timeout)
            except (ObjectLostError, RaySystemError):
                if ref.object_id.binary() not in self._records:
                    raise
                ref = self.recompute(ref)
                continue
            self.forget(ref)
            return value

    # --------------------------------------------------------- accounting

    def accounting(self) -> Dict[str, int]:
        """Recomputed-block evidence for bounded-recovery asserts."""
        return {
            "dataplane_recomputed_blocks": self.recomputed_blocks,
            "core_reconstructions": core_reconstructions() - self._core_base,
        }
