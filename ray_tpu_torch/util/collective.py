"""Host-level collective ops — compatibility shim over `ray_tpu_torch.collective`.

The port's copy of `ray_tpu/util/collective.py`. Historically this module
WAS the collective implementation: a star-topology rendezvous actor that
round-tripped every payload, fully pickled, through one process
(O(world_size × bytes) through a single actor). The real plane lives in
`ray_tpu_torch.collective` — ring allreduce / tree broadcast over the
pipelined object-transfer plane, GCS-backed membership with
rank-attributed death aborts. The module-level API below delegates there.

The star implementation is retained as ``backend="star"`` (and the
`_RendezvousActor` class) for A/B measurement against the ring plane
(`tests/test_torch_collective.py` times both) and for tiny host-side
rendezvous where one actor is genuinely enough.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.collective.buffer import tree_index as _tree_index_impl

_REDUCE_OPS = {
    "sum": lambda xs: _tree_reduce(xs, np.add),
    "product": lambda xs: _tree_reduce(xs, np.multiply),
    "min": lambda xs: _tree_reduce(xs, np.minimum),
    "max": lambda xs: _tree_reduce(xs, np.maximum),
}


def _tree_reduce(xs: List[Any], op):
    out = xs[0]
    for x in xs[1:]:
        out = _tree_map2(op, out, x)
    return out


def _tree_map2(op, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(op, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map2(op, x, y) for x, y in zip(a, b))
    return op(np.asarray(a), np.asarray(b))


def _tree_index(x, rank: int, world: int):
    """Row-slice every leaf for reducescatter; raises ValueError when a
    leading dimension does not divide world_size (the old code silently
    dropped the remainder rows)."""
    return _tree_index_impl(x, rank, world)


class _RendezvousActor:
    """Barrier + gather/reduce/broadcast state machine for one group.

    Per-key state is refcounted by fetches: every member fetches each
    result exactly once, so the slot (result + event) is deleted when the
    world_size'th fetch drains it — long-lived groups no longer grow
    unboundedly."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._round: Dict[str, Dict[int, Any]] = {}
        self._results: Dict[str, Any] = {}
        self._fetches: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._events: Dict[str, threading.Event] = {}

    def get_world_size(self) -> int:
        """Attach-time validation hook: a namesake group with a different
        world_size must raise at init, not hang every rank."""
        return self.world_size

    def _event(self, key: str) -> threading.Event:
        with self._lock:
            return self._events.setdefault(key, threading.Event())

    def contribute(self, key: str, rank: int, value: Any, op: Optional[str]):
        with self._lock:
            slot = self._round.setdefault(key, {})
            slot[rank] = value
            done = len(slot) == self.world_size
            if done:
                vals = [slot[r] for r in sorted(slot)]
                if op is None:
                    self._results[key] = vals                # allgather
                else:
                    self._results[key] = _REDUCE_OPS[op](vals)
                del self._round[key]
        if done:
            self._event(key).set()
        return True

    def fetch(self, key: str, timeout: float = 300.0):
        if not self._event(key).wait(timeout):
            raise TimeoutError(f"collective '{key}' timed out "
                               f"(world_size={self.world_size})")
        with self._lock:
            result = self._results[key]
            self._fetches[key] = self._fetches.get(key, 0) + 1
            if self._fetches[key] >= self.world_size:
                # Drained: every member has its copy — delete the slot so
                # a long-lived group's memory stays bounded.
                del self._results[key]
                del self._fetches[key]
                self._events.pop(key, None)
            return result

    def reset(self):
        with self._lock:
            self._round.clear()
            self._results.clear()
            self._fetches.clear()
            self._events.clear()


class StarCollectiveGroup:
    """Legacy star topology: every op round-trips through one rendezvous
    actor. Kept for A/B measurement against the ring plane and as a
    minimal dependency-free fallback."""

    def __init__(self, name: str, world_size: int, rank: int):
        import ray_tpu_torch

        self.name = name
        self.world_size = world_size
        self.rank = rank
        self._actor = ray_tpu_torch.remote(_RendezvousActor).options(
            name=f"rtpu_collective_{name}", get_if_exists=True,
            max_concurrency=max(8, world_size * 2), num_cpus=0,
            lifetime="detached").remote(world_size)
        # get_if_exists may have attached to a pre-existing namesake actor:
        # a mismatched world_size would deadlock every op (the barrier
        # count never completes) — validate now and fail loudly.
        existing = ray_tpu_torch.get(self._actor.get_world_size.remote())
        if existing != world_size:
            raise ValueError(
                f"collective group '{name}' already exists with "
                f"world_size={existing}; attach requested "
                f"world_size={world_size}. destroy_collective_group() it "
                "first (or pick another name).")
        self._seq = 0

    def _next_key(self, tag: str) -> str:
        self._seq += 1
        return f"{tag}:{self._seq}"

    def _exchange(self, tag: str, value: Any, op: Optional[str]):
        import ray_tpu_torch

        key = self._next_key(tag)
        ray_tpu_torch.get(self._actor.contribute.remote(key, self.rank, value, op))
        return ray_tpu_torch.get(self._actor.fetch.remote(key))

    def allreduce(self, value: Any, op: str = "sum"):
        return self._exchange("ar", value, op)

    def allgather(self, value: Any) -> List[Any]:
        return self._exchange("ag", value, None)

    def broadcast(self, value: Any, src_rank: int = 0):
        vals = self._exchange("bc", value if self.rank == src_rank else None, None)
        return vals[src_rank]

    def reducescatter(self, value: Any, op: str = "sum"):
        full = self._exchange("rs", value, op)
        return _tree_index(full, self.rank, self.world_size)

    def barrier(self):
        self._exchange("barrier", None, None)

    def destroy(self):
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass

    def leave(self):  # API parity with the ring plane
        pass


# Backwards-compatible alias: `CollectiveGroup` from this module used to be
# the star implementation; the canonical CollectiveGroup now lives in
# ray_tpu_torch.collective.
CollectiveGroup = StarCollectiveGroup

_groups: Dict[str, Any] = {}


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default",
                          backend: str = "ring"):
    """Join a host collective group.

    backend="ring" (default): the `ray_tpu_torch.collective` plane — ring
    allreduce / tree broadcast over the object-transfer plane, GCS
    membership, CollectiveError on member death.
    backend="star": the legacy single-actor rendezvous.
    """
    if backend == "ring":
        import ray_tpu_torch.collective as _collective

        group = _collective.init_collective_group(world_size, rank,
                                                  group_name=group_name)
    elif backend == "star":
        group = StarCollectiveGroup(group_name, world_size, rank)
    else:
        raise ValueError(f"unknown collective backend {backend!r} "
                         "(expected 'ring' or 'star')")
    _groups[group_name] = group
    return group


def get_group(group_name: str = "default"):
    if group_name not in _groups:
        raise ValueError(f"collective group '{group_name}' not initialized")
    return _groups[group_name]


def allreduce(value, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(value, op)


def allgather(value, group_name: str = "default"):
    return get_group(group_name).allgather(value)


def broadcast(value, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(value, src_rank)


def reducescatter(value, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).reducescatter(value, op)


def barrier(group_name: str = "default"):
    get_group(group_name).barrier()


def destroy_collective_group(group_name: str = "default"):
    group = _groups.pop(group_name, None)
    if group is not None:
        group.destroy()
