"""ActorPool: load-balance a stream of work items over a fixed set of actors.

API surface matches the reference utility (`python/ray/util/actor_pool.py:8`);
the implementation is built around per-item ``_Slot`` records rather than
parallel index maps: every submission gets a slot with a monotonically
increasing sequence number, slots move backlog -> running -> harvested, and
the two consumption orders (submission order vs completion order) are just
two ways of picking the next slot to harvest.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional


@dataclass
class _Slot:
    seq: int
    ref: Any  # in-flight object ref
    actor: Any


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._free: collections.deque = collections.deque(actors)
        self._backlog: collections.deque = collections.deque()  # (fn, arg)
        self._running: dict = {}  # ref -> _Slot
        self._slots: dict = {}  # seq -> _Slot, until harvested
        self._submitted = 0  # total slots ever created
        self._harvest_seq = 0  # next seq get_next() will return

    # -- submission ----------------------------------------------------- #

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Schedule ``fn(actor, value)`` on the next free actor (or queue it)."""
        if not self._free:
            self._backlog.append((fn, value))
            return
        actor = self._free.popleft()
        slot = _Slot(seq=self._submitted, ref=fn(actor, value), actor=actor)
        self._submitted += 1
        self._running[slot.ref] = slot
        self._slots[slot.seq] = slot

    def _recycle(self, slot: _Slot) -> None:
        self._running.pop(slot.ref, None)
        self._slots.pop(slot.seq, None)
        self._free.append(slot.actor)
        if self._backlog:
            fn, value = self._backlog.popleft()
            self.submit(fn, value)

    # -- harvesting ----------------------------------------------------- #

    def has_next(self) -> bool:
        return bool(self._slots) or bool(self._backlog)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Block for the result of the oldest unharvested submission.

        A timeout leaves the slot unharvested (retry with another
        get_next); a task error consumes the slot and re-raises.
        """
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import GetTimeoutError

        if self._harvest_seq >= self._submitted:
            raise StopIteration("No more results to get")
        slot = self._slots[self._harvest_seq]
        try:
            value = ray_tpu_torch.get(slot.ref, timeout=timeout)
        except (GetTimeoutError, TimeoutError):
            raise
        except Exception:
            self._harvest_seq += 1
            self._recycle(slot)
            raise
        self._harvest_seq += 1
        self._recycle(slot)
        return value

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Block for whichever in-flight submission finishes first."""
        import ray_tpu_torch

        if not self._running:
            raise StopIteration("No more results to get")
        ready, _ = ray_tpu_torch.wait(list(self._running), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        slot = self._running[ready[0]]
        value = ray_tpu_torch.get(slot.ref)
        self._recycle(slot)
        return value

    # -- bulk helpers --------------------------------------------------- #

    def map(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- direct actor management ---------------------------------------- #

    def has_free(self) -> bool:
        return bool(self._free)

    def pop_idle(self) -> Optional[Any]:
        return self._free.pop() if self._free else None

    def push(self, actor: Any) -> None:
        self._free.append(actor)
