"""ParallelIterator: sharded lazy iterators over actors.

Equivalent of the reference's `python/ray/util/iter.py:132`
(`ParallelIterator` / `ParallelIteratorWorker` :1136 — the base of RLlib's
old RolloutWorker): a logical iterator split into shards, each shard a
chain of local transforms hosted by one actor; `gather_sync`/`gather_async`
pull batches back to the driver either round-robin or completion-order.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Iterable, Iterator, List, Optional


class _ShardWorker:
    """Actor hosting one shard: a base iterable + transform chain."""

    def __init__(self, items: List[Any], transforms: List[tuple]):
        self._items = items
        self._transforms = transforms
        self._it: Optional[Iterator] = None

    def _build(self) -> Iterator:
        it: Iterable = iter(self._items)
        for kind, fn in self._transforms:
            if kind == "for_each":
                it = builtins.map(fn, it)
            elif kind == "filter":
                it = (x for x in it if fn(x))
            elif kind == "flatten":
                it = (y for x in it for y in x)
            elif kind == "batch":
                it = _batched(it, fn)
        return iter(it)

    def reset(self):
        self._it = self._build()
        return True

    def next_batch(self, n: int) -> List[Any]:
        """Up to n items; empty list = exhausted."""
        if self._it is None:
            self.reset()
        out = []
        try:
            for _ in range(n):
                out.append(next(self._it))
        except StopIteration:
            pass
        return out


def _batched(it: Iterator, n: int) -> Iterator[List[Any]]:
    buf: List[Any] = []
    for x in it:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


class ParallelIterator:
    """Declarative sharded iterator; transforms stay lazy until gathered.

    Internally a list of (shard_items, transform_chain) segments: a union
    is just segment concatenation (each side keeps its own chain), so
    nothing materializes until a gather spawns the shard actors."""

    def __init__(self, shards: Optional[List[List[Any]]] = None,
                 transforms: Optional[List[tuple]] = None,
                 segments: Optional[List[tuple]] = None):
        if segments is not None:
            self._segments = list(segments)
        else:
            t = list(transforms or [])
            self._segments = [(s, t) for s in (shards or [])]

    # ----------------------------------------------------------- transforms

    def _with_transform(self, step: tuple) -> "ParallelIterator":
        return ParallelIterator(segments=[
            (items, chain + [step]) for items, chain in self._segments])

    def for_each(self, fn: Callable[[Any], Any]) -> "ParallelIterator":
        return self._with_transform(("for_each", fn))

    def filter(self, fn: Callable[[Any], bool]) -> "ParallelIterator":
        return self._with_transform(("filter", fn))

    def flatten(self) -> "ParallelIterator":
        return self._with_transform(("flatten", None))

    def batch(self, n: int) -> "ParallelIterator":
        return self._with_transform(("batch", n))

    def union(self, other: "ParallelIterator") -> "ParallelIterator":
        return ParallelIterator(
            segments=self._segments + other._segments)

    def num_shards(self) -> int:
        return len(self._segments)

    # ------------------------------------------------------------- gathering

    def _spawn(self) -> List[Any]:
        import ray_tpu_torch

        actor_cls = ray_tpu_torch.remote(_ShardWorker)
        workers = [actor_cls.options(num_cpus=0.1).remote(items, chain)
                   for items, chain in self._segments]
        ray_tpu_torch.get([w.reset.remote() for w in workers])
        return workers

    def gather_sync(self, batch: int = 32) -> Iterator[Any]:
        """Round-robin over shards, in shard order within each round."""
        import ray_tpu_torch

        workers = self._spawn()
        try:
            live = list(workers)
            while live:
                refs = [w.next_batch.remote(batch) for w in live]
                next_live = []
                for w, ref in zip(live, refs):
                    got = ray_tpu_torch.get(ref)
                    if got:
                        next_live.append(w)
                        yield from got
                live = next_live
        finally:
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:  # noqa: BLE001
                    pass

    def gather_async(self, batch: int = 32) -> Iterator[Any]:
        """Completion-order gathering: whichever shard finishes its batch
        first is consumed (and re-pumped) first."""
        import ray_tpu_torch

        workers = self._spawn()
        try:
            inflight = {w.next_batch.remote(batch): w for w in workers}
            while inflight:
                ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1)
                w = inflight.pop(ready[0])
                got = ray_tpu_torch.get(ready[0])
                if got:
                    inflight[w.next_batch.remote(batch)] = w
                    yield from got
        finally:
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:  # noqa: BLE001
                    pass

    def take(self, n: int) -> List[Any]:
        out = []
        for x in self.gather_sync():
            out.append(x)
            if len(out) >= n:
                break
        return out

    def show(self, n: int = 20):
        for x in self.take(n):
            print(x)

    def __repr__(self):
        steps = max((len(c) for _, c in self._segments), default=0)
        return (f"ParallelIterator[{len(self._segments)} shards, "
                f"{steps} transforms]")


def from_items(items: List[Any], num_shards: int = 2) -> ParallelIterator:
    shards: List[List[Any]] = [[] for _ in range(num_shards)]
    for i, x in enumerate(items):
        shards[i % num_shards].append(x)
    return ParallelIterator(shards)


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    return from_items(list(range(n)), num_shards)


def from_iterators(generators: List[Iterable]) -> ParallelIterator:
    return ParallelIterator([list(g) for g in generators])
