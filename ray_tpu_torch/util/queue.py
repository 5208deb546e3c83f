"""Distributed FIFO queue backed by an actor.

Equivalent of `python/ray/util/queue.py:20` (`Queue` over `_QueueActor`).
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: Optional[float] = None):
        try:
            await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            return True, await asyncio.wait_for(self.q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item):
        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get_nowait(self):
        try:
            return True, self.q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def qsize(self):
        return self.q.qsize()

    async def empty(self):
        return self.q.empty()

    async def full(self):
        return self.q.full()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        import ray_tpu_torch

        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 64)
        opts.setdefault("num_cpus", 0.1)
        self.actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch

        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full()
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full()

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch

        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
        else:
            ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty()
        return item

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.full.remote())

    def put_async(self, item: Any):
        return self.actor.put.remote(item, None)

    def get_async(self):
        return self.actor.get.remote(None)

    def shutdown(self):
        import ray_tpu_torch

        ray_tpu_torch.kill(self.actor)
