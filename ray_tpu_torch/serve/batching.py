"""Request batching for replicas (`@serve.batch`).

The accelerator-critical piece of the serving path: individual requests
are queued on the replica's asyncio loop and flushed as one list into the
wrapped callable — which for a GPU replica means one padded forward pass on
the card instead of N tiny ones. Mirrors the reference's
`python/ray/serve/batching.py` semantics (max_batch_size +
batch_wait_timeout_s) with an asyncio queue + single flusher task.

Usable standalone on any async method; typical use inside a deployment:

    @serve.deployment
    class Model:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01)
        async def __call__(self, prompts: list[str]) -> list[str]:
            return self._jit_generate(prompts)   # one batched MXU call
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional, Set

from ray_tpu_torch.observability import tracing as _tracing


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._queue: Optional[asyncio.Queue] = None
        self._flusher: Optional[asyncio.Task] = None
        self._pending: Set[asyncio.Future] = set()
        self._stopped = False

    def _ensure_started(self):
        # Lazily bind to the running loop (the replica's actor loop).
        if self._queue is None:
            self._queue = asyncio.Queue()
            self._flusher = asyncio.get_running_loop().create_task(
                self._flush_forever())

    async def submit(self, item: Any) -> Any:
        if self._stopped:
            raise RuntimeError("batch queue is stopped (replica shutdown)")
        self._ensure_started()
        fut = asyncio.get_running_loop().create_future()
        self._pending.add(fut)
        fut.add_done_callback(self._pending.discard)
        # Trace context rides with the item: the flusher coroutine runs
        # outside any request context, so the batch span re-parents to
        # the first batched request's trace.
        self._queue.put_nowait((item, fut, _tracing.capture()))
        return await fut

    def stop(self) -> int:
        """Replica teardown: cancel the flusher task and fail every
        parked future (queued AND mid-batch) — without this, a replica
        shutdown leaks the `_flush_forever` coroutine forever and strands
        callers awaiting futures nothing will ever resolve. Returns how
        many pending calls were failed."""
        self._stopped = True
        if self._flusher is not None and not self._flusher.done():
            self._flusher.cancel()
        self._flusher = None
        failed = 0
        for fut in list(self._pending):
            if not fut.done():
                fut.set_exception(
                    RuntimeError("replica shut down before the batched "
                                 "call completed"))
                failed += 1
        self._pending.clear()
        if self._queue is not None:
            while not self._queue.empty():
                self._queue.get_nowait()
        return failed

    async def _flush_forever(self):
        while True:
            batch: List = [await self._queue.get()]
            # Admit more until full or the wait timeout elapses.
            deadline = asyncio.get_running_loop().time() + self._timeout
            while len(batch) < self._max:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), timeout=remaining))
                except asyncio.TimeoutError:
                    break
            items = [b[0] for b in batch]
            futures = [b[1] for b in batch]
            span = _tracing.NOOP_SPAN
            if _tracing._ENABLED:
                # Parent to the first batched request's SAMPLED context —
                # the flusher task itself inherited whatever context was
                # current when it was first created (not this batch's
                # trace), and an unsampled request's context would
                # no-op the span even when a sampled request shares the
                # batch.
                ctx = next((b[2] for b in batch
                            if b[2] is not None and b[2].get("sampled")),
                           None)
                if ctx is not None:
                    span = _tracing.get_tracer().start_span(
                        "serve.batch", child_of=ctx,
                        attrs={"batch_size": len(items)})
            try:
                with span:
                    results = self._fn(items)
                    if asyncio.iscoroutine(results):
                        results = await results
                    if len(results) != len(items):
                        raise RuntimeError(
                            f"@serve.batch function returned {len(results)} "
                            f"results for a batch of {len(items)}")
                for fut, res in zip(futures, results):
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:  # noqa: BLE001 — fan the error out
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator collecting concurrent calls into one list-in/list-out call.

    The wrapped function receives a list of the individual call arguments
    and must return a list of results of the same length.
    """

    def wrap(fn: Callable):
        attr = f"__serve_batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(*args):
            # Methods: args = (self, item); functions: args = (item,).
            if len(args) == 2:
                owner, item = args
                bound = functools.partial(fn, owner)
            elif len(args) == 1:
                owner, (item,) = wrapper, args
                bound = fn
            else:
                raise TypeError(
                    "@serve.batch methods take exactly one request argument")
            queue = getattr(owner, attr, None)
            if queue is None:
                queue = _BatchQueue(bound, max_batch_size,
                                    batch_wait_timeout_s)
                setattr(owner, attr, queue)
            return await queue.submit(item)

        wrapper.__serve_is_batched__ = True
        return wrapper

    return wrap(_fn) if _fn is not None else wrap
