"""Pool implementation: chunked, windowed task submission over the core.

`processes` really bounds concurrency: every Pool method pushes its chunk
tasks through a window of at most `processes` unresolved refs (submit as
slots free), so a Pool(2) over an 8-CPU cluster runs 2 chunks at a time —
the contract callers limiting a rate-limited API or memory-heavy fn rely
on.
"""

from __future__ import annotations

import multiprocessing
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional


def _prime(thunks: List[Callable[[], Any]], slots) -> tuple:
    """Submit as many thunks as free slots allow; returns (inflight, i)."""
    inflight = {}
    i = 0
    while i < len(thunks) and slots.acquire(blocking=False):
        inflight[thunks[i]()] = i
        i += 1
    return inflight, i


class _WindowedIter:
    """Iterator over thunk results bounded by the POOL-wide slot semaphore
    (shared across concurrent map/imap calls, like multiprocessing.Pool's
    fixed worker count); yields (index, value_or_exception) in COMPLETION
    order. A real object rather than a generator so eagerly-primed slots
    are released even if the caller never iterates (__del__/close)."""

    def __init__(self, thunks: List[Callable[[], Any]], slots,
                 primed: tuple = None):
        self._thunks = thunks
        self._slots = slots
        self._inflight, self._i = primed if primed is not None \
            else _prime(thunks, slots)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch

        thunks, slots = self._thunks, self._slots
        if self._closed or (self._i >= len(thunks) and not self._inflight):
            self.close()
            raise StopIteration
        while self._i < len(thunks) and slots.acquire(blocking=False):
            self._inflight[thunks[self._i]()] = self._i
            self._i += 1
        if not self._inflight:
            # Another call holds every slot: block for one.
            slots.acquire()
            self._inflight[thunks[self._i]()] = self._i
            self._i += 1
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1)
        idx = self._inflight.pop(ready[0])
        slots.release()
        try:
            return idx, ray_tpu_torch.get(ready[0])
        except BaseException as e:  # noqa: BLE001 — delivered to caller
            return idx, _Failure(e)

    def close(self):
        if not self._closed:
            self._closed = True
            inflight, self._inflight = self._inflight, {}
            if inflight:
                # The abandoned chunks are still executing remotely: their
                # slots free only as each chunk resolves, so the pool-wide
                # `processes` bound holds even across discarded iterators.
                slots = self._slots

                def reap(refs=list(inflight)):
                    import ray_tpu_torch

                    while refs:
                        ready, refs = ray_tpu_torch.wait(refs, num_returns=1)
                        for _ in ready:
                            slots.release()

                threading.Thread(target=reap, daemon=True).start()

    def __del__(self):
        self.close()


def _windowed(thunks: List[Callable[[], Any]], slots,
              primed: tuple = None) -> Iterator[tuple]:
    return _WindowedIter(thunks, slots, primed)


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


class AsyncResult:
    """Handle for apply_async/map_async (mirrors multiprocessing's)."""

    def __init__(self, thunks: List[Callable[[], Any]], single: bool,
                 slots, callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None):
        self._thunks = thunks
        self._single = single
        self._slots = slots
        self._callback = callback
        self._error_callback = error_callback
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        threading.Thread(target=self._collect, daemon=True).start()

    def _collect(self):
        try:
            chunks: List[Any] = [None] * len(self._thunks)
            for idx, val in _windowed(self._thunks, self._slots):
                if isinstance(val, _Failure):
                    raise val.error
                chunks[idx] = val
            out: List[Any] = []
            for chunk in chunks:
                out.extend(chunk)
            self._value = out[0] if self._single else out
            if self._callback is not None:
                try:
                    self._callback(self._value)
                except Exception:  # noqa: BLE001 — user callback
                    pass
        except BaseException as e:  # noqa: BLE001
            self._error = e
            if self._error_callback is not None:
                try:
                    self._error_callback(e)
                except Exception:  # noqa: BLE001
                    pass
        finally:
            self._done.set()

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            # The drop-in contract: multiprocessing.TimeoutError (a
            # ProcessError subclass), not the builtin.
            raise multiprocessing.TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def wait(self, timeout: Optional[float] = None):
        self._done.wait(timeout)

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self._done.is_set():
            raise ValueError("result not ready")
        return self._error is None


def _run_chunk(fn, chunk, mode):
    if mode == "star":
        return [fn(*args) for args in chunk]
    if mode == "call":
        return [fn(*args, **kwds) for args, kwds in chunk]
    return [fn(x) for x in chunk]


class Pool:
    """Task-backed process pool spanning the cluster; at most `processes`
    chunk tasks run concurrently."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (), ray_address: Optional[str] = None):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=ray_address)
        if processes is None:
            processes = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        self._processes = processes
        self._slots = threading.Semaphore(processes)  # pool-wide window
        self._closed = False
        # Pools don't own workers, so the initializer runs prepended to
        # every chunk's task (cheap; mirrors reference semantics closely
        # enough for setup-style initializers).
        self._initializer = initializer
        self._initargs = initargs
        self._results: List[AsyncResult] = []
        self._remote_chunk = ray_tpu_torch.remote(self._make_runner())

    def _make_runner(self):
        initializer, initargs = self._initializer, self._initargs

        def run_chunk(fn, chunk, mode):
            if initializer is not None:
                initializer(*initargs)
            return _run_chunk(fn, chunk, mode)

        return run_chunk

    # ------------------------------------------------------------------ api

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]
                ) -> List[list]:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def _thunks(self, fn, chunks: List[list], mode: str
                ) -> List[Callable[[], Any]]:
        return [
            (lambda c=c: self._remote_chunk.remote(fn, c, mode))
            for c in chunks
        ]

    def apply(self, fn: Callable, args: tuple = (),
              kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: Optional[dict] = None,
                    callback: Optional[Callable] = None,
                    error_callback: Optional[Callable] = None) -> AsyncResult:
        self._check_open()
        thunks = self._thunks(fn, [[(tuple(args), kwds or {})]], "call")
        res = AsyncResult(thunks, single=True, slots=self._slots,
                          callback=callback, error_callback=error_callback)
        self._track(res)
        return res

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None,
                  callback: Optional[Callable] = None,
                  error_callback: Optional[Callable] = None) -> AsyncResult:
        self._check_open()
        thunks = self._thunks(fn, self._chunks(iterable, chunksize), "map")
        res = AsyncResult(thunks, single=False, slots=self._slots,
                          callback=callback, error_callback=error_callback)
        self._track(res)
        return res

    def _track(self, res: AsyncResult):
        # join() waits on outstanding results; prune finished ones here so
        # a long-lived pool doesn't pin every past map()'s materialized
        # values until close().
        self._results = [r for r in self._results if not r.ready()]
        self._results.append(res)

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        thunks = self._thunks(fn, self._chunks(iterable, chunksize), "star")
        return AsyncResult(thunks, single=False,
                           slots=self._slots).get()

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int = 1) -> Iterator[Any]:
        """Ordered lazy iteration; windowed submission."""
        self._check_open()
        thunks = self._thunks(fn, self._chunks(iterable, chunksize), "map")
        # Work starts NOW, not at first next() (mp semantics); the iterator
        # object owns the primed slots, so discarding it releases them.
        win = _windowed(thunks, self._slots, _prime(thunks, self._slots))

        def gen():
            buffered = {}
            emit = 0
            for idx, val in win:
                if isinstance(val, _Failure):
                    raise val.error
                buffered[idx] = val
                while emit in buffered:
                    for v in buffered.pop(emit):
                        yield v
                    emit += 1

        return gen()

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int = 1) -> Iterator[Any]:
        """Completion-order iteration; windowed submission."""
        self._check_open()
        thunks = self._thunks(fn, self._chunks(iterable, chunksize), "map")
        win = _windowed(thunks, self._slots, _prime(thunks, self._slots))

        def gen():
            for _idx, val in win:
                if isinstance(val, _Failure):
                    raise val.error
                for v in val:
                    yield v

        return gen()

    # -------------------------------------------------------------- lifecycle

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")
        for res in self._results:
            res.wait()
        self._results = []

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc):
        self.terminate()
