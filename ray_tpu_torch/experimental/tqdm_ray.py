"""Distributed progress bars (reference
`python/ray/experimental/tqdm_ray.py`): a tqdm-shaped API usable inside
tasks/actors whose progress lines flow to the driver through the
existing worker log streaming — no terminal fighting between dozens of
remote processes, no tqdm dependency.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Iterable, Optional


class tqdm:  # noqa: N801 — mirrors the tqdm API it substitutes
    """Rate-limited textual progress; safe in any worker process."""

    MIN_INTERVAL_S = 0.5

    def __init__(self, iterable: Optional[Iterable] = None, *,
                 desc: str = "", total: Optional[int] = None,
                 position: int = 0, flush_interval_s: Optional[float] = None):
        self._iterable = iterable
        self.desc = desc or "progress"
        if total is None and iterable is not None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self.n = 0
        self._start = time.monotonic()
        self._last_print = 0.0
        self._interval = (self.MIN_INTERVAL_S if flush_interval_s is None
                          else flush_interval_s)
        self._closed = False

    def __iter__(self):
        if self._iterable is None:
            raise TypeError("tqdm(...) created without an iterable")
        try:
            for item in self._iterable:
                yield item
                self.update(1)
        finally:
            self.close()

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.monotonic()
        if now - self._last_print >= self._interval:
            self._last_print = now
            self._emit()

    def set_description(self, desc: str) -> None:
        self.desc = desc

    def _emit(self, final: bool = False) -> None:
        elapsed = max(time.monotonic() - self._start, 1e-9)
        rate = self.n / elapsed
        if self.total:
            pct = 100.0 * self.n / self.total
            line = (f"[{self.desc} pid={os.getpid()}] "
                    f"{self.n}/{self.total} ({pct:.0f}%) "
                    f"[{rate:.1f} it/s]")
        else:
            line = (f"[{self.desc} pid={os.getpid()}] {self.n} "
                    f"[{rate:.1f} it/s]")
        if final:
            line += " done"
        # stdout is captured by the worker's log streamer and printed on
        # the driver — one line per interval instead of a live bar.
        print(line, file=sys.stdout, flush=True)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._emit(final=True)

    def __enter__(self) -> "tqdm":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
