"""HangWatchdog: the zero-hangs assertion behind every chaos run.

A chaos bench that "passes" while a future sits parked forever proves
nothing — recovery must be *bounded*, so the watchdog samples the
runtime's parked-operation registry (core/runtime.py: every public
blocking wait — get / wait / actor resolution — registers itself for its
duration) plus any caller-registered custom waits (HTTP requests in the
bench driver), and records a HANG the moment any of them outlives the
limit. Each hang is attributed: what was parked, for how long, with the
stack of every thread at detection time, so a wedge points at its owner
instead of at "the bench timed out".
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import runtime as _runtime_mod


class HangDetected(AssertionError):
    """At least one parked operation outlived the watchdog limit."""


class _TrackedOp:
    """One caller-registered blocking op (HangWatchdog.track)."""

    __slots__ = ("_wd", "_desc", "token")

    def __init__(self, wd: "HangWatchdog", desc: str):
        self._wd = wd
        self._desc = desc

    def __enter__(self) -> "_TrackedOp":
        wd = self._wd
        with wd._custom_lock:
            wd._custom_counter += 1
            self.token = wd._custom_counter
            wd._custom[self.token] = (self._desc, time.monotonic())
        return self

    def __exit__(self, *exc):
        wd = self._wd
        with wd._custom_lock:
            wd._custom.pop(self.token, None)
        return False


def _thread_stacks() -> str:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, ident)}")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame)[-6:])
    return "\n".join(out)


class HangWatchdog:
    """Samples parked operations; any parked past `limit_s` is a hang.

    Usage::

        with HangWatchdog(limit_s=60.0) as wd:
            ... run chaos workload ...
        wd.assert_no_hangs()      # raises HangDetected with attribution

    `track(desc)` returns a context manager registering a custom blocking
    operation (e.g. an HTTP request await in the bench driver) with the
    same deadline discipline as the runtime's own gets.
    """

    def __init__(self, limit_s: float, poll_s: float = 0.5,
                 extra_sources: Optional[
                     List[Callable[[], List[Tuple[int, str, float]]]]] = None):
        self.limit_s = limit_s
        self.poll_s = poll_s
        self.hangs: List[str] = []
        self._reported: set = set()
        self._extra = list(extra_sources or [])
        self._custom: Dict[int, Tuple[str, float]] = {}
        self._custom_lock = threading.Lock()
        self._custom_counter = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- tracking

    def track(self, desc: str) -> "_TrackedOp":
        """Context manager registering a custom blocking op with the
        watchdog for its duration (cheap: called per request on measured
        paths in bench_chaos)."""
        return _TrackedOp(self, desc)

    def _sources(self) -> List[Tuple[str, int, str, float]]:
        out = [("runtime", tok, desc, elapsed)
               for tok, desc, elapsed in _runtime_mod.parked_ops()]
        now = time.monotonic()
        with self._custom_lock:
            out.extend(("custom", tok, desc, now - t0)
                       for tok, (desc, t0) in self._custom.items())
        for src in self._extra:
            try:
                out.extend(("extra", tok, desc, elapsed)
                           for tok, desc, elapsed in src())
            except Exception:  # noqa: BLE001 — a broken source is not a hang
                pass
        return out

    # ------------------------------------------------------------ lifecycle

    def _run(self):
        while not self._stop.wait(self.poll_s):
            self._scan()

    def _scan(self):
        for source, token, desc, elapsed in self._sources():
            key = (source, token)
            if elapsed > self.limit_s and key not in self._reported:
                self._reported.add(key)
                self.hangs.append(
                    f"{source} op '{desc}' parked {elapsed:.1f}s "
                    f"(> {self.limit_s}s limit)\n{_thread_stacks()}")

    def start(self) -> "HangWatchdog":
        self._thread = threading.Thread(target=self._run,
                                        name="hang-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._scan()  # final sweep: ops parked at shutdown still count

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------ reporting

    @property
    def hang_count(self) -> int:
        return len(self.hangs)

    def assert_no_hangs(self):
        if self.hangs:
            raise HangDetected(
                f"{len(self.hangs)} operation(s) parked past "
                f"{self.limit_s}s:\n" + "\n\n".join(self.hangs))
