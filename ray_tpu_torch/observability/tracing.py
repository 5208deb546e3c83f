"""Trace spans of the port's inference engine.

Counterpart of the part of `ray_tpu/observability/tracing.py` that the
engine calls: the `_ENABLED` switch, the process-wide trace context that
`capture()` reads at submission, `epoch_of` (the engine's monotonic stamps
onto the span timeline) and `Tracer.record_span` for the retrospective
phase spans (`engine.queue`, `engine.prefill`, `engine.decode`,
`engine.preempt`). Sampling is the reference's head sampling as far as
these consult it: a context carries `sampled`, and an unsampled or absent
context records nothing.

Recorded spans land in `RECORDER`, a bounded buffer (drop-oldest) that
`drain()` empties. The reference's flight recorder (its error ring and drop
accounting), live spans, wire propagation and export to the GCS wait for
the control plane's port.
"""

from __future__ import annotations

import contextvars
import secrets
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# Hot-path guard: instrumentation sites check this module bool before doing
# anything else (`set_enabled` flips it).
_ENABLED: bool = False

# Maps monotonic timestamps (the engine's Request clock) onto the epoch
# timeline every span uses.
_MONO_OFFSET = time.time() - time.monotonic()

# Current trace context ({trace_id, span_id, sampled}). A ContextVar, not a
# thread-local: asyncio tasks on one thread each need their own copy.
_trace_cv: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = \
    contextvars.ContextVar("ray_tpu_torch_trace", default=None)

RECORDER: "deque[Dict[str, Any]]" = deque(maxlen=4096)


def _rand_hex(nbytes: int) -> str:
    return secrets.token_hex(nbytes)


def epoch_of(monotonic_ts: float) -> float:
    """Translate a time.monotonic() stamp onto the span epoch timeline."""
    return monotonic_ts + _MONO_OFFSET


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


class Tracer:
    """Process-wide span recorder; a no-op while tracing is disabled. Use
    :func:`get_tracer` for the singleton."""

    def record_span(self, name: str, start: float, end: float,
                    ctx: Optional[Dict[str, Any]] = None,
                    parent_ctx: Optional[Dict[str, Any]] = None,
                    attrs: Optional[Dict[str, Any]] = None,
                    error: Optional[str] = None,
                    thread: Optional[str] = None):
        """Record a retrospective span from explicit timestamps (epoch
        seconds). ``ctx`` adopts ids (the span IS the context);
        ``parent_ctx`` mints a fresh child span id under that parent.
        Unsampled/absent context records nothing."""
        if not _ENABLED:
            return
        if ctx is not None:
            if not ctx.get("sampled"):
                return
            trace_id, span_id = ctx["trace_id"], ctx["span_id"]
            parent_id = ctx.get("parent_span_id")
        elif parent_ctx is not None:
            if not parent_ctx.get("sampled"):
                return
            trace_id, span_id = parent_ctx["trace_id"], _rand_hex(8)
            parent_id = parent_ctx.get("span_id")
        else:
            return
        RECORDER.append({
            "name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent_id, "start": start, "end": end,
            "thread": thread or threading.current_thread().name,
            "attrs": dict(attrs) if attrs else None, "error": error,
        })


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def capture() -> Optional[Dict[str, Any]]:
    """Current trace context (None when disabled or no trace active) —
    stash it to re-enter the trace from another thread/queue."""
    if not _ENABLED:
        return None
    return _trace_cv.get()


def activate(ctx: Optional[Dict[str, Any]]) -> "contextvars.Token":
    """Install `ctx` as the current context; returns the token for
    :func:`deactivate`."""
    return _trace_cv.set(ctx)


def deactivate(token: "contextvars.Token") -> None:
    try:
        _trace_cv.reset(token)
    except ValueError:
        pass


def drain() -> List[Dict[str, Any]]:
    """Pop every recorded span, oldest first."""
    out = []
    while RECORDER:
        out.append(RECORDER.popleft())
    return out
