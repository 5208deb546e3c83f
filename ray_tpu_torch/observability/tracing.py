"""Distributed tracing: spans, context propagation, flight recorder.

The tracing plane gives the cluster per-request causality that the
aggregate counters in `ray_tpu_torch.util.metrics` cannot: every cross-process
boundary (RPC framing, task specs, actor calls, serve requests, collective
ops, forge spawns, object pulls, inference engine phases) opens a named
span tied to one trace id, and the resulting span trees are exported as
JSON (`/api/traces/<id>`) or a Chrome trace-event timeline
(`/api/timeline`, Perfetto-loadable).

Design constraints (reference `ray/util/tracing/tracing_helper.py`, but
self-contained — no OpenTelemetry dependency):

- **Disabled is near-free.** Every instrumentation site starts with a
  single module-bool guard; when `tracing_enabled` is off, `start_span`
  returns one shared no-op singleton and nothing allocates.
- **Bounded memory.** Spans land in a per-process ring buffer (the
  *flight recorder*): fixed capacity, drop-oldest with a drop counter.
  Spans that recorded an error are kept in a separate small ring so
  drop-oldest under a span storm cannot evict the evidence
  (always-sample-on-error at the buffer level).
- **Head-based sampling.** The sampling decision is made once, where a
  trace is rooted, and travels with the context (`sampled`); sampled-out
  requests return the no-op singleton everywhere downstream.
- **W3C-style propagation.** Context is `{trace_id, span_id, sampled}`;
  HTTP carries it as a `traceparent` header, internal RPC framing as a
  compact `t` envelope key, task specs as `spec.trace_ctx`.

Spans are flushed to the GCS piggybacked on the `MetricsPusher` cadence
(one RPC carries metrics + spans), so tracing adds no new background
threads or connections.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import GLOBAL_CONFIG

# --------------------------------------------------------------------- state

# Hot-path guard: instrumentation sites check this module bool before
# doing anything else. Refreshed from GLOBAL_CONFIG by refresh_from_config
# (called from ray_tpu_torch.init / CoreRuntime startup, so workers pick the
# flag up from the propagated RAY_TPU_TORCH_TRACING_ENABLED env).
_ENABLED: bool = False
_SAMPLE_RATE: float = 1.0

# Maps monotonic timestamps (the engine's Request clock) onto the epoch
# timeline every span uses.
_MONO_OFFSET = time.time() - time.monotonic()

# Process-global current trace context. A ContextVar, not a thread-local:
# async actor methods interleave on one event-loop thread and each asyncio
# task needs its own copy.
_trace_cv: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = \
    contextvars.ContextVar("ray_tpu_trace", default=None)

# Shared singleton for "a context exists but the trace is sampled out":
# wire propagation restores it without allocating per request.
_UNSAMPLED_CTX: Dict[str, Any] = {"sampled": False}


def _rand_hex(nbytes: int) -> str:
    from ray_tpu_torch.core.ids import _random_bytes

    return _random_bytes(nbytes).hex()


def epoch_of(monotonic_ts: float) -> float:
    """Translate a time.monotonic() stamp onto the span epoch timeline."""
    return monotonic_ts + _MONO_OFFSET


# ----------------------------------------------------------- flight recorder


class FlightRecorder:
    """Bounded per-process span buffer: fixed memory, drop-oldest.

    Error spans go to their own small ring so a storm of healthy spans
    cannot evict them before the next flush. All methods are leaf-locked
    (the recorder never calls out while holding its lock), so record()
    is safe from any context, including under control-plane locks.
    """

    ERROR_CAP = 256

    def __init__(self, cap: int = 4096):
        self._lock = threading.Lock()
        self._cap = max(1, int(cap))
        self._spans: deque = deque()
        self._errors: deque = deque()
        self._dropped = 0

    def resize(self, cap: int):
        with self._lock:
            self._cap = max(1, int(cap))
            while len(self._spans) > self._cap:
                self._spans.popleft()
                self._dropped += 1

    def record(self, span: Dict[str, Any]):
        with self._lock:
            if span.get("error") is not None:
                if len(self._errors) >= self.ERROR_CAP:
                    self._errors.popleft()
                    self._dropped += 1
                self._errors.append(span)
                return
            if len(self._spans) >= self._cap:
                self._spans.popleft()
                self._dropped += 1
            self._spans.append(span)

    def drain(self) -> Tuple[List[Dict[str, Any]], int]:
        """Pop every buffered span (errors first) + the drop count since
        the last drain. Called by the MetricsPusher flush."""
        with self._lock:
            spans = list(self._errors) + list(self._spans)
            self._errors.clear()
            self._spans.clear()
            dropped, self._dropped = self._dropped, 0
            return spans, dropped

    def restore(self, spans: List[Dict[str, Any]], dropped: int):
        """Put a failed flush's drained spans (and their drop count)
        back, so a GCS hiccup delays delivery instead of silently losing
        the spans AND the accounting. Still bounded: re-recording runs
        through the normal caps."""
        with self._lock:
            self._dropped += dropped
        for span in spans:
            self.record(span)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans) + len(self._errors)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"buffered": len(self._spans) + len(self._errors),
                    "cap": self._cap, "dropped": self._dropped}


RECORDER = FlightRecorder(4096)


# -------------------------------------------------------------------- spans


class _NoopSpan:
    """Shared do-nothing span: the disabled/sampled-out path returns this
    exact singleton from every call site — no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set_attr(self, key: str, value: Any):
        return self

    def end(self, error: Optional[str] = None):
        pass

    @property
    def ctx(self) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class Span:
    """One recorded operation. Use as a context manager; a raised
    exception marks the span errored. Ending restores the previous
    context, so nesting works naturally."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "attrs", "error", "_token", "_ctx")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = time.time()
        self.attrs = dict(attrs) if attrs else None
        self.error: Optional[str] = None
        self._ctx = {"trace_id": trace_id, "span_id": span_id,
                     "sampled": True}
        self._token = _trace_cv.set(self._ctx)

    @property
    def ctx(self) -> Dict[str, Any]:
        """Propagation context for children of this span."""
        return self._ctx

    def set_attr(self, key: str, value: Any) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and self.error is None:
            self.error = f"{exc_type.__name__}: {exc}"
        self.end()
        return False

    def end(self, error: Optional[str] = None):
        if self._token is None:
            return  # already ended (with-block + explicit end)
        if error is not None:
            self.error = error
        try:
            _trace_cv.reset(self._token)
        except ValueError:
            # Ended in a different context than it started (e.g. a span
            # handed across threads): current ctx is not ours to restore.
            pass
        self._token = None
        RECORDER.record({
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": time.time(),
            "thread": threading.current_thread().name,
            "attrs": self.attrs,
            "error": self.error,
        })


# ------------------------------------------------------------------- tracer


class Tracer:
    """Process-wide span factory. All methods are cheap no-ops while
    tracing is disabled; use :func:`get_tracer` for the singleton."""

    def start_span(self, name: str,
                   attrs: Optional[Dict[str, Any]] = None,
                   child_of: Optional[Dict[str, Any]] = None,
                   ctx: Optional[Dict[str, Any]] = None):
        """Open a span.

        - default: child of the current context; with no current context
          this roots a new trace (head sampling decides here).
        - ``child_of``: explicit parent context (e.g. parsed traceparent).
        - ``ctx``: ADOPT the ids in a pre-minted context (a task spec's
          ``trace_ctx``): the span IS that context's span, so the
          submitter-side ids and the executed span line up.

        Always use as a context manager or end() in a finally block —
        raylint RL008 flags anything else.
        """
        if not _ENABLED:
            return NOOP_SPAN
        if ctx is not None:
            if not ctx.get("sampled"):
                return NOOP_SPAN
            return Span(name, ctx["trace_id"], ctx["span_id"],
                        ctx.get("parent_span_id"), attrs)
        parent = child_of if child_of is not None else _trace_cv.get()
        if parent is None:
            if not self._sample():
                return NOOP_SPAN
            return Span(name, _rand_hex(16), _rand_hex(8), None, attrs)
        if not parent.get("sampled", False):
            return NOOP_SPAN
        return Span(name, parent["trace_id"], _rand_hex(8),
                    parent.get("span_id"), attrs)

    @staticmethod
    def _sample() -> bool:
        if _SAMPLE_RATE >= 1.0:
            return True
        if _SAMPLE_RATE <= 0.0:
            return False
        import random

        return random.random() < _SAMPLE_RATE

    def record_span(self, name: str, start: float, end: float,
                    ctx: Optional[Dict[str, Any]] = None,
                    parent_ctx: Optional[Dict[str, Any]] = None,
                    attrs: Optional[Dict[str, Any]] = None,
                    error: Optional[str] = None,
                    thread: Optional[str] = None):
        """Record a retrospective span from explicit timestamps (epoch
        seconds) — the engine's TTFT decomposition and the raylet's queue
        spans are reconstructed after the fact, not context-managed.

        ``ctx`` adopts ids (span IS the context); ``parent_ctx`` mints a
        fresh child span id under that parent. Unsampled/absent context
        records nothing.
        """
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
        RECORDER.record({
            "name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent_id, "start": start, "end": end,
            "thread": thread or threading.current_thread().name,
            "attrs": dict(attrs) if attrs else None, "error": error,
        })


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _ENABLED


def refresh_from_config():
    """Re-read the tracing flags (called at runtime startup; workers see
    the driver's _system_config through the propagated env)."""
    global _ENABLED, _SAMPLE_RATE
    _ENABLED = bool(GLOBAL_CONFIG.tracing_enabled)
    _SAMPLE_RATE = float(GLOBAL_CONFIG.trace_sample_rate)
    RECORDER.resize(GLOBAL_CONFIG.trace_buffer_spans)


# ------------------------------------------------------ context propagation


def capture() -> Optional[Dict[str, Any]]:
    """Current trace context (None when disabled or no trace active) —
    stash it to re-enter the trace from another thread/queue."""
    if not _ENABLED:
        return None
    return _trace_cv.get()


def set_current(ctx: Optional[Dict[str, Any]]):
    """Install `ctx` as the current trace context (a task spec's
    trace_ctx, or a captured context crossing a thread boundary)."""
    _trace_cv.set(ctx)


def current_ctx() -> Optional[Dict[str, Any]]:
    return _trace_cv.get()


def child_spec_ctx() -> Dict[str, str]:
    """A fresh propagation context for a task spec being submitted from
    the current context: same trace (or a new sampled-or-not root), the
    current span as parent. Always returns ids — task events use them
    for timeline grouping even with tracing off."""
    span_id = _rand_hex(8)
    cur = _trace_cv.get()
    if cur and cur.get("trace_id"):
        return {"trace_id": cur["trace_id"], "span_id": span_id,
                "parent_span_id": cur.get("span_id"),
                "sampled": bool(cur.get("sampled"))}
    return {"trace_id": _rand_hex(16), "span_id": span_id,
            "parent_span_id": None,
            "sampled": bool(_ENABLED and Tracer._sample())}


# Wire form on RPC envelopes: key "t" is [trace_id, span_id] for a sampled
# context, or the int 0 for "context present but sampled out" (so the far
# side suppresses head sampling instead of re-rolling mid-trace).


def wire_ctx():
    """Compact trace context for the RPC envelope, or None."""
    ctx = _trace_cv.get()
    if ctx is None:
        return None
    if not ctx.get("sampled"):
        return 0
    return [ctx["trace_id"], ctx["span_id"]]


def activate(ctx: Optional[Dict[str, Any]]) -> "contextvars.Token":
    """Install `ctx` and return the token for :func:`deactivate` — for
    carrying a captured context across an executor/thread boundary."""
    return _trace_cv.set(ctx)


def activate_wire(t) -> "contextvars.Token":
    """Server side: install the envelope's wire context; returns the
    token for :func:`deactivate`."""
    if t == 0 or not isinstance(t, (list, tuple)) or len(t) < 2:
        return _trace_cv.set(_UNSAMPLED_CTX)
    return _trace_cv.set({"trace_id": t[0], "span_id": t[1],
                          "sampled": True})


def deactivate(token: "contextvars.Token"):
    try:
        _trace_cv.reset(token)
    except ValueError:
        pass


# --------------------------------------------------------- W3C traceparent


def parse_traceparent(header: Optional[str]) -> Optional[Dict[str, Any]]:
    """``00-<32 hex trace>-<16 hex span>-<2 hex flags>`` -> context dict
    (flags bit 0 = sampled), or None if malformed."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        flags = int(parts[3], 16)
        int(parts[1], 16)
        int(parts[2], 16)
    except ValueError:
        return None
    return {"trace_id": parts[1], "span_id": parts[2],
            "sampled": bool(flags & 1)}


def format_traceparent(ctx: Optional[Dict[str, Any]] = None
                       ) -> Optional[str]:
    """Render the current (or given) context as a traceparent header."""
    ctx = ctx if ctx is not None else _trace_cv.get()
    if not ctx or not ctx.get("trace_id"):
        return None
    flags = "01" if ctx.get("sampled") else "00"
    trace = ctx["trace_id"].ljust(32, "0")[:32]
    span = ctx["span_id"].ljust(16, "0")[:16]
    return f"00-{trace}-{span}-{flags}"


# ------------------------------------------------------------------- flush


def set_enabled(on: bool) -> None:
    """Turn recording on or off in this process alone (the engine's tests
    and a driver that traces without a runtime); `refresh_from_config`
    sets it from the flag table at runtime start."""
    global _ENABLED
    _ENABLED = bool(on)


def drain() -> List[Dict[str, Any]]:
    """Pop every recorded span, error spans first (the recorder's order),
    dropping the drop count: the local read of what `drain_for_flush`
    hands the metrics flush."""
    return RECORDER.drain()[0]


def drain_for_flush() -> Tuple[List[Dict[str, Any]], int]:
    """(spans, dropped) since the last flush; empty when disabled (the
    recorder may still hold spans from a just-disabled session — drain
    them so memory is released)."""
    if not _ENABLED and not len(RECORDER):
        return [], 0
    return RECORDER.drain()
