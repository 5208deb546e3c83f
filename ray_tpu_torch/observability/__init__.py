"""ray_tpu_torch.observability: the distributed tracing plane (counterpart
of `ray_tpu.observability`).

    from ray_tpu_torch.observability import get_tracer

    with get_tracer().start_span("my.operation", attrs={"k": "v"}):
        ...  # children (tasks, actor calls, RPCs) join this trace

Exports land in the GCS; `export.span_tree` and `chrome_trace_events`
turn a trace's spans into a tree or a Chrome-trace timeline.
"""

from ray_tpu_torch.observability.tracing import (  # noqa: F401
    NOOP_SPAN,
    FlightRecorder,
    Span,
    Tracer,
    capture,
    current_ctx,
    enabled,
    format_traceparent,
    get_tracer,
    parse_traceparent,
    refresh_from_config,
)
from ray_tpu_torch.observability.export import (  # noqa: F401
    chrome_trace_events,
    span_tree,
)

__all__ = [
    "FlightRecorder", "NOOP_SPAN", "Span", "Tracer", "capture",
    "chrome_trace_events", "current_ctx", "enabled", "format_traceparent",
    "get_tracer", "parse_traceparent", "refresh_from_config", "span_tree",
]
