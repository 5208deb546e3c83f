"""Trace exports: span trees and Chrome trace-event (Perfetto) JSON.

Spans arrive as flat dicts (see `tracing.Span.end` for the schema, plus a
``proc`` key the GCS stamps from the reporter id). Two consumers:

- :func:`span_tree` — the `/api/traces/<trace_id>` JSON: spans of one
  trace nested by parent_id, children sorted by start time.
- :func:`chrome_trace_events` — the `/api/timeline` payload: the Chrome
  trace-event format (`catapult` JSON, loadable in Perfetto / legacy
  chrome://tracing) with one track ("process") per reporting process and
  one thread row per recorded thread name.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def span_tree(spans: List[Dict[str, Any]],
              trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Nest the given spans (optionally filtered to one trace) by
    parent_id. Spans whose parent is absent from the set are roots."""
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace_id") == trace_id]
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: List[Dict[str, Any]] = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def _sort(nodes):
        nodes.sort(key=lambda n: n.get("start") or 0.0)
        for n in nodes:
            _sort(n["children"])
    _sort(roots)
    return {"trace_id": trace_id, "span_count": len(spans), "roots": roots}


def chrome_trace_events(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Render spans as Chrome trace events.

    Every span becomes one complete ("X") event; pids/tids are stable
    small integers with process_name / thread_name metadata events so the
    viewer shows the reporter id and thread name. Timestamps are epoch
    microseconds (Perfetto handles the large offsets fine).
    """
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        proc = s.get("proc") or "unknown"
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": proc}})
        thread = s.get("thread") or "main"
        tid = tids.get((proc, thread))
        if tid is None:
            tid = tids[(proc, thread)] = \
                sum(1 for k in tids if k[0] == proc) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": thread}})
        start = float(s.get("start") or 0.0)
        end = float(s.get("end") or start)
        args: Dict[str, Any] = {"trace_id": s.get("trace_id"),
                                "span_id": s.get("span_id"),
                                "parent_id": s.get("parent_id")}
        if s.get("attrs"):
            args.update(s["attrs"])
        if s.get("error"):
            args["error"] = s["error"]
        events.append({
            "ph": "X",
            "name": s.get("name") or "span",
            "cat": "ray_tpu_torch" + (",error" if s.get("error") else ""),
            "ts": start * 1e6,
            "dur": max(0.0, (end - start) * 1e6),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
