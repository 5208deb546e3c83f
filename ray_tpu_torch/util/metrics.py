"""User-facing metrics API + process-local registry.

Equivalent of the reference's `ray.util.metrics` (`python/ray/util/metrics.py`)
backed by its native stats layer (`src/ray/stats/metric.h:103`,
`metrics_agent.py:375`). Redesigned for this runtime: each process keeps a
lock-protected registry; the CoreRuntime flushes snapshots to the GCS on a
short period; the GCS aggregates per-process series and renders Prometheus
text exposition (served by the dashboard's /metrics route).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_TagKey = Tuple[Tuple[str, str], ...]


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, "Metric"] = {}

    def register(self, metric: "Metric") -> "Optional[Metric]":
        """Register `metric`; if a same-name same-type metric already
        exists, KEEP it and return it so the new instance adopts its
        series — re-constructing a metric (e.g. a re-created deployment)
        must not silently reset the accumulated time series."""
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{type(existing).__name__}")
                return existing
            self._metrics[metric.name] = metric
            return None

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [m._snapshot() for m in self._metrics.values()]


GLOBAL_REGISTRY = _Registry()


def _tag_tuple(tags: Optional[Dict[str, str]],
               default: Dict[str, str]) -> _TagKey:
    merged = dict(default)
    if tags:
        merged.update(tags)
    return tuple(sorted(merged.items()))


class Metric:
    """Base: named, tagged, per-process time series."""

    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not name or any(c in name for c in " \n\t"):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._series: Dict[_TagKey, float] = {}
        existing = GLOBAL_REGISTRY.register(self)
        if existing is not None:
            self._adopt(existing)

    def _adopt(self, existing: "Metric"):
        """Share state with the registry's canonical instance: increments
        on this (re-constructed) metric land in the existing series."""
        self._lock = existing._lock
        self._series = existing._series

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "description": self.description,
                    "series": [(list(k), v) for k, v in self._series.items()]}


class Counter(Metric):
    """Monotonically increasing count (reference metrics.Counter)."""

    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("Counter.inc value must be >= 0")
        key = _tag_tuple(tags, self._default_tags)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(Metric):
    """Point-in-time value (reference metrics.Gauge)."""

    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tag_tuple(tags, self._default_tags)
        with self._lock:
            self._series[key] = float(value)


class Histogram(Metric):
    """Bucketed distribution (reference metrics.Histogram): cumulative
    bucket counts + sum + count, Prometheus-style."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (), tag_keys: Sequence[str] = ()):
        if not boundaries or list(boundaries) != sorted(boundaries):
            raise ValueError("Histogram needs sorted, non-empty boundaries")
        self.boundaries = tuple(float(b) for b in boundaries)
        # Before register (in super().__init__) — the flusher thread may
        # snapshot the registry the instant the metric appears in it.
        self._hist: Dict[_TagKey, dict] = {}
        super().__init__(name, description, tag_keys)

    def _adopt(self, existing: "Metric"):
        if getattr(existing, "boundaries", None) != self.boundaries:
            raise ValueError(
                f"histogram {self.name!r} already registered with "
                f"boundaries {existing.boundaries}")
        super()._adopt(existing)
        self._hist = existing._hist

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tag_tuple(tags, self._default_tags)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = {
                    "buckets": [0] * (len(self.boundaries) + 1),
                    "sum": 0.0, "count": 0}
            idx = len(self.boundaries)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    idx = i
                    break
            h["buckets"][idx] += 1
            h["sum"] += value
            h["count"] += 1

    def _snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "description": self.description,
                    "boundaries": list(self.boundaries),
                    "series": [(list(k), dict(v, buckets=list(v["buckets"])))
                               for k, v in self._hist.items()]}


# --------------------------------------------------------------------------- #
# Prometheus text exposition (rendered GCS-side from aggregated snapshots)
# --------------------------------------------------------------------------- #


def _fmt_tags(pairs: List) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + inner + "}"


def render_prometheus(snapshots: Dict[str, List[dict]]) -> str:
    """snapshots: reporter id -> list of metric snapshot dicts. Series from
    different reporters get a `proc` tag so they never collide."""
    by_name: Dict[str, List[Tuple[str, dict]]] = {}
    for proc, metrics in snapshots.items():
        for m in metrics:
            by_name.setdefault(m["name"], []).append((proc, m))
    out: List[str] = []
    for name in sorted(by_name):
        entries = by_name[name]
        kind = entries[0][1]["kind"]
        desc = entries[0][1]["description"]
        prom = name.replace(".", "_").replace("-", "_")
        if desc:
            out.append(f"# HELP {prom} {desc}")
        out.append(f"# TYPE {prom} "
                   f"{'histogram' if kind == 'histogram' else kind}")
        for proc, m in entries:
            for pairs, value in m["series"]:
                tags = list(pairs) + [("proc", proc)]
                if kind == "histogram":
                    bounds = m["boundaries"]
                    cum = 0
                    for i, b in enumerate(bounds):
                        cum += value["buckets"][i]
                        out.append(f"{prom}_bucket"
                                   f"{_fmt_tags(tags + [('le', b)])} {cum}")
                    total = cum + value["buckets"][len(bounds)]
                    out.append(f"{prom}_bucket"
                               f"{_fmt_tags(tags + [('le', '+Inf')])} {total}")
                    out.append(f"{prom}_sum{_fmt_tags(tags)} {value['sum']}")
                    out.append(f"{prom}_count{_fmt_tags(tags)} "
                               f"{value['count']}")
                else:
                    out.append(f"{prom}{_fmt_tags(tags)} {value}")
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------- #
# Background flusher: pushes this process's registry to the GCS
# --------------------------------------------------------------------------- #


class MetricsPusher:
    """Flushes this process's metric registry AND its tracing flight
    recorder to the GCS on one cadence (one RPC carries both — the
    tracing plane piggybacks here instead of adding its own thread).

    `node` is the owning node's hex id when known: the GCS uses it to
    expire this reporter's snapshot the moment the node dies, instead of
    serving a ghost series from /metrics forever."""

    def __init__(self, gcs_client, reporter_id: str, period_s: float = 2.0,
                 node: "Optional[str]" = None):
        self._gcs = gcs_client
        self._id = reporter_id
        self._period = period_s
        self._node = node
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="metrics-push", daemon=True)

    def start(self):
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._period):
            self.flush()

    def flush(self):
        from ray_tpu_torch.observability import tracing

        spans, dropped = tracing.drain_for_flush()
        try:
            snap = GLOBAL_REGISTRY.snapshot()
            if not snap and not spans and not dropped:
                return
            payload = {"reporter": self._id, "metrics": snap,
                       "ts": time.time(), "period_s": self._period,
                       "node": self._node}
            if spans or dropped:
                payload["spans"] = spans
                payload["spans_dropped"] = dropped
            self._gcs.call("metrics_report", payload, timeout=5)
        except Exception:  # noqa: BLE001 — metrics are best-effort, and a
            # single bad snapshot must not kill the flusher thread.
            # Metrics re-snapshot next period, but the DRAINED spans
            # would be gone: put them (and their drop count) back so a
            # GCS hiccup delays trace delivery instead of losing it.
            tracing.RECORDER.restore(spans, dropped)

    def stop(self):
        self._stop.set()
        self.flush()
