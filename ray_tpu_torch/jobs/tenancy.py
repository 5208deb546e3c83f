"""Jobs-as-tenants: per-job admission for the raylet dispatch loop.

The serve plane enforces tenant quotas at the proxy (async WFQ +
token bucket in `tenancy/admission.py`); batch jobs never pass a proxy —
their task storms land straight in the raylet queue. This module is the
dispatch-loop counterpart: synchronous, called with the raylet's queue
lock held, so it must stay O(1) per decision with no blocking.

- **Stride scheduling** replaces virtual-time WFQ (same fairness
  guarantee, simpler without an event loop): each job carries a `pass`
  value advanced by `1/weight` per dispatched task; the dispatcher
  offers the next slot to the backlogged job with the LOWEST pass, so a
  weight-8 (gold) job gets ~8 dispatches for every one a weight-1
  (bronze) job gets, and an idle job re-enters at the current global
  pass (no banked credit, no starvation).
- **Token bucket** (`rps_limit`/`burst` from the job's TenantSpec) caps
  a job's dispatch RATE outright; a throttled job's tasks stay queued
  and the 0.2 s dispatch tick retries — tasks are never rejected, only
  delayed (unlike the proxy's fast 429, a queued task has nowhere to
  bounce back to).

Jobs register from the GCS JOB-channel "running" event (tenant QoS rides
along) and unregister on "finished" — including interactive drivers that
never went through submit_job (every driver job publishes both events),
so entries cannot outlive their job.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional

from ray_tpu_torch.tenancy.admission import TokenBucket
from ray_tpu_torch.tenancy.registry import TIER_WEIGHTS


class _JobEntry:
    __slots__ = ("weight", "bucket", "pass_value", "name")

    def __init__(self, weight: float, bucket: Optional[TokenBucket],
                 pass_value: float, name: str):
        self.weight = max(1.0, float(weight))
        self.bucket = bucket
        self.pass_value = pass_value
        self.name = name


class JobAdmission:
    """Per-job dispatch admission keyed by driver JobID hex.

    All methods are called from the raylet dispatch thread (under the
    queue lock) plus the GCS-push thread for register/unregister — the
    touched state is plain dict/float ops, safe under the GIL for this
    read-mostly pattern; the dispatch loop re-checks feasibility anyway.
    """

    def __init__(self, default_weight: float = 4.0):
        self._default_weight = max(1.0, float(default_weight))
        # job hex -> entry; bounded by live jobs: unregister() runs on
        # every job's "finished" event (GCS publishes it for submitted
        # AND interactive drivers alike).
        self._jobs: Dict[str, _JobEntry] = {}
        self._global_pass = 0.0

    # ------------------------------------------------------------ lifecycle

    def register(self, job_hex: str, qos: Optional[Dict[str, Any]]) -> None:
        qos = qos or {}
        weight = qos.get("weight") or TIER_WEIGHTS.get(
            qos.get("tier", ""), self._default_weight)
        rps = float(qos.get("rps_limit") or 0.0)
        bucket = TokenBucket(rps, float(qos.get("burst") or rps)) \
            if rps > 0 else None
        entry = self._jobs.get(job_hex)
        if entry is None:
            self._jobs[job_hex] = _JobEntry(
                weight, bucket, self._global_pass, qos.get("name", ""))
        else:  # quota update: rebuild rate state, keep the stride pass
            entry.weight = max(1.0, float(weight))
            entry.bucket = bucket
            entry.name = qos.get("name", "")

    def unregister(self, job_hex: str) -> None:
        self._jobs.pop(job_hex, None)

    def _entry(self, job_hex: str) -> _JobEntry:
        entry = self._jobs.get(job_hex)
        if entry is None:
            # Interactive driver the push hasn't announced (or raced):
            # default weight, unmetered. Its "finished" event still
            # reaches unregister(), so lazy entries are reclaimed too.
            entry = self._jobs[job_hex] = _JobEntry(
                self._default_weight, None, self._global_pass, "")
        return entry

    # ------------------------------------------------------------ dispatch

    def order(self, job_hexes: Iterable[str]) -> List[str]:
        """Backlogged jobs in stride order (lowest pass first — the job
        the fair schedule owes the next dispatch slot)."""
        return sorted(set(job_hexes),
                      key=lambda h: self._entry(h).pass_value)

    def admit(self, job_hex: str, now: Optional[float] = None) -> float:
        """Charge one dispatch to the job. 0.0 = admitted (token taken,
        stride pass advanced); > 0 = throttled for that many seconds
        (nothing consumed — the task stays queued)."""
        entry = self._entry(job_hex)
        if entry.bucket is not None:
            wait = entry.bucket.take(
                time.monotonic() if now is None else now)
            if wait > 0.0:
                return wait
        entry.pass_value += 1.0 / entry.weight
        self._global_pass = max(self._global_pass, entry.pass_value)
        return 0.0

    def refund(self, job_hex: str) -> None:
        """Undo an admit whose dispatch could not complete (resource
        acquire lost a race): give the token and the stride turn back so
        the failed attempt doesn't count against the job's share."""
        entry = self._jobs.get(job_hex)
        if entry is None:
            return
        entry.pass_value = max(0.0, entry.pass_value - 1.0 / entry.weight)
        if entry.bucket is not None:
            entry.bucket._tokens = min(entry.bucket.burst,
                                       entry.bucket._tokens + 1.0)

    # ------------------------------------------------------------ introspect

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {h: {"weight": e.weight, "pass": round(e.pass_value, 4),
                    "tenant": e.name, "metered": e.bucket is not None}
                for h, e in self._jobs.items()}
