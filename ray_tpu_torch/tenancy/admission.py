"""Proxy-side tenant admission: token buckets, in-flight caps, WFQ.

Enforcement lives where requests arrive (the proxy event loop), off the
pushed routing table — per-request enforcement never issues an RPC. The
pipeline, in order (docs/SERVE_DATAPLANE.md "admission ordering"):

1. **Token bucket** (rps_limit/burst): an over-rate request is answered
   immediately with `QuotaExceeded` (HTTP 429 + Retry-After) — it never
   occupies a replica slot, a park buffer, or a queue position. Fast
   rejection is the point: a tenant blasting 10x its quota costs the
   proxy one dict lookup + two float ops per excess request.
2. **In-flight cap** (max_inflight): bounds a tenant's concurrently
   executing requests per proxy, also a fast 429 (the work already in
   flight IS the retry-after signal).
3. **Weighted fair queueing**: requests that pass their quota but find
   every replica saturated wait in per-tenant queues drained in
   virtual-time order — a hot tenant's backlog queues behind its own
   weight, so it cannot starve a lighter tier no matter how deep its
   queue grows.

Everything here is event-loop-confined (one instance per proxy process,
all calls from that proxy's asyncio loop) — no locks, by design.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional

from ray_tpu_torch.tenancy.registry import TenantSpec


class QuotaExceeded(RuntimeError):
    """Tenant over its rate or in-flight quota: answer 429, never park."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = max(0.0, retry_after_s)


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill, `burst` capacity.

    `take()` either admits (returns 0.0) or returns the seconds until a
    token will be available — the 429's Retry-After. Lazy refill: no
    timer, two float ops per call.
    """

    __slots__ = ("rate", "burst", "_tokens", "_last")

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._last = time.monotonic() if now is None else now

    def take(self, now: Optional[float] = None, cost: float = 1.0) -> float:
        now = time.monotonic() if now is None else now
        if now > self._last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
        if self._tokens >= cost:
            self._tokens -= cost
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (cost - self._tokens) / self.rate


class _TenantState:
    __slots__ = ("spec", "bucket", "inflight", "seen_version")

    def __init__(self, spec: TenantSpec):
        self.spec = spec
        self.bucket = (TokenBucket(spec.rps_limit, spec.burst)
                       if spec.rps_limit else None)
        self.inflight = 0
        self.seen_version = -1


class TenantAdmission:
    """Per-proxy quota enforcement keyed by tenant name.

    Tenant state is (re)built from the QoS dict each routing-table entry
    carries; `prune(live)` drops state for tenants that left the table
    (deployment churn must not grow this registry forever)."""

    def __init__(self):
        # raylint: confine=loop
        self._tenants: Dict[str, _TenantState] = {}

    def resolve(self, entry: Optional[Dict[str, Any]]
                ) -> Optional[_TenantState]:
        """Tenant state for a routing-table entry (None = untenanted
        deployment: unmetered, default weight)."""
        if not entry:
            return None
        qos = entry.get("qos")
        if not qos:
            return None
        name = qos["name"]
        state = self._tenants.get(name)
        version = entry.get("qos_version", 0)
        if state is None:
            state = self._tenants[name] = _TenantState(TenantSpec(**qos))
            state.seen_version = version
        elif version > state.seen_version:
            # Quota update pushed: rebuild the bucket, keep inflight.
            state.spec = TenantSpec(**qos)
            state.bucket = (TokenBucket(state.spec.rps_limit,
                                        state.spec.burst)
                            if state.spec.rps_limit else None)
            state.seen_version = version
        return state

    def admit(self, state: Optional[_TenantState]) -> None:
        """Quota gate; raises QuotaExceeded (the caller answers 429).
        On success the caller owns one in-flight slot — `release(state)`
        exactly once when the request completes."""
        if state is None:
            return
        spec = state.spec
        if spec.max_inflight and state.inflight >= spec.max_inflight:
            raise QuotaExceeded(
                f"tenant {spec.name!r} is at its in-flight cap "
                f"({spec.max_inflight})", retry_after_s=0.05)
        if state.bucket is not None:
            wait = state.bucket.take()
            if wait > 0.0:
                raise QuotaExceeded(
                    f"tenant {spec.name!r} is over its {spec.rps_limit:g} "
                    "rps quota", retry_after_s=min(wait, 30.0))
        state.inflight += 1

    @staticmethod
    def release(state: Optional[_TenantState]) -> None:
        if state is not None and state.inflight > 0:
            state.inflight -= 1

    def prune(self, live_names) -> None:
        for name in list(self._tenants):
            if name not in live_names:
                del self._tenants[name]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {name: {"inflight": st.inflight,
                       "tier": st.spec.tier,
                       "weight": st.spec.weight}
                for name, st in self._tenants.items()}


class _Waiter:
    __slots__ = ("fut", "try_reserve", "finish")

    def __init__(self, fut, try_reserve, finish: float):
        self.fut = fut
        self.try_reserve = try_reserve
        self.finish = finish


class WfqScheduler:
    """Virtual-time weighted fair queueing over contended dispatch.

    Waiters park in per-tenant FIFO queues; each carries a virtual
    finish time ``start + 1/weight`` where ``start = max(global vtime,
    tenant's last finish)`` — the classic WFQ recurrence with unit cost
    per request. The pump drains heads in ascending finish order; a
    tenant at weight 8 therefore gets ~8 queue turns for every turn a
    weight-1 tenant gets, and an idle tenant's first request lands at
    the global vtime (no banked credit, no starvation).

    A waiter's ``try_reserve`` is a zero-arg callable returning a
    replica choice or None; heads whose deployment is still saturated
    are skipped (another head may target a deployment with room).
    Queues are keyed by (tenant, deployment) while the virtual clock
    chains per TENANT — fairness is a tenant property, but FIFO order
    only binds requests contending for the SAME replica pool, so one
    saturated deployment can never head-of-line-block the same
    tenant's (or the untenanted pool's) traffic to a deployment with
    free capacity.
    """

    PUMP_MIN_S = 0.002
    PUMP_MAX_S = 0.032

    def __init__(self):
        # Lock-free BY DESIGN (module docstring): every touch happens on
        # the owning proxy's asyncio loop. The annotations make that a
        # checked contract — RL016 fails the gate if this state becomes
        # reachable from an executor thread.
        self._queues: Dict[tuple, Deque[_Waiter]] = {}  # raylint: confine=loop
        # raylint: confine=loop
        self._tenant_finish: Dict[str, float] = {}
        self._vtime = 0.0
        self._pump_task: Optional[asyncio.Task] = None

    def has_waiters(self) -> bool:
        return any(self._queues.values())

    def has_waiters_for(self, deployment: str) -> bool:
        """Whether anyone is queued for THIS deployment's replica pool.
        Fairness only binds requests contending for the same pool, so
        the dispatch fast path bypasses the queue for other deployments
        even while this one is backed up."""
        return any(q for key, q in self._queues.items()
                   if key[1] == deployment)

    def queued(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return sum(len(q) for key, q in self._queues.items()
                       if key[0] == (tenant or ""))
        return sum(len(q) for q in self._queues.values())

    async def acquire(self, loop, tenant: Optional[str], weight: float,
                      try_reserve: Callable[[], Any],
                      timeout_s: float, deployment: str = "",
                      on_drop: Optional[Callable[[Any], None]] = None):
        """Park until this waiter's WFQ turn yields a replica choice.
        Raises TimeoutError when no turn produced capacity in time.

        `on_drop` receives a granted choice the waiter can no longer
        consume (timeout/cancellation raced the pump's grant): the
        grant carries an already-reserved router slot, and dropping it
        silently would leak that replica's concurrency forever."""
        name = tenant or ""
        start = max(self._vtime, self._tenant_finish.get(name, 0.0))
        finish = start + 1.0 / max(1.0, float(weight))
        self._tenant_finish[name] = finish
        fut = loop.create_future()
        key = (name, deployment)
        queue = self._queues.get(key)
        if queue is None:
            queue = self._queues[key] = deque()
        queue.append(_Waiter(fut, try_reserve, finish))
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = loop.create_task(self._pump())

        def _drop_grant():
            if on_drop is not None and fut.done() \
                    and not fut.cancelled() and fut.exception() is None:
                on_drop(fut.result())

        try:
            return await asyncio.wait_for(fut, timeout_s)
        except asyncio.TimeoutError:
            _drop_grant()   # grant raced the timeout: give it back
            raise TimeoutError(
                "no replica capacity within "
                f"{timeout_s:.0f}s (tenant {tenant!r} fair-queued)")
        except asyncio.CancelledError:
            # Client disconnect cancelled the dispatching task; on
            # interpreters where wait_for re-raises the cancellation
            # even for a completed future (py >= 3.12), the grant would
            # otherwise vanish with its reserved slot.
            _drop_grant()
            raise
        # Cancelled/timed-out waiters stay in their deque; the pump
        # discards done futures when their turn comes.

    async def _pump(self):
        """Single drain task per scheduler: admit in virtual-time order
        while anyone waits, polling capacity with capped backoff (the
        router has no loop-side free-slot callback by design)."""
        backoff = self.PUMP_MIN_S
        while self.has_waiters():
            if self._drain_once():
                backoff = self.PUMP_MIN_S
                continue
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self.PUMP_MAX_S)
        self._pump_task = None
        # Bounded state under tenant churn: with no waiters left, the
        # virtual clock can reset (fairness is only defined while a
        # backlog exists) and per-tenant tails go with it.
        if not self.has_waiters():
            self._queues.clear()
            self._tenant_finish.clear()
            self._vtime = 0.0

    def _drain_once(self) -> bool:
        """One admission sweep in finish-time order. Returns whether any
        waiter was admitted (progress resets the pump backoff)."""
        heads = []
        for key, queue in self._queues.items():
            while queue and queue[0].fut.done():
                queue.popleft()   # timed out / cancelled waiter
            if queue:
                heapq.heappush(heads, (queue[0].finish, key))
        admitted = False
        while heads:
            finish, key = heapq.heappop(heads)
            queue = self._queues.get(key)
            if not queue or queue[0].finish != finish \
                    or queue[0].fut.done():
                continue
            choice = queue[0].try_reserve()
            if choice is None:
                continue  # this head's deployment is still saturated
            waiter = queue.popleft()
            self._vtime = max(self._vtime, waiter.finish)
            waiter.fut.set_result(choice)
            admitted = True
            while queue and queue[0].fut.done():
                queue.popleft()
            if queue:
                heapq.heappush(heads, (queue[0].finish, key))
        return admitted
