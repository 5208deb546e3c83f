"""ByteBudget: the global in-flight byte budget of a pipeline execution.

A count-based executor throttled on block COUNTS (`max_buffered_blocks_per_op`),
which says nothing about memory: 16 buffered 128 MiB shuffle buckets and 16
buffered 4 KiB filter outputs were the same "16". The streaming ingest plane
replaces that with one byte budget shared by every operator of an execution
(reference: Ray Data's `StreamingExecutor` resource budgets,
`streaming_executor_state.py` `_execution_allowed`): operators `acquire()`
an estimated output size before submitting a task and the pump stalls when
the pipeline's total in-flight bytes would exceed the budget — so a shuffle
whose working set exceeds memory degrades into windows whose SEALED outputs
spill through the object store's disk tier, while the *unsealed* (in-flight)
set stays bounded and the node never OOMs.

Accounting is per-op: `stats()` reports, for each operator, bytes in flight
(high-water mark), blocks admitted, and seconds spent blocked on the budget
— the op with the largest blocked time is where the pipeline is bound.

The budget is negotiated against the local object store at execution start
(`negotiated()`): explicit knob first (`DataContext.inflight_budget_bytes` /
`RAY_TPU_DATA_INFLIGHT_BUDGET_BYTES`), else 25% of store capacity with a
64 MiB floor. One execution = one budget; nested stages (a shuffle driving
its parent pipeline) share the outermost budget via `pipeline_budget()`.

**Tenants.** On a multi-job node (jobs as tenants) every pipeline
execution ALSO charges a process-global per-tenant ledger, keyed by the
submitting job (`DataContext.resolved_tenant()`: explicit `tenant` field,
else RAY_TPU_TORCH_JOB_ID, else "default"). `data_tenant_budget_bytes` caps any
one tenant's in-flight bytes ACROSS its concurrent executions: admission
over the cap is refused — reject-with-backpressure, counted in
`tenant_stats()["rejections"]` — rather than letting one job's wide
shuffle silently starve every other job's pipeline out of the shared
store. Same progress guarantee as the budget itself: a tenant with
nothing in flight is always admitted, so a cap smaller than one block
degrades to block-at-a-time execution, never deadlock. Cross-budget
releases are observed by acquire()'s 1-second poll (budgets don't share
a condition variable — the poll bounds the staleness instead).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Iterator, Optional

_BUDGET_FLOOR = 64 * 1024 * 1024
_CAPACITY_FRACTION = 0.25

_op_seq = itertools.count(1)


def unique_op(name: str) -> str:
    """A ledger key that is unique per stage INSTANCE. Two executions can
    share one budget (nested stages on purpose; interleaved same-thread
    iterations through the thread-local by accident) — with instance
    keys, one execution's release_op can never zero a sibling's charges,
    and backpressure stats stay attributable."""
    return f"{name}#{next(_op_seq)}"


def _local_store_capacity() -> Optional[int]:
    """Capacity of this node's object store, best-effort: the in-process
    head node's store directly, else one debug_state RPC to the raylet."""
    import ray_tpu_torch

    node = getattr(ray_tpu_torch, "_global_node", None)
    if node is not None:
        try:
            return int(node.raylet.store.capacity)
        except Exception:  # noqa: BLE001 — node mid-shutdown
            pass
    runtime = getattr(ray_tpu_torch, "_global_runtime", None)
    if runtime is None:
        return None
    try:
        return int(runtime.raylet.call("debug_state", timeout=5)
                   ["store"]["capacity_bytes"])
    except Exception:  # noqa: BLE001 — no cluster / raylet unreachable
        return None


class _OpAccount:
    __slots__ = ("blocks", "bytes_in_flight", "bytes_hwm", "blocked_s",
                 "bytes_total")

    def __init__(self):
        self.blocks = 0
        self.bytes_in_flight = 0
        self.bytes_hwm = 0
        self.blocked_s = 0.0
        self.bytes_total = 0


class _TenantLedger:
    """Process-global per-tenant in-flight byte accounting, mirrored from
    every ByteBudget's ledger mutations. Own lock, always acquired AFTER
    a budget's condition lock (one-way ordering — no deadlock)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, Dict[str, int]] = {}

    def _slot(self, tenant: str) -> Dict[str, int]:
        slot = self._tenants.get(tenant)
        if slot is None:
            slot = self._tenants[tenant] = {
                "bytes_in_flight": 0, "bytes_hwm": 0, "bytes_total": 0,
                "rejections": 0}
        return slot

    @staticmethod
    def limit() -> int:
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG.data_tenant_budget_bytes

    def would_exceed(self, tenant: str, nbytes: int) -> bool:
        """Over the per-tenant cap? False when uncapped or when the
        tenant has nothing in flight (the tenant-level progress
        guarantee: an idle tenant always gets its first block)."""
        lim = self.limit()
        if lim <= 0:
            return False
        with self._lock:
            slot = self._slot(tenant)
            return (slot["bytes_in_flight"] > 0
                    and slot["bytes_in_flight"] + nbytes > lim)

    def add(self, tenant: str, delta: int) -> None:
        with self._lock:
            slot = self._slot(tenant)
            slot["bytes_in_flight"] = max(0, slot["bytes_in_flight"] + delta)
            if delta > 0:
                slot["bytes_total"] += delta
            slot["bytes_hwm"] = max(slot["bytes_hwm"],
                                    slot["bytes_in_flight"])

    def note_rejection(self, tenant: str) -> None:
        with self._lock:
            self._slot(tenant)["rejections"] += 1

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {t: dict(s) for t, s in self._tenants.items()}

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()


_TENANTS = _TenantLedger()


def tenant_stats() -> Dict[str, Dict[str, int]]:
    """Per-tenant in-flight/hwm/total bytes and budget rejections across
    every execution this process has run."""
    return _TENANTS.stats()


def reset_tenant_stats() -> None:
    _TENANTS.reset()


class ByteBudget:
    """Shared in-flight byte ledger with per-op backpressure accounting.

    Progress guarantee: an op with nothing in flight is always admitted,
    even when its single block exceeds the whole budget — otherwise a
    block larger than the budget would deadlock the pipeline instead of
    degrading it to window-at-a-time execution.

    Every ledger mutation mirrors into the process-global per-tenant
    ledger under the tenant resolved at construction, so concurrent
    executions of one job are capped TOGETHER by
    `data_tenant_budget_bytes` (see module docstring).
    """

    def __init__(self, total_bytes: int):
        self.total = int(total_bytes)
        self._used = 0
        self._cond = threading.Condition()
        self._ops: Dict[str, _OpAccount] = {}
        from ray_tpu_torch.data.context import DataContext

        self.tenant = DataContext.get_current().resolved_tenant()

    @classmethod
    def negotiated(cls) -> "ByteBudget":
        from ray_tpu_torch.data.context import DataContext

        configured = DataContext.get_current().resolved_inflight_budget_bytes()
        if configured > 0:
            return cls(configured)
        capacity = _local_store_capacity()
        if capacity is None:
            return cls(_BUDGET_FLOOR)
        return cls(max(_BUDGET_FLOOR, int(capacity * _CAPACITY_FRACTION)))

    # ------------------------------------------------------------- ledger

    def _account(self, op: str) -> _OpAccount:
        acct = self._ops.get(op)
        if acct is None:
            acct = self._ops[op] = _OpAccount()
        return acct

    def acquire(self, op: str, nbytes: int, timeout: Optional[float] = None
                ) -> bool:
        """Charge `nbytes` against the budget for `op`, blocking while the
        pipeline is over budget (unless this op has nothing in flight —
        the progress guarantee). Returns False only on timeout."""
        nbytes = max(0, int(nbytes))
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            acct = self._account(op)
            t0 = None
            while True:
                over_budget = (self._used + nbytes > self.total
                               and acct.bytes_in_flight > 0)
                # The tenant cap is checked INSIDE the wait loop: another
                # budget of the same tenant releasing bytes unblocks this
                # acquire at the next 1 s poll (no shared condition).
                over_tenant = _TENANTS.would_exceed(self.tenant, nbytes)
                if not (over_budget or over_tenant):
                    break
                if t0 is None:
                    t0 = time.monotonic()
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    acct.blocked_s += time.monotonic() - t0
                    if over_tenant:
                        # Reject-with-backpressure, and make the denial
                        # visible — never silent starvation.
                        _TENANTS.note_rejection(self.tenant)
                    return False
                self._cond.wait(min(1.0, remaining)
                                if remaining is not None else 1.0)
            if t0 is not None:
                acct.blocked_s += time.monotonic() - t0
            self._used += nbytes
            acct.blocks += 1
            acct.bytes_in_flight += nbytes
            acct.bytes_total += nbytes
            acct.bytes_hwm = max(acct.bytes_hwm, acct.bytes_in_flight)
            _TENANTS.add(self.tenant, nbytes)
            return True

    def try_acquire(self, op: str, nbytes: int) -> bool:
        """Non-blocking acquire. Single-threaded pumps MUST use this (a
        blocking acquire would deadlock: the pump's own yield path is the
        only thing that releases charges) and drain their in-flight work
        on refusal, crediting the wait via `note_blocked`."""
        return self.acquire(op, nbytes, timeout=0)

    def note_blocked(self, op: str, seconds: float):
        """Credit budget-blocked time observed OUTSIDE acquire() (the
        try_acquire/drain pattern) to the op's backpressure account."""
        with self._cond:
            self._account(op).blocked_s += max(0.0, seconds)

    def adjust(self, op: str, delta: int):
        """Re-charge an in-flight block once its ACTUAL size is known
        (acquire charged the op's estimate). Never blocks: the bytes
        already exist; the correction only makes future admission honest."""
        with self._cond:
            acct = self._account(op)
            delta = max(delta, -acct.bytes_in_flight)
            self._used += delta
            acct.bytes_in_flight += delta
            acct.bytes_total += max(0, delta)
            acct.bytes_hwm = max(acct.bytes_hwm, acct.bytes_in_flight)
            _TENANTS.add(self.tenant, delta)
            if delta < 0:
                self._cond.notify_all()

    def release(self, op: str, nbytes: int):
        with self._cond:
            acct = self._account(op)
            nbytes = min(max(0, int(nbytes)), acct.bytes_in_flight)
            self._used = max(0, self._used - nbytes)
            acct.bytes_in_flight -= nbytes
            _TENANTS.add(self.tenant, -nbytes)
            self._cond.notify_all()

    def release_op(self, op: str):
        """Drop everything an op still has charged (execution finished or
        aborted). The account itself is retained for `stats()` — the key
        space is the stage names of ONE execution (bounded by the plan)
        and the budget dies with its execution; `reset()` is the drain
        for callers that reuse a budget across executions."""
        with self._cond:
            acct = self._ops.get(op)
            if acct is not None and acct.bytes_in_flight:
                self._used = max(0, self._used - acct.bytes_in_flight)
                _TENANTS.add(self.tenant, -acct.bytes_in_flight)
                acct.bytes_in_flight = 0
            self._cond.notify_all()

    def reset(self):
        """Forget every charge and account (reusing a budget across
        executions starts from a clean ledger)."""
        with self._cond:
            self._ops.clear()
            _TENANTS.add(self.tenant, -self._used)
            self._used = 0
            self._cond.notify_all()

    # -------------------------------------------------------------- stats

    @property
    def used(self) -> int:
        with self._cond:
            return self._used

    def stats(self) -> Dict[str, Any]:
        """Per-op backpressure: where the pipeline is bound."""
        with self._cond:
            ops = {
                op: {"blocks": a.blocks, "bytes_total": a.bytes_total,
                     "bytes_in_flight": a.bytes_in_flight,
                     "bytes_hwm": a.bytes_hwm,
                     "blocked_s": round(a.blocked_s, 4)}
                for op, a in self._ops.items()
            }
            bound = max(ops, key=lambda o: ops[o]["blocked_s"]) \
                if ops else None
        return {"total_bytes": self.total, "used_bytes": self._used,
                "tenant": self.tenant, "ops": ops, "bound_op": bound}


# --- execution-scoped budget sharing ----------------------------------------
#
# A pipeline execution is a driver-side call tree: the fused-transform
# executor of a shuffle's OUTPUT iterates the shuffle, which iterates the
# parent dataset's executor. One budget must govern the whole tree (a
# per-stage budget would multiply the cap by pipeline depth), so the
# outermost stage installs the budget here and inner stages adopt it.

_tls = threading.local()


def current_budget() -> Optional[ByteBudget]:
    return getattr(_tls, "budget", None)


@contextlib.contextmanager
def pipeline_budget(budget: Optional[ByteBudget] = None
                    ) -> Iterator[ByteBudget]:
    """Adopt the execution's budget, or install `budget` (negotiating a
    fresh one when None) as the tree's budget if this is the outermost
    stage."""
    existing = current_budget()
    if existing is not None:
        yield existing
        return
    owned = budget if budget is not None else ByteBudget.negotiated()
    _tls.budget = owned
    try:
        yield owned
    finally:
        _tls.budget = None
