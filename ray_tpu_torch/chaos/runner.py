"""ChaosRunner: executes a ChaosSchedule against a live cluster.

One background thread walks the schedule in order: at each event's firing
time it dispatches to the registered injector, then polls the injector's
recovery probe under the recovery deadline. Every fault becomes a
`FaultRecord` with a measured detect→recovered MTTR — or, past the
deadline, a STUCK record that `assert_recovered()` turns into a loud
attributed failure (bounded recovery is the contract, not best-effort).
The executed event log (`executed_signatures`) equals the schedule's
`signatures()`, which is how bench output proves a run is reproducible
from its seed.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.chaos.injectors import Injector
from ray_tpu_torch.chaos.schedule import ChaosSchedule
from ray_tpu_torch.core.config import GLOBAL_CONFIG

logger = logging.getLogger(__name__)


class ChaosRecoveryError(RuntimeError):
    """A fault's recovery outlived the deadline (attributed per record)."""


@dataclass
class FaultRecord:
    seq: int
    kind: str
    detail: Dict[str, Any]
    injected_at: float          # monotonic, after inject() returned
    mttr_ms: Optional[float] = None   # None while recovering / when stuck
    recovered: bool = False
    skipped: bool = False
    signature: tuple = field(default_factory=tuple)


class ChaosRunner:
    def __init__(self, cluster, schedule: ChaosSchedule,
                 injectors: Dict[str, Injector],
                 recovery_deadline_s: Optional[float] = None,
                 poll_s: float = 0.05,
                 on_fault=None):
        self.cluster = cluster
        self.schedule = schedule
        self.injectors = dict(injectors)
        missing = {e.kind for e in schedule.events} - set(self.injectors)
        if missing:
            raise ValueError(f"schedule uses kinds with no injector: "
                             f"{sorted(missing)}")
        self.recovery_deadline_s = (
            recovery_deadline_s if recovery_deadline_s is not None
            else (GLOBAL_CONFIG.chaos_recovery_deadline_s or 60.0))
        self.poll_s = poll_s
        self.on_fault = on_fault   # callback(record) after recovery resolves
        self.records: List[FaultRecord] = []
        self.executed_signatures: List[tuple] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.started_at: Optional[float] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ChaosRunner":
        self.started_at = time.monotonic()
        self._thread = threading.Thread(target=self._run,
                                        name="chaos-runner", daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 30.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
        # Safety: a stopped run must never leave an RPC fault filter
        # installed (the A-B-A inertness check depends on it).
        for inj in self.injectors.values():
            close = getattr(inj, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — cleanup is best-effort
                    logger.debug("injector close failed", exc_info=True)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the whole schedule has executed (and recovery of
        the last fault resolved). True when it finished in time."""
        if self._thread is None:
            return True
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def __enter__(self) -> "ChaosRunner":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------ execution

    def _run(self):
        t0 = self.started_at
        for event in self.schedule.events:
            # Wait for the event's firing time (a prior fault's recovery
            # may already have pushed us past it — inject immediately
            # then; the schedule's ORDER is the contract, not its exact
            # wall-clock spacing).
            delay = t0 + event.t - time.monotonic()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            self._fire(event)

    def _fire(self, event):
        injector = self.injectors[event.kind]
        try:
            detail = injector.inject(event)
        except Exception as e:  # noqa: BLE001 — a broken injector must not
            # kill the run silently; record it as an injection failure.
            logger.exception("chaos: injector %s failed", event.kind)
            detail = {"skipped": f"inject raised {type(e).__name__}: {e}"}
        self.executed_signatures.append(event.signature())
        rec = FaultRecord(seq=event.seq, kind=event.kind, detail=detail,
                          injected_at=time.monotonic(),
                          signature=event.signature(),
                          skipped="skipped" in detail)
        self.records.append(rec)
        if rec.skipped:
            return
        deadline = rec.injected_at + self.recovery_deadline_s
        while not self._stop.is_set():
            try:
                if injector.recovered():
                    rec.recovered = True
                    rec.mttr_ms = round(
                        (time.monotonic() - rec.injected_at) * 1e3, 1)
                    break
            except Exception:  # noqa: BLE001 — probe hiccup ≠ stuck yet
                logger.debug("chaos: recovery probe for %s raised",
                             event.kind, exc_info=True)
            if time.monotonic() > deadline:
                logger.critical(
                    "chaos: fault #%d (%s, %s) NOT recovered within "
                    "%.1fs — recording as stuck", rec.seq, rec.kind,
                    rec.detail, self.recovery_deadline_s)
                break
            time.sleep(self.poll_s)
        if self.on_fault is not None:
            try:
                self.on_fault(rec)
            except Exception:  # noqa: BLE001 — observer must not stop chaos
                logger.exception("chaos on_fault callback failed")

    # ------------------------------------------------------------ reporting

    def mttr_by_kind(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for rec in self.records:
            if rec.skipped or rec.mttr_ms is None:
                continue
            agg = out.setdefault(rec.kind,
                                 {"count": 0, "mean_ms": 0.0, "max_ms": 0.0})
            agg["count"] += 1
            agg["mean_ms"] += rec.mttr_ms
            agg["max_ms"] = max(agg["max_ms"], rec.mttr_ms)
        for agg in out.values():
            agg["mean_ms"] = round(agg["mean_ms"] / agg["count"], 1)
        return out

    @property
    def faults_injected(self) -> int:
        return sum(1 for r in self.records if not r.skipped)

    @property
    def stuck_records(self) -> List[FaultRecord]:
        return [r for r in self.records if not r.skipped and not r.recovered]

    def assert_recovered(self):
        stuck = self.stuck_records
        if stuck:
            detail = "; ".join(
                f"#{r.seq} {r.kind} {r.detail}" for r in stuck)
            raise ChaosRecoveryError(
                f"{len(stuck)} fault(s) not recovered within "
                f"{self.recovery_deadline_s}s: {detail}")
