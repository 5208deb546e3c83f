"""Recovery-deadline enforcement for state-machine transitions.

The chaos postmortem shape this guards against: a recovery path (serve
replica STARTING, train gang restart, shardgroup promotion) that retries
or waits forever. Under churn such a transition can wedge silently — the
reconcile loop keeps ticking, nothing raises, the deployment just never
converges. A `TransitionWatch` makes every tracked transition either
finish or FAIL LOUDLY past `chaos_recovery_deadline_s`, with the stuck
state and key attributed.

Dependency-light on purpose (config only): production consumers (serve
controller, train executor) import this module directly without pulling
the injector machinery in.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import GLOBAL_CONFIG

logger = logging.getLogger(__name__)


class StuckTransitionError(RuntimeError):
    """A tracked state-machine transition outlived the recovery deadline.

    Carries the attributed (key, state, elapsed_s) list so callers and
    logs name the wedge instead of reporting a generic timeout."""

    def __init__(self, watch_name: str,
                 stuck: List[Tuple[str, str, float]]):
        self.watch_name = watch_name
        self.stuck = stuck
        detail = "; ".join(f"{key} stuck in {state} for {elapsed:.1f}s"
                           for key, state, elapsed in stuck)
        super().__init__(
            f"{watch_name}: recovery deadline "
            f"({GLOBAL_CONFIG.chaos_recovery_deadline_s}s) exceeded: "
            f"{detail}")


class TransitionWatch:
    """Tracks in-flight transitions; `stuck()` names any past deadline.

    `enter(key, state)` (re)starts the clock for `key` — entering a NEW
    state resets it (progress is progress); re-entering the same state is
    a no-op (the clock keeps running, retry loops don't launder their
    age). `clear(key)` marks the transition complete. Not thread-safe by
    design: every production consumer drives it from a single reconcile
    loop/thread.
    """

    def __init__(self, name: str, deadline_s: Optional[float] = None):
        self.name = name
        # None = read the config flag at check time (tests flip it live).
        self._deadline_s = deadline_s
        self._inflight: Dict[str, Tuple[str, float]] = {}
        self.stuck_total = 0  # transitions that ever tripped the deadline

    @property
    def deadline_s(self) -> float:
        if self._deadline_s is not None:
            return self._deadline_s
        return GLOBAL_CONFIG.chaos_recovery_deadline_s

    def enter(self, key: str, state: str):
        cur = self._inflight.get(key)
        if cur is not None and cur[0] == state:
            return  # same state: the clock keeps running
        self._inflight[key] = (state, time.monotonic())

    def clear(self, key: str):
        self._inflight.pop(key, None)

    def prune(self, keep) -> None:
        """Drop every tracked transition whose key is not in `keep` —
        for consumers that rebuild the live set each tick (the serve
        reconcile loop): a subject that completed or vanished must not
        age into a false stuck report."""
        keep = set(keep)
        for key in list(self._inflight):
            if key not in keep:
                self._inflight.pop(key, None)

    def state_of(self, key: str) -> Optional[str]:
        cur = self._inflight.get(key)
        return cur[0] if cur is not None else None

    def stuck(self) -> List[Tuple[str, str, float]]:
        """(key, state, elapsed_s) for every transition past deadline;
        empty when enforcement is disabled (deadline 0)."""
        deadline = self.deadline_s
        if deadline <= 0:
            return []
        now = time.monotonic()
        return [(key, state, now - t0)
                for key, (state, t0) in self._inflight.items()
                if now - t0 > deadline]

    def fail_stuck(self, clear: bool = True) -> List[Tuple[str, str, float]]:
        """Log every stuck transition CRITICAL (attributed), count it,
        optionally drop it from tracking (the caller is about to replace
        the stuck entity), and return the list. The caller decides
        whether to raise — `raise_stuck()` does both."""
        stuck = self.stuck()
        for key, state, elapsed in stuck:
            self.stuck_total += 1
            logger.critical(
                "%s: transition %s stuck in %s for %.1fs (recovery "
                "deadline %.1fs) — failing loudly instead of hanging",
                self.name, key, state, elapsed, self.deadline_s)
            if clear:
                self._inflight.pop(key, None)
        return stuck

    def raise_stuck(self):
        stuck = self.fail_stuck(clear=True)
        if stuck:
            raise StuckTransitionError(self.name, stuck)
