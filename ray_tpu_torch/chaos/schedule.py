"""ChaosSchedule: a deterministic, seeded fault-injection plan.

The schedule is the single source of randomness for a chaos run: every
event's firing time, fault kind, victim draw and auxiliary parameter is
derived from one seeded PRNG at construction, so the SAME seed always
yields the SAME event list (`signature()` — asserted by the determinism
test and recorded in bench output for reproduction). Injectors map the
integer `draw` onto whatever victim set exists at fire time with a modulo
— the schedule never needs to know node ids ahead of time, and two runs
against clusters of equal shape pick the same victims.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class ChaosEvent:
    seq: int          # position in the schedule
    t: float          # seconds after schedule start
    kind: str         # injector key ("node_kill", "gcs_restart", ...)
    draw: int         # deterministic victim selector (injector mods it)
    param: float      # 0..1 draw for injector-specific use (outage length,
                      # fault fraction, ...)

    def signature(self) -> Tuple:
        """Stable tuple for determinism assertions and event-log export."""
        return (self.seq, round(self.t, 6), self.kind, self.draw,
                round(self.param, 9))


@dataclass
class ChaosSchedule:
    """Seeded plan of `count` events spaced ~`period_s` apart.

    `kinds` is either a sequence (uniform) or a {kind: weight} dict.
    `jitter` spreads each firing uniformly within ±jitter*period around
    its slot, so faults don't phase-lock with periodic workload behavior
    (heartbeats, reconcile ticks) while staying fully reproducible.
    """

    seed: int
    kinds: Union[Sequence[str], Dict[str, float]] = ("node_kill",)
    period_s: float = 3.0
    count: int = 10
    jitter: float = 0.25
    start_delay_s: float = 0.0
    events: List[ChaosEvent] = field(init=False)

    def __post_init__(self):
        if self.period_s <= 0:
            raise ValueError("period_s must be positive")
        if isinstance(self.kinds, dict):
            names = sorted(self.kinds)
            weights = [float(self.kinds[k]) for k in names]
        else:
            names = list(self.kinds)
            weights = [1.0] * len(names)
        if not names:
            raise ValueError("at least one fault kind is required")
        rng = random.Random(self.seed)
        events: List[ChaosEvent] = []
        for seq in range(self.count):
            slot = self.start_delay_s + (seq + 1) * self.period_s
            t = slot + rng.uniform(-self.jitter, self.jitter) * self.period_s
            kind = rng.choices(names, weights=weights, k=1)[0]
            events.append(ChaosEvent(
                seq=seq, t=max(0.0, t), kind=kind,
                draw=rng.randrange(1 << 30), param=rng.random()))
        self.events = events

    def signatures(self) -> List[Tuple]:
        return [e.signature() for e in self.events]

    def describe(self) -> Dict:
        """Plain-data form for bench output / reproduction notes."""
        return {"seed": self.seed, "period_s": self.period_s,
                "count": self.count, "jitter": self.jitter,
                "events": [list(s) for s in self.signatures()]}


def single_event_schedule(seed: int, kind: str,
                          at_s: float = 1.0) -> ChaosSchedule:
    """One-fault schedule (the gate's chaos smoke): still seeded, so the
    victim draw is reproducible."""
    sched = ChaosSchedule(seed=seed, kinds=(kind,), period_s=at_s,
                          count=1, jitter=0.0)
    return sched
