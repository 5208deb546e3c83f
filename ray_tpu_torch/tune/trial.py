"""Trial bookkeeping: the port's copy of `ray_tpu/tune/trial.py` (the
reference's `python/ray/tune/experiment/trial.py`)."""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class TrialStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"


@dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = TrialStatus.PENDING
    last_result: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    error: Optional[str] = None
    checkpoint_path: Optional[str] = None
    num_results: int = 0
    num_failures: int = 0   # actor-death restarts consumed
    start_time: float = 0.0
    runtime_s: float = 0.0

    @property
    def is_finished(self) -> bool:
        return self.status in (TrialStatus.TERMINATED, TrialStatus.ERROR)

    def state(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "metrics_history": self.metrics_history,
            "error": self.error,
            "checkpoint_path": self.checkpoint_path,
            "num_results": self.num_results,
            "num_failures": self.num_failures,
        }

    @staticmethod
    def from_state(state: Dict[str, Any]) -> "Trial":
        t = Trial(config=state["config"], trial_id=state["trial_id"])
        t.status = state["status"]
        t.last_result = state.get("last_result", {})
        t.metrics_history = state.get("metrics_history", [])
        t.error = state.get("error")
        t.checkpoint_path = state.get("checkpoint_path")
        t.num_results = state.get("num_results", 0)
        t.num_failures = state.get("num_failures", 0)
        return t
