"""Replay buffers: uniform ring and proportional prioritized.

The port's copy of `ray_tpu/rllib/replay_buffers.py` (numpy only).
Equivalent of the reference's `rllib/utils/replay_buffers/` (ReplayBuffer,
PrioritizedReplayBuffer with a segment tree). Redesigned columnar: one
preallocated numpy ring per sample-batch field, so `sample(n)` is a single
fancy-index gather per field (the batch goes straight to the learner's
device with no per-transition Python work), and priorities live in a flat float64
array sampled with `numpy.random.Generator.choice` — O(n) per draw at the
buffer sizes a single host feeds a card with, without the segment-tree
bookkeeping.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform FIFO ring over columnar transition storage."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        """Append a batch of transitions (dict of [N, ...] arrays)."""
        fields = {k: np.asarray(v) for k, v in batch.items()
                  if not k.startswith("_")}
        n = len(next(iter(fields.values())))
        if not self._cols:
            for k, v in fields.items():
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        if n >= self.capacity:  # keep the newest `capacity` rows
            for k, v in fields.items():
                self._cols[k][:] = v[-self.capacity:]
            self._next, self._size = 0, self.capacity
            self._on_added(np.arange(self.capacity))
            return
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in fields.items():
            self._cols[k][idx] = v
        self._on_added(idx)
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def _on_added(self, idx: np.ndarray) -> None:
        pass

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=n)
        return self._gather(idx)

    def _gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        out = {k: v[idx] for k, v in self._cols.items()}
        out["_batch_indices"] = idx
        return out

    def state(self) -> Dict[str, Any]:
        return {"cols": {k: v.copy() for k, v in self._cols.items()},
                "next": self._next, "size": self._size}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._cols = {k: v.copy() for k, v in state["cols"].items()}
        self._next = int(state["next"])
        self._size = int(state["size"])


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (reference
    `replay_buffers/prioritized_replay_buffer.py`): P(i) ∝ p_i^alpha, with
    importance weights w_i = (N * P(i))^-beta / max w.
    """

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed=seed)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)
        self._prios = np.zeros(self.capacity, np.float64)
        self._max_prio = 1.0

    def _on_added(self, idx: np.ndarray) -> None:
        # New transitions get max priority so each is trained at least once.
        self._prios[idx] = self._max_prio

    def sample(self, n: int, beta: Optional[float] = None
               ) -> Dict[str, np.ndarray]:
        beta = self.beta if beta is None else beta
        p = self._prios[:self._size] ** self.alpha
        probs = p / p.sum()
        idx = self._rng.choice(self._size, size=n, p=probs)
        out = self._gather(idx)
        w = (self._size * probs[idx]) ** (-beta)
        out["weights"] = (w / w.max()).astype(np.float32)
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        pr = np.abs(np.asarray(priorities, np.float64)) + self.eps
        self._prios[np.asarray(idx)] = pr
        self._max_prio = max(self._max_prio, float(pr.max()))

    def state(self) -> Dict[str, Any]:
        out = super().state()
        out["prios"] = self._prios.copy()
        out["max_prio"] = self._max_prio
        return out

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        self._prios = state["prios"].copy()
        self._max_prio = float(state["max_prio"])
