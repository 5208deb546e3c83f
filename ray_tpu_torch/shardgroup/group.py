"""ReplicaGroup: the handle that makes N rank actors look like one.

The serve router/dataplane never learn about gangs — they route to
``group.handle`` (rank 0), which drives the SPMD step; the controller
and the standalone API use the group-level operations (ping_all /
check_alive / broadcast / kill) that treat the gang as one unit.

Lifecycle invariant: a ReplicaGroup is all-or-nothing. It is only ever
returned fully formed by `gang.create_gang` (partial creation aborts and
releases every bundle there), and `kill()` tears down every rank AND the
placement group — a gang never survives the death of any member (the
controller's health check or a `GangMonitor` notices a dead rank and
kills + replaces the whole group).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.shardgroup.spec import ShardSpec

logger = logging.getLogger(__name__)


class GangError(RuntimeError):
    """Gang-level failure, attributed to the rank that caused it
    (rank < 0 means the group as a whole, e.g. an infeasible placement
    group)."""

    def __init__(self, message: str, group_id: str = "", rank: int = -1):
        super().__init__(message)
        self.group_id = group_id
        self.rank = rank


class ReplicaGroup:
    def __init__(self, group_id: str, spec: ShardSpec, pg,
                 ranks: List[Any], rank_names: List[str]):
        self.group_id = group_id
        self.spec = spec
        self.pg = pg
        self.ranks = list(ranks)
        self.rank_names = list(rank_names)
        self._dead = False

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    @property
    def handle(self):
        """Rank 0 — the gang's single routable endpoint."""
        return self.ranks[0]

    # ---------------------------------------------------------- liveness

    def ping_all(self, timeout_s: float = 5.0,
                 indices: Optional[List[int]] = None) -> List[str]:
        """Per-rank status: "ok" | "pending" | "dead", aligned to
        `indices` (default: every rank). A resolved-but-errored ping is
        a dead rank; an unresolved one is merely slow. Callers that
        already probed rank 0 another way (the controller's stats/node
        ping) pass `indices=range(1, world_size)` so rank 0 isn't
        pinged twice per sweep."""
        import ray_tpu_torch

        indices = list(indices) if indices is not None \
            else list(range(len(self.ranks)))
        runtime = ray_tpu_torch._require_runtime()
        deadline = time.monotonic() + timeout_s
        refs = []
        for rank in indices:
            handle = self.ranks[rank]
            # Liveness probe BEFORE submission: submitting to a rank
            # still in creation blocks UNBOUNDEDLY on address resolution,
            # so one wedged rank ctor would park every health sweep (the
            # serve reconcile loop among them). A pending rank is polled
            # only within this call's own deadline — readiness waits
            # (create_gang's wait_ready) keep their blocking semantics,
            # short sweeps return "pending" immediately. Backoff on the
            # poll: each actor_liveness on a pending rank is a GCS
            # directory RPC, and a gang readiness wait at a fixed 50ms
            # cadence would hammer the GCS with ~20 RPCs/s per rank for
            # the whole spawn+__init__ window.
            poll = 0.05
            liveness = runtime.actor_liveness(handle._actor_id)
            while liveness == "pending" and time.monotonic() < deadline:
                time.sleep(min(poll, max(0.0,
                                         deadline - time.monotonic())))
                poll = min(poll * 2, 0.5)
                liveness = runtime.actor_liveness(handle._actor_id)
            if liveness != "alive":
                refs.append("dead" if liveness == "dead" else "pending")
                continue
            try:
                refs.append(handle.ping.remote())
            except Exception:  # noqa: BLE001 — submit to a dead actor
                refs.append(None)
        out = []
        for ref in refs:
            if isinstance(ref, str):
                out.append(ref)
                continue
            if ref is None:
                out.append("dead")
                continue
            remaining = max(0.0, deadline - time.monotonic())
            try:
                ready, _ = ray_tpu_torch.wait([ref], num_returns=1,
                                              timeout=remaining)
                if not ready:
                    out.append("pending")
                    continue
                ray_tpu_torch.get(ready[0])
                out.append("ok")
            except Exception:  # noqa: BLE001 — rank actor died
                out.append("dead")
        return out

    def check_alive(self, timeout_s: float = 5.0) -> bool:
        """True iff EVERY rank answers its ping — one dead rank means
        the whole group is dead (the caller kills and replaces it)."""
        return all(s == "ok" for s in self.ping_all(timeout_s))

    def dead_ranks(self, timeout_s: float = 2.0,
                   indices: Optional[List[int]] = None) -> List[int]:
        indices = list(indices) if indices is not None \
            else list(range(len(self.ranks)))
        return [rank for rank, s in zip(indices,
                                        self.ping_all(timeout_s, indices))
                if s == "dead"]

    # --------------------------------------------------------- operations

    def broadcast(self, method: str, *args, timeout_s: float = 30.0,
                  **kwargs) -> List[Any]:
        """Invoke `method` on every rank, gather all results (rank
        order). Any rank failure raises — group-level calls are
        all-or-nothing like the gang itself."""
        import ray_tpu_torch

        refs = [getattr(h, method).remote(*args, **kwargs)
                for h in self.ranks]
        return list(ray_tpu_torch.get(refs, timeout=timeout_s))

    def kill(self, graceful_timeout_s: float = 0.0) -> None:
        """Tear the gang down as a unit: every rank, then the placement
        group (bundle release), then the rendezvous keys. Idempotent and
        best-effort — ranks may already be dead."""
        import ray_tpu_torch
        from ray_tpu_torch.shardgroup import runtime as _rt
        from ray_tpu_torch.util.placement_group import remove_placement_group

        self._dead = True
        if graceful_timeout_s > 0:
            try:
                self.handle.prepare_shutdown.remote(graceful_timeout_s)
            except Exception:  # noqa: BLE001 — rank 0 already dead
                pass
        for handle in self.ranks:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:  # noqa: BLE001 — pg already removed
                logger.debug("shardgroup: pg removal for %s failed",
                             self.group_id, exc_info=True)
        _rt.clear_rendezvous(self.group_id)

    def describe(self) -> Dict[str, Any]:
        """Plain-data description, durable enough to clean the gang up
        after the owner's crash (the serve controller checkpoints this
        and uses it to kill stale rank actors / release the pg)."""
        out = {"group_id": self.group_id, "world_size": self.world_size,
               "tp": self.spec.tp, "rank_names": list(self.rank_names),
               "pg_id": None}
        if self.pg is not None:
            out.update(pg_id=self.pg.id.hex(), bundles=self.pg.bundles,
                       strategy=self.pg.strategy)
        return out

    def __repr__(self):
        return (f"ReplicaGroup({self.group_id}, world={self.world_size}, "
                f"tp={self.spec.tp})")


class GangMonitor:
    """Death hook for standalone (non-serve) gangs: a daemon thread pings
    every rank each `period_s`; the first dead rank fires `on_death(group,
    rank)` ONCE and the monitor stops — the owner decides whether to
    kill/recreate. (Serve gangs don't use this: the controller's health
    check is their death hook.)"""

    def __init__(self, group: ReplicaGroup,
                 on_death: Callable[[ReplicaGroup, int], None],
                 period_s: float = 0.5):
        self.group = group
        self._on_death = on_death
        self._period = period_s
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"gang-monitor-{group.group_id}",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _run(self):
        while not self._stopped.wait(self._period):
            if self.group._dead:
                return
            dead = self.group.dead_ranks(timeout_s=2.0)
            if dead:
                logger.warning(
                    "shardgroup: rank %d of %s died — firing death hook",
                    dead[0], self.group.group_id)
                try:
                    self._on_death(self.group, dead[0])
                except Exception:  # noqa: BLE001 — owner hook must not
                    logger.exception("gang death hook failed")
                return
