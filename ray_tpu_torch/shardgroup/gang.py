"""Gang scheduling: atomic all-or-nothing creation of a rank-actor gang.

The creation contract (raylint RL009 enforces its shape on hand-rolled
gangs):

1. one placement group reserves every rank's bundle via the GCS 2PC —
   an infeasible/timed-out group is REMOVED before the error surfaces;
2. rank actors are created one bundle each; ANY mid-gang failure kills
   every already-created rank, removes the placement group (releasing
   all bundles, including the ones later ranks never reached), and
   raises ONE rank-attributed `GangError` — no leaked reservations, no
   half-alive gangs;
3. the synchronous path then waits for every rank's first ping — a rank
   that dies in its ctor aborts the whole gang the same way;
4. a death hook is registered (`GangMonitor`, or the caller's own — the
   serve controller's health check plays this role for serve gangs).
"""

from __future__ import annotations

import logging
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.shardgroup import spec as _spec
from ray_tpu_torch.shardgroup.group import GangError, GangMonitor, ReplicaGroup
from ray_tpu_torch.shardgroup.spec import ShardSpec

logger = logging.getLogger(__name__)


def _abort_gang(pg, created: List[Any], group_id: str) -> None:
    """Release EVERYTHING a partially-created gang holds: every created
    rank actor, the whole placement group (all bundles, acquired or
    not), and the rendezvous keys."""
    import ray_tpu_torch
    from ray_tpu_torch.shardgroup import runtime as _rt
    from ray_tpu_torch.util.placement_group import remove_placement_group

    for handle in created:
        try:
            ray_tpu_torch.kill(handle)
        except Exception:  # noqa: BLE001 — never created / already dead
            pass
    if pg is not None:
        try:
            remove_placement_group(pg)
        except Exception:  # noqa: BLE001 — GCS unreachable: nothing left
            logger.warning("shardgroup: failed to remove placement group "
                           "of aborted gang %s", group_id, exc_info=True)
    _rt.clear_rendezvous(group_id)


def create_gang(
    actor_cls,
    spec: ShardSpec,
    *,
    group_id: Optional[str] = None,
    bundle: Optional[Dict[str, float]] = None,
    rank_options: Optional[Callable[[int], Dict[str, Any]]] = None,
    rank_args: Optional[Callable[[int], Tuple[tuple, dict]]] = None,
    pg_timeout_s: float = 30.0,
    ready_timeout_s: float = 60.0,
    wait_ready: bool = True,
    on_death: Optional[Callable[[ReplicaGroup, int], None]] = None,
) -> ReplicaGroup:
    """Create a `spec.world_size`-rank gang of `actor_cls` actors on one
    placement group. All-or-nothing: returns a fully-formed
    `ReplicaGroup` or raises `GangError` with nothing left behind.

    `rank_options(rank)` -> extra actor options (name, max_concurrency,
    num_cpus...); `rank_args(rank)` -> (args, kwargs) for the rank's
    ctor. With `wait_ready=False` the readiness wait (step 3) is skipped
    — the caller owns promotion (the serve controller's STARTING->RUNNING
    ping loop) — but mid-creation abort (step 2) still applies.
    """
    import ray_tpu_torch
    from ray_tpu_torch.util.placement_group import placement_group
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    group_id = group_id or f"gang-{uuid.uuid4().hex[:12]}"
    bundle = dict(bundle) if bundle else spec.rank_bundle()
    # Fail fast on a rank asking for more than its bundle holds: the GCS
    # would otherwise spin the creation unplaceable until its lease
    # deadline (minutes) with the whole gang's bundles held hostage.
    for rank in range(spec.world_size):
        opts = rank_options(rank) if rank_options else {}
        for res, amt in _spec.resources_of(opts).items():
            if amt > bundle.get(res, 0.0):
                raise GangError(
                    f"gang {group_id}: rank {rank} requests {res}={amt} "
                    f"but its bundle only reserves "
                    f"{bundle.get(res, 0.0)} — grow ShardSpec.bundle",
                    group_id=group_id, rank=rank)
    pg = None
    created: List[Any] = []
    names: List[str] = []
    try:
        pg = placement_group([dict(bundle)] * spec.world_size,
                             strategy=spec.strategy)
        if wait_ready and not pg.wait(timeout_seconds=pg_timeout_s):
            raise GangError(
                f"gang {group_id}: placement group of "
                f"{spec.world_size} x {bundle} bundles not placeable in "
                f"{pg_timeout_s}s", group_id=group_id)
        for rank in range(spec.world_size):
            opts = dict(rank_options(rank)) if rank_options else {}
            opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=rank)
            args, kwargs = rank_args(rank) if rank_args else ((), {})
            try:
                handle = ray_tpu_torch.remote(actor_cls).options(**opts).remote(
                    *args, **kwargs)
            except Exception as e:
                raise GangError(
                    f"gang {group_id}: creating rank {rank}/"
                    f"{spec.world_size} failed: "
                    f"{type(e).__name__}: {e}",
                    group_id=group_id, rank=rank) from e
            created.append(handle)
            names.append(opts.get("name") or f"{group_id}#r{rank}")
        group = ReplicaGroup(group_id, spec, pg, created, names)
        if wait_ready:
            statuses = group.ping_all(timeout_s=ready_timeout_s)
            bad = [i for i, s in enumerate(statuses) if s != "ok"]
            if bad:
                raise GangError(
                    f"gang {group_id}: rank {bad[0]}/{spec.world_size} "
                    f"{'died during startup' if statuses[bad[0]] == 'dead' else 'not ready in time'}"
                    f" (statuses: {statuses}) — gang aborted",
                    group_id=group_id, rank=bad[0])
    except GangError:
        _abort_gang(pg, created, group_id)
        raise
    except Exception as e:
        _abort_gang(pg, created, group_id)
        raise GangError(
            f"gang {group_id}: creation failed: {type(e).__name__}: {e}",
            group_id=group_id) from e
    if on_death is not None:
        GangMonitor(group, on_death)
    return group


def create_replica_group(
    user_cls,
    spec: ShardSpec,
    *,
    init_args: tuple = (),
    init_kwargs: Optional[dict] = None,
    deployment_name: str = "group",
    group_id: Optional[str] = None,
    actor_options: Optional[Dict[str, Any]] = None,
    pg_timeout_s: float = 30.0,
    ready_timeout_s: float = 60.0,
    on_death: Optional[Callable[[ReplicaGroup, int], None]] = None,
) -> ReplicaGroup:
    """The standalone (non-serve) front door: gang-create `world_size`
    serve-style `Replica` actors hosting `user_cls` with an activated
    shard context, wait until every rank is up, register the death hook.
    Returns the group; `group.handle` drives requests on rank 0."""
    from ray_tpu_torch.serve.replica import Replica

    group_id = group_id or f"{deployment_name}-{uuid.uuid4().hex[:8]}"
    base_opts = dict(actor_options or {})
    base_opts.setdefault("num_cpus", 0.05)
    base_opts.setdefault("max_concurrency", 16)

    def rank_options(rank: int) -> Dict[str, Any]:
        opts = dict(base_opts)
        opts["name"] = f"SHARDGROUP::{group_id}#r{rank}"
        return opts

    def rank_args(rank: int):
        ctx = {"group_id": group_id, "rank": rank,
               "world_size": spec.world_size, "tp": spec.tp,
               "pp": spec.pp, "sp": spec.sp,
               "spmd": spec.world_size > 1}
        return ((deployment_name, user_cls, init_args, init_kwargs or {},
                 f"{group_id}#r{rank}"), {"shard_ctx": ctx})

    return create_gang(
        Replica, spec, group_id=group_id,
        bundle=spec.rank_bundle(base_opts),
        rank_options=rank_options, rank_args=rank_args,
        pg_timeout_s=pg_timeout_s, ready_timeout_s=ready_timeout_s,
        wait_ready=True, on_death=on_death)
