"""Serve configuration dataclasses.

Mirrors the reference's deployment/autoscaling config surface
(`python/ray/serve/config.py`, `_private/autoscaling_policy.py:54-127`) as
plain dataclasses: num_replicas or an AutoscalingConfig, per-replica
max_concurrent_queries (admission control at the router), and the actor
resources a replica runs with (a GPU inference replica asks for
``num_gpus=1`` and owns the card).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.shardgroup.spec import ShardSpec


@dataclass
class AutoscalingConfig:
    """Queue-depth driven replica autoscaling.

    The controller compares the mean number of ongoing requests per replica
    against ``target_ongoing_requests`` each reconcile tick and moves
    ``num_replicas`` toward ``ceil(total_ongoing / target)``, bounded by
    [min_replicas, max_replicas]. Upscale reacts after
    ``upscale_delay_s`` of sustained pressure, downscale after
    ``downscale_delay_s`` of sustained idleness (reference policy:
    `serve/_private/autoscaling_policy.py:127`).
    """

    min_replicas: int = 1  # 0 enables scale-to-zero (deploys parked)
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    metrics_interval_s: float = 0.25


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_concurrent_queries: int = 8
    autoscaling: Optional[AutoscalingConfig] = None
    route_prefix: Optional[str] = None       # default: "/<deployment name>"
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    health_check_period_s: float = 1.0
    graceful_shutdown_timeout_s: float = 5.0
    replica_startup_timeout_s: float = 60.0
    # Arbitrary payload delivered to every replica's `reconfigure(cfg)`
    # hook — model weights, sampling params, feature flags. The controller
    # puts it in the object store ONCE and passes the ref to each replica,
    # so a large payload (a weight pytree) fans out over the object
    # transfer plane's tree broadcast instead of being re-pickled through
    # the controller per replica (reference: serve user_config semantics).
    user_config: Any = None
    # Sharded replica groups (docs/SHARDED.md): when set, every "replica"
    # of this deployment is a gang of shard_spec.world_size rank actors on
    # one placement group, joined by one torch.distributed group (tp > 1
    # builds the gang's mesh, on which LLMServer serves tensor-parallel:
    # rank 0 schedules, the other ranks follow). The router still sees
    # ONE handle per replica (rank 0); autoscaling / scale-to-zero operate
    # on whole groups, and any rank death kills and restarts the group as
    # a unit.
    shard_spec: Optional[ShardSpec] = None
    # Multi-tenancy (docs/MULTITENANCY.md): the registered tenant that
    # owns this deployment. Its QoS (tier/weight/rps/in-flight quotas)
    # is pushed to proxies inside the routing-table entry and enforced
    # there; None = untenanted (unmetered, default fair-queue weight).
    tenant: Optional[str] = None

    def initial_replicas(self) -> int:
        if self.autoscaling is not None:
            # min_replicas=0 deploys PARKED: the route exists with zero
            # replicas and the first request cold-starts one through the
            # controller's wake path (scale-to-zero).
            if self.autoscaling.min_replicas <= 0:
                return 0
            return self.autoscaling.min_replicas
        return self.num_replicas


# Replica lifecycle states (reference: `_private/deployment_state.py` —
# STARTING/RUNNING/STOPPING collapsed to what the reconcile loop needs).
REPLICA_STARTING = "STARTING"
REPLICA_RUNNING = "RUNNING"
REPLICA_STOPPING = "STOPPING"
