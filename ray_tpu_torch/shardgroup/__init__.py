"""ray_tpu_torch.shardgroup — gang-scheduled sharded replica groups.

Makes N rank actors spanning hosts look like ONE logical replica: atomic
all-or-nothing gang creation on a placement group, coordinated bring-up
(rank 0 publishes the rendezvous; every rank joins one torch.distributed
group), group-level lifecycle (any rank death kills and restarts the
whole gang, and `GangMonitor` fails the group fast), and a group handle
the serve router/dataplane treat as a single replica — requests land on
rank 0. A gang with tp or sp > 1 builds its stage's ("sp", "tp")
DeviceMesh, one rank a card (`current_mesh`).
"""

from ray_tpu_torch.shardgroup.gang import create_gang, create_replica_group
from ray_tpu_torch.shardgroup.group import GangError, GangMonitor, ReplicaGroup
from ray_tpu_torch.shardgroup.runtime import (
    ShardContext,
    activate,
    current,
    current_mesh,
    deactivate,
)
from ray_tpu_torch.shardgroup.spec import ShardSpec

__all__ = [
    "GangError", "GangMonitor", "ReplicaGroup", "ShardContext",
    "ShardSpec", "activate", "create_gang", "create_replica_group",
    "current", "current_mesh", "deactivate",
]
