"""ShardSpec: the declarative shape of a sharded replica group.

One logical serve replica (or train worker "super-rank") may be a GANG of
`world_size` rank actors spanning hosts, together driving one program
over a `tp`-wide tensor-parallel group of cards.  The spec is pure
data — serve's `DeploymentConfig` carries it, the controller hands it to
the gang scheduler (`shardgroup.gang`), and every rank receives its
per-rank slice as a `ShardContext` (`shardgroup.runtime`).

GPU mapping: one rank holds one card, so a replica over four hosts of
four H100s is ``ShardSpec(tp=16, world_size=16, bundle={"GPU": 1})``, the
placement group packing four ranks to a host. Every gang of more than one
rank joins a `torch.distributed` group (gloo on the CPU, NCCL on cards),
and a gang with tp or sp > 1 builds its stage's ("sp", "tp") DeviceMesh
over it (`shardgroup.current_mesh()`), sp x tp ranks a stage.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


def resources_of(actor_options: Optional[Dict] = None) -> Dict[str, float]:
    """Actor options -> the resource dict they actually request. The
    SINGLE translation both sides of the bundle contract use: what
    `rank_bundle` reserves and what the gang's fail-fast overflow check
    compares against must never disagree."""
    opts = actor_options or {}
    resources: Dict[str, float] = {}
    if opts.get("num_cpus"):
        resources["CPU"] = float(opts["num_cpus"])
    if opts.get("num_gpus"):
        resources["GPU"] = float(opts["num_gpus"])
    for k, v in (opts.get("resources") or {}).items():
        resources[k] = float(v)
    return resources


@dataclass(frozen=True)
class ShardSpec:
    """Gang shape for one logical replica.

    tp          tensor-parallel width: the size of the mesh's "tp" axis
                (attention heads / MLP hidden / vocab shard over it, the
                paged KV arena shards its kv-head dim with it).
    pp          pipeline-parallel width: the number of STAGE ranks of a
                pipelined train gang. Stages are whole processes (one
                rank per stage), activations/grads move over the host
                collective plane — so pp multiplies world_size rather
                than the per-rank device mesh.
    sp          sequence-parallel width: the size of the mesh's "sp"
                axis (ring attention shards the sequence dim over it
                for long contexts).
    world_size  number of rank ACTORS (processes/hosts) in the gang.
    strategy    placement-group strategy for the gang's bundles
                ("PACK" for single-host tests, "STRICT_SPREAD" for one
                rank per host on a pod).
    bundle      per-rank resource bundle; empty means "derive from the
                deployment's ray_actor_options, default {CPU: 0.1}".
    """

    tp: int = 1
    world_size: int = 1
    strategy: str = "PACK"
    bundle: Dict[str, float] = field(default_factory=dict)
    pp: int = 1
    sp: int = 1

    def __post_init__(self):
        if self.tp < 1 or self.world_size < 1 or self.pp < 1 or self.sp < 1:
            raise ValueError(
                f"ShardSpec needs tp/pp/sp >= 1 and world_size >= 1, got "
                f"tp={self.tp} pp={self.pp} sp={self.sp} "
                f"world_size={self.world_size}")
        if self.pp > 1 and self.world_size % self.pp:
            raise ValueError(
                f"pp={self.pp} must divide world_size={self.world_size} "
                "(each pipeline stage is a contiguous block of ranks)")
        if self.devices_per_stage > 1 and \
                self.devices_per_stage % self.ranks_per_stage:
            raise ValueError(
                f"sp x tp = {self.devices_per_stage} must be divisible by "
                f"the {self.ranks_per_stage} ranks of each stage (every "
                "rank hosts sp x tp / ranks contiguous mesh columns)")

    @property
    def ranks_per_stage(self) -> int:
        return max(1, self.world_size // self.pp)

    @property
    def tp_per_rank(self) -> int:
        return max(1, self.tp // self.ranks_per_stage)

    def mesh_axes(self) -> Dict[str, int]:
        """The logical device grid this spec spans, as MeshSpec axes
        (size-1 axes dropped; ("pp", "sp", "tp") in AXIS_ORDER). On a
        real multi-host bring-up this is the global mesh; on the CPU
        backend each stage rank builds :meth:`stage_mesh_axes` locally
        and "pp" lives across processes, not inside the mesh."""
        return {name: size
                for name, size in (("pp", self.pp), ("sp", self.sp),
                                   ("tp", self.tp))
                if size > 1}

    def stage_mesh_axes(self) -> Dict[str, int]:
        """The per-stage device mesh: ("sp", "tp") only — the pp axis is
        realized as separate stage processes exchanging activations over
        the collective plane, never as an in-program mesh axis."""
        return {name: size for name, size in (("sp", self.sp),
                                              ("tp", self.tp)) if size > 1}

    @property
    def devices_per_stage(self) -> int:
        return self.sp * self.tp

    def rank_bundle(self, actor_options: Optional[Dict] = None
                    ) -> Dict[str, float]:
        """The placement-group bundle one rank reserves."""
        if self.bundle:
            return {k: float(v) for k, v in self.bundle.items()}
        return resources_of(actor_options) or {"CPU": 0.1}
