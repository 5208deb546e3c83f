"""Worker-side shard context: coordinated process-group bring-up for one rank.

Every rank actor of a gang calls :func:`activate` BEFORE any user code
(the serve `Replica` does it ahead of the deployment ctor, as
`train.TorchBackend.on_start` forms the trainer's group before the train
loop). Protocol:

1. rank 0 picks a free port on its node's address and publishes
   ``host:port`` under the group's GCS KV key
   (`shardgroup:<group>:coordinator`);
2. every rank polls that key, then joins one `torch.distributed` process
   group at that address: NCCL where the rank holds cards, gloo on the
   CPU;
3. a gang with tp or sp > 1 builds its stage's ("sp", "tp") `DeviceMesh`
   over that group (`_build_stage_mesh`, the reference's
   `ray_tpu/shardgroup/runtime.py:175-224`), which :func:`current_mesh`
   returns. One rank holds one card, so a stage is sp x tp ranks.
"""

from __future__ import annotations

import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

_KV_PREFIX = "shardgroup:"


@dataclass(frozen=True)
class ShardContext:
    """One rank's view of its gang (delivered by the gang scheduler)."""

    group_id: str          # unique per gang INCARNATION (restart = new id)
    rank: int
    world_size: int
    tp: int
    spmd: bool             # a torch.distributed group spans the ranks
    pp: int = 1            # pipeline stages (ranks, not mesh columns)
    sp: int = 1            # sequence-parallel mesh axis width

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def stage(self) -> int:
        """This rank's pipeline stage (ranks are laid out stage-major:
        rank // ranks_per_stage)."""
        per = max(1, self.world_size // max(1, self.pp))
        return self.rank // per

    def as_dict(self) -> Dict[str, Any]:
        return {"group_id": self.group_id, "rank": self.rank,
                "world_size": self.world_size, "tp": self.tp,
                "pp": self.pp, "sp": self.sp, "spmd": self.spmd}


_current: Optional[ShardContext] = None
_mesh = None


def _kv():
    import ray_tpu_torch

    return ray_tpu_torch._require_runtime().gcs


def _coord_key(group_id: str) -> bytes:
    return (_KV_PREFIX + group_id + ":coordinator").encode()


def publish_coordinator(group_id: str, address: str) -> None:
    _kv().call("kv_put", {"key": _coord_key(group_id),
                          "value": address.encode()})


def wait_coordinator(group_id: str, timeout_s: float = 30.0) -> str:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = _kv().call("kv_get", {"key": _coord_key(group_id)})["value"]
        if value:
            return bytes(value).decode()
        time.sleep(0.02)
    raise TimeoutError(
        f"shard group {group_id}: coordinator address not published "
        f"within {timeout_s}s (rank 0 never came up?)")


def clear_rendezvous(group_id: str) -> None:
    """Drop the group's KV keys (gang teardown); a restarted gang has a
    fresh group_id, so this is hygiene, not correctness."""
    try:
        _kv().call("kv_del", {"key": _coord_key(group_id)})
    except Exception:  # noqa: BLE001 — best effort, GCS may be going down
        pass


def _holds_cards() -> bool:
    """Whether the raylet granted this process cards (CPU workers see
    CUDA_VISIBLE_DEVICES="")."""
    return bool(os.environ.get("CUDA_VISIBLE_DEVICES", "").strip())


def activate(ctx: Any, rendezvous_timeout_s: float = 30.0) -> ShardContext:
    """Join the gang: rendezvous over the GCS KV, then one
    torch.distributed group across the ranks. Idempotent for the same
    group_id; a different one raises — one process hosts one rank of one
    gang, ever (the default process group is global).
    """
    global _current, _mesh
    if isinstance(ctx, dict):
        ctx = ShardContext(**ctx)
    if _current is not None:
        if _current.group_id == ctx.group_id and _current.rank == ctx.rank:
            return _current
        raise RuntimeError(
            f"shard context already active for group {_current.group_id} "
            f"rank {_current.rank}; cannot re-activate as "
            f"{ctx.group_id} rank {ctx.rank}")

    spmd = bool(ctx.spmd) and ctx.world_size > 1
    if spmd:
        import datetime

        import torch.distributed as dist

        from ray_tpu_torch.parallel.distributed import get_address_and_port

        if ctx.is_coordinator:
            host, port = get_address_and_port()
            address = f"{host}:{port}"
            publish_coordinator(ctx.group_id, address)
        else:
            address = wait_coordinator(ctx.group_id, rendezvous_timeout_s)
        dist.init_process_group(
            "nccl" if _holds_cards() else "gloo",
            init_method=f"tcp://{address}", rank=ctx.rank,
            world_size=ctx.world_size,
            timeout=datetime.timedelta(seconds=rendezvous_timeout_s))

    ctx = ShardContext(group_id=ctx.group_id, rank=ctx.rank,
                       world_size=ctx.world_size, tp=ctx.tp, spmd=spmd,
                       pp=ctx.pp, sp=ctx.sp)
    _mesh = _build_stage_mesh(ctx)
    _current = ctx
    logger.info("shardgroup: rank %d/%d of %s active (tp=%d, pp=%d, "
                "sp=%d, spmd=%s)", ctx.rank, ctx.world_size, ctx.group_id,
                ctx.tp, ctx.pp, ctx.sp, spmd)
    return ctx


def _build_stage_mesh(ctx: ShardContext):
    """The gang's per-stage device mesh: ("sp", "tp") axes, size-1 axes
    dropped, over the sp x tp ranks of this rank's stage ("pp" is realized
    as stage processes exchanging activations, never as an axis of the
    stage's mesh). Every rank of the gang builds the whole (pp, sp, tp)
    mesh over the process group, together, and keeps its stage's
    sub-mesh; on the card where it holds one, on the CPU otherwise. None
    at tp = sp = 1. Raises where the gang has not one rank a card of its
    stage's mesh."""
    axes = {name: size for name, size in (("sp", ctx.sp), ("tp", ctx.tp))
            if size > 1}
    if not axes:
        return None
    need = math.prod(axes.values())
    per_stage = ctx.world_size // max(1, ctx.pp)
    if not ctx.spmd or per_stage != need:
        raise RuntimeError(
            f"shard group {ctx.group_id}: mesh axes {axes} need {need} "
            f"ranks a stage, one a card; the gang has {per_stage} "
            f"(world_size={ctx.world_size}, pp={ctx.pp})")
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    spec = MeshSpec({"pp": ctx.pp, **axes} if ctx.pp > 1 else axes)
    mesh = build_mesh(spec, device_type="cuda" if _holds_cards() else "cpu")
    if ctx.pp == 1:
        return mesh
    return mesh[tuple(axes)] if len(axes) > 1 else mesh[next(iter(axes))]


def current() -> Optional[ShardContext]:
    return _current


def current_mesh():
    """The active gang's stage mesh (a `DeviceMesh` with the "sp" and
    "tp" axes of size > 1) — None outside a gang or where tp = sp = 1.
    Deployments and trainers read it to take the sharded path."""
    return _mesh


def deactivate() -> None:
    """Test hook: forget the context and leave the process group."""
    global _current, _mesh
    if _current is not None and _current.spmd:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _current = None
    _mesh = None
