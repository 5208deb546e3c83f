"""Device mesh construction: dp / fsdp / tp / sp / ep axes over the ranks of
a torch.distributed group.

The port's copy of `ray_tpu/parallel/mesh.py`. Where the JAX package lays a
`jax.sharding.Mesh` over its devices, the port lays a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the current
process group, one rank a card: the mesh's axes name sub-groups of that
group (NCCL on the card, gloo on the CPU), over which the collectives of
the sharded code run.

Axis conventions (used by models/, train/):
  dp    data parallel (pure replication of params, sharded batch)
  fsdp  fully-sharded data parallel (params sharded over this axis too)
  pp    pipeline parallel (layer stages)
  tp    tensor/model parallel (matmul contraction sharding)
  sp    sequence/context parallel (ring attention shards over this)
  ep    expert parallel (MoE experts)

Importing this module imports no torch: `ScalingConfig` holds a `MeshSpec`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")


@dataclass
class MeshSpec:
    """Declarative mesh: axis name -> size; -1 on at most one axis = infer.

    `dcn_axes` marks axes that cross host boundaries (data parallelism over
    the slower network between hosts); they are laid out as the
    slowest-varying mesh dims, so consecutive ranks along the other axes
    are ranks of one host.
    """

    axes: Dict[str, int] = field(default_factory=dict)
    dcn_axes: Tuple[str, ...] = ()

    def resolved(self, n_devices: int) -> Dict[str, int]:
        axes = dict(self.axes)
        unknown = [k for k, v in axes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one axis may be -1")
        known = math.prod(v for v in axes.values() if v != -1)
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {axes}")
            axes[unknown[0]] = n_devices // known
        if math.prod(axes.values()) != n_devices:
            raise ValueError(
                f"mesh {axes} does not cover {n_devices} devices")
        return axes

    def axis_names(self) -> Tuple[str, ...]:
        ordered = [a for a in AXIS_ORDER if a in self.axes]
        extra = [a for a in self.axes if a not in AXIS_ORDER]
        return tuple(ordered + extra)

    @staticmethod
    def data_parallel() -> "MeshSpec":
        return MeshSpec({"dp": -1})

    @staticmethod
    def fsdp(tp: int = 1) -> "MeshSpec":
        return MeshSpec({"fsdp": -1, "tp": tp})

    @staticmethod
    def for_training(dp: int = 1, fsdp: int = -1, tp: int = 1, sp: int = 1
                     ) -> "MeshSpec":
        axes = {"dp": dp, "fsdp": fsdp, "tp": tp}
        if sp != 1:
            axes["sp"] = sp
        return MeshSpec(axes)


def _device_type(device_type: Optional[str]) -> str:
    """"cuda" unless "cpu" is asked for; raises when CUDA is wanted and
    absent (the port never drops to the CPU on its own)."""
    import torch

    device_type = device_type or "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass "
                               "device_type='cpu' for a mesh of CPU ranks")
    elif device_type != "cpu":
        raise ValueError(f"unsupported device type {device_type!r}: use "
                         "'cuda' or 'cpu'")
    return device_type


def build_mesh(spec: MeshSpec, devices: Optional[Sequence[int]] = None,
               device_type: Optional[str] = None):
    """A `DeviceMesh` from a MeshSpec over `devices`, the global ranks of
    the current process group (all of them by default), with the spec's
    axis names.

    DCN-crossing axes are placed as the leading (slowest-varying) dims, so
    consecutive ranks along the other axes are neighbours on one host. The
    ranks are laid out in order: the layout of one host. Every rank of the
    group must call this with the same arguments (each axis is a sub-group,
    and forming one is collective)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = _device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a torch.distributed group: call "
                           "initialize_distributed first")
    if devices is None:
        devices = range(dist.get_world_size())
    devices = list(devices)
    axes = spec.resolved(len(devices))
    names = spec.axis_names()
    # Order: DCN axes slowest. Reorder names so dcn axes come first.
    if spec.dcn_axes:
        dcn = [n for n in names if n in spec.dcn_axes]
        ici = [n for n in names if n not in spec.dcn_axes]
        names = tuple(dcn + ici)
    shape = tuple(axes[n] for n in names)
    ranks = torch.tensor(devices, dtype=torch.int).reshape(shape)
    if device_type == "cuda":
        # This process's card (card 0 of the ones it sees, unless the
        # caller chose another), not DeviceMesh's guess of rank % cards.
        torch.cuda.set_device(torch.cuda.current_device())
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def local_mesh(axis_name: str = "dp", device_type: Optional[str] = None):
    """Mesh over every rank of the group on one axis."""
    return build_mesh(MeshSpec({axis_name: -1}), device_type=device_type)


def mesh_shape_summary(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# The mesh axes the "batch" rule shards over (`sharding.DEFAULT_RULES`), in
# mesh order: together they are the data-parallel coordinate of a rank.
DATA_AXES = ("dcn_dp", "dp", "fsdp")


def axis_size(mesh, name: str) -> int:
    """The size of axis `name` (1 where the mesh lacks it)."""
    return mesh_shape_summary(mesh).get(name, 1)


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along axis `name` (0 where the mesh lacks
    it)."""
    if name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of this rank's line along axis `name`, or None
    where the mesh lacks it."""
    if name not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(name)


def data_parallel_size(mesh) -> int:
    """dcn_dp x dp x fsdp: how many distinct batch shards the mesh holds."""
    return math.prod(axis_size(mesh, a) for a in DATA_AXES)


def data_parallel_rank(mesh) -> int:
    """This rank's batch shard, 0 .. data_parallel_size - 1: its
    coordinates along dcn_dp, dp and fsdp, the first slowest (the order in
    which the "batch" rule splits the batch)."""
    rank = 0
    for a in DATA_AXES:
        rank = rank * axis_size(mesh, a) + axis_rank(mesh, a)
    return rank


def data_parallel_coords(spec: MeshSpec, world: int):
    """[(batch shard, number of shards)] for ranks 0 .. world - 1 of a mesh
    that `build_mesh(spec)` lays over `world` ranks: what
    `data_parallel_rank` and `data_parallel_size` return on each rank,
    computed without a process group (the trainer splits `datasets=` with
    it before any worker starts). tp and sp peers, and pp stages, of one
    coordinate share its shard."""
    axes = spec.resolved(world)
    names = list(spec.axis_names())
    if spec.dcn_axes:
        names = ([n for n in names if n in spec.dcn_axes]
                 + [n for n in names if n not in spec.dcn_axes])
    sizes = [axes[n] for n in names]
    data = [n for n in DATA_AXES if n in names]
    n_shards = math.prod(axes[n] for n in data)
    out = []
    for r in range(world):
        coord, rem = {}, r
        for name, size in zip(reversed(names), reversed(sizes)):
            coord[name] = rem % size
            rem //= size
        shard = 0
        for n in data:
            shard = shard * axes[n] + coord[n]
        out.append((shard, n_shards))
    return out


def validate_divisibility(mesh, batch_size: int, seq_len: Optional[int] = None,
                          n_head: Optional[int] = None,
                          n_kv_head: Optional[int] = None,
                          vocab_size: Optional[int] = None):
    """Fail fast on shapes that cannot be sharded evenly: the batch over
    dp x fsdp, the sequence over sp, and attention heads, KV heads and
    the vocab over tp (each rank holds its own heads and vocab rows)."""
    shape = mesh_shape_summary(mesh)
    data_ways = shape.get("dp", 1) * shape.get("fsdp", 1)
    if batch_size % data_ways:
        raise ValueError(
            f"global batch {batch_size} not divisible by dp*fsdp={data_ways}")
    sp = shape.get("sp", 1)
    if seq_len is not None and seq_len % max(sp, 1):
        raise ValueError(f"sequence length {seq_len} not divisible by sp={sp}")
    tp = shape.get("tp", 1)
    bad = {name: dim for name, dim in (("n_head", n_head),
                                       ("n_kv_head", n_kv_head),
                                       ("vocab_size", vocab_size))
           if dim is not None and dim % tp}
    if bad:
        raise ValueError(f"tp={tp} does not divide {bad}")
