"""Logical-axis sharding rules and helpers.

The port's copy of `ray_tpu/parallel/sharding.py`. Parameters and
activations are annotated with *logical* axis names ("embed", "mlp",
"heads", "batch", "seq", ...); rules map logical axes to mesh axes
(dp/fsdp/tp/sp). Where the JAX package resolves them to a
`NamedSharding(mesh, PartitionSpec)`, the port resolves them to a
`(DeviceMesh, placements)` pair: one `Shard(dim)` or `Replicate()` per mesh
dimension, as `torch.distributed.tensor.distribute_tensor` takes them.

Importing this module imports no torch.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Default rules: FSDP shards embed dim; TP shards mlp/hidden + heads; SP
# shards sequence; batch over (dcn_dp +) dp + fsdp — dcn_dp is the
# cross-host data-parallel axis of a multi-host mesh (laid out
# slowest-varying by MeshSpec.dcn_axes).
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("dcn_dp", "dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("stage", "pp"),
    ("norm", None),
)


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of them (the dim split over those axes, the first slowest), as
    `jax.sharding.PartitionSpec` writes it. Unlisted trailing dims are
    replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def logical_axis_rules(overrides: Optional[Dict[str, Any]] = None,
                       mesh_axes: Optional[Sequence[str]] = None
                       ) -> List[Tuple[str, Any]]:
    """Rules as (logical, mesh-axis) pairs. When `mesh_axes` is given,
    targets not present in the mesh are pruned (a dp-only mesh must still
    shard "batch")."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    if mesh_axes is not None:
        pruned = {}
        for logical, target in rules.items():
            if isinstance(target, (tuple, list)):
                kept = tuple(t for t in target if t in mesh_axes)
                pruned[logical] = kept if kept else None
            else:
                pruned[logical] = target if target in mesh_axes else None
        rules = pruned
    return list(rules.items())


def placements_for(spec: Sequence, mesh_axes: Sequence[str]) -> tuple:
    """One placement per mesh dim from a PartitionSpec: `Shard(d)` on the
    mesh dims that split tensor dim d, `Replicate()` on the others. Axes
    the mesh lacks are dropped (replicated). A dim split over several axes
    is split in mesh order, so their order in the spec must be it."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh_axes)
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = [mesh_axes.index(a) for a in axes
               if a is not None and a in mesh_axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} is split over {axes}, against the "
                             f"mesh's order {tuple(mesh_axes)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def _spec_for(logical_axes: Sequence[Optional[str]], rules: Dict[str, Any],
              mesh_axes: Sequence[str]) -> tuple:
    """Placements (one per mesh dim) of a value whose dims carry these
    logical axes: a mesh axis is used once, by the first dim that asks for
    it."""
    out = []
    used = set()
    for ax in logical_axes:
        target = rules.get(ax) if ax is not None else None
        if target is None:
            out.append(None)
            continue
        if isinstance(target, (tuple, list)):
            present = tuple(t for t in target if t in mesh_axes and t not in used)
            used.update(present)
            out.append(present if present else None)
        else:
            if target in mesh_axes and target not in used:
                used.add(target)
                out.append(target)
            else:
                out.append(None)
    return placements_for(out, mesh_axes)


def named_sharding(mesh, *logical_axes: Optional[str],
                   rules: Optional[Dict[str, Any]] = None):
    """(mesh, placements) for a value whose dims carry these logical axis
    names."""
    rd = dict(DEFAULT_RULES)
    if rules:
        rd.update(rules)
    return mesh, _spec_for(logical_axes, rd, mesh.mesh_dim_names)


def with_logical_constraint(x, mesh, *logical_axes: Optional[str],
                            rules: Optional[Dict[str, Any]] = None):
    """A DTensor redistributed to the layout these logical axes give; a
    plain tensor (computed whole on every rank) as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    _, placements = named_sharding(mesh, *logical_axes, rules=rules)
    return x.redistribute(mesh, placements)


def shard_params(params: Dict[str, Any], mesh,
                 param_logical_axes: Dict[str, Optional[Sequence[str]]],
                 rules: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Place a state dict (name -> tensor) as DTensors according to
    per-name logical axes (None or () for replicated). Every rank passes
    the same values: rank 0's are scattered."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for name, p in params.items():
        _, placements = named_sharding(
            mesh, *(param_logical_axes[name] or ()), rules=rules)
        out[name] = distribute_tensor(p, mesh, placements)
    return out


def match_partition_rules(rules, params: Dict[str, Any]
                          ) -> Dict[str, PartitionSpec]:
    """Map every parameter of a state dict to a PartitionSpec by regex over
    its name (the port's dotted names, e.g. "layers.0.wq.weight"; the
    t5x/EasyLM idiom, the complement of the logical-axis rules above).

    `rules` is an ordered sequence of (regex, PartitionSpec); the FIRST
    pattern that `re.search`-matches a name wins. Scalars (ndim 0) always
    replicate. A name no rule matches raises — a silent fall-through to
    replicated would quietly undo tp sharding on a renamed param."""
    out = {}
    for name, leaf in params.items():
        if getattr(leaf, "ndim", 0) == 0:
            out[name] = PartitionSpec()
            continue
        for pattern, spec in rules:
            if re.search(pattern, name):
                out[name] = spec
                break
        else:
            raise ValueError(f"no partition rule matches param '{name}' — "
                             "add a rule (or an explicit catch-all) so the "
                             "placement stays deliberate")
    return out


def placements_by_rules(params: Dict[str, Any], mesh, rules
                        ) -> Dict[str, Any]:
    """{name: (mesh, placements)}: the layout `rules` assign each parameter
    on `mesh` (axes the mesh lacks are pruned to replicated on those dims,
    so one rule table serves every (tp, sp) submesh)."""
    specs = match_partition_rules(rules, params)
    return {name: (mesh, placements_for(specs[name], mesh.mesh_dim_names))
            for name in params}


def shard_params_by_rules(params: Dict[str, Any], mesh, rules
                          ) -> Dict[str, Any]:
    """Place a state dict as DTensors in the layout `rules` assigns on
    `mesh` (`placements_by_rules`)."""
    from torch.distributed.tensor import distribute_tensor

    placed = placements_by_rules(params, mesh, rules)
    return {name: distribute_tensor(leaf, *placed[name])
            for name, leaf in params.items()}


def replicated(mesh):
    from torch.distributed.tensor import Replicate

    return mesh, (Replicate(),) * mesh.ndim


def batch_sharding(mesh):
    """Sharding for host data entering the program: batch over dp(+fsdp)."""
    return named_sharding(mesh, "batch")


def shard_batch(batch, mesh, logical_axes: Sequence[Optional[str]] = (
        "batch", "seq")):
    """This rank's shard of a global batch: a dict of arrays or tensors (or
    one) whose leading dims carry `logical_axes`, sliced as the rules
    place them on `mesh` (by default the batch over dcn_dp, dp and fsdp,
    the sequence over sp; tp and pp peers get the same slice). Every dim
    must divide evenly. numpy arrays stay numpy: slices are views."""
    from torch.distributed.tensor import Shard

    _, placements = named_sharding(mesh, *logical_axes)

    def one(x):
        index = []
        for dim, size in enumerate(x.shape[:len(logical_axes)]):
            shard, count = 0, 1
            for mesh_dim, pl in enumerate(placements):
                if isinstance(pl, Shard) and pl.dim == dim:
                    shard = shard * mesh.size(mesh_dim) \
                        + mesh.get_local_rank(mesh_dim)
                    count *= mesh.size(mesh_dim)
            if size % count:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split {count} ways")
            n = size // count
            index.append(slice(shard * n, (shard + 1) * n))
        return x[tuple(index)]

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)
