"""The port's parallelism layer: meshes, shardings, distributed init.

Counterpart of `ray_tpu.parallel`: parallelism is expressed as a named
`DeviceMesh` over the ranks of one torch.distributed group (NCCL on the
card, gloo on the CPU) plus sharding annotations resolved to DTensor
placements, where the JAX package has a `jax.sharding.Mesh` whose
collectives XLA compiles. Importing it imports no torch.
"""

from ray_tpu_torch.parallel.mesh import (
    MeshSpec,
    build_mesh,
    local_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    logical_axis_rules,
    named_sharding,
    shard_params,
    with_logical_constraint,
)
from ray_tpu_torch.parallel.distributed import (
    DistributedContext,
    initialize_distributed,
)

__all__ = [
    "MeshSpec", "build_mesh", "local_mesh", "logical_axis_rules",
    "named_sharding", "shard_params", "with_logical_constraint",
    "DistributedContext", "initialize_distributed",
]
