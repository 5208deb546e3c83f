"""The port's parallelism layer: meshes, shardings, distributed init.

Counterpart of `ray_tpu.parallel`: parallelism is expressed as a named
`DeviceMesh` over the ranks of one torch.distributed group (NCCL on the
card, gloo on the CPU) plus sharding annotations resolved to DTensor
placements, where the JAX package has a `jax.sharding.Mesh` whose
collectives XLA compiles. Importing it imports no torch: the pipeline
schedule (`parallel/pipeline.py`, GPipe over the pp axis) is exported
lazily, on first use of one of its names.
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

_PIPELINE = (
    "gpipe", "make_pp_train_step", "sequential_forward", "stage_shardings",
    "stack_stage_params", "unstack_stage_params", "to_microbatches",
    "from_microbatches", "init_pp_lm", "init_block_params", "block_apply",
)

__all__ = [
    "MeshSpec", "build_mesh", "local_mesh", "logical_axis_rules",
    "named_sharding", "shard_params", "with_logical_constraint",
    "DistributedContext", "initialize_distributed", *_PIPELINE,
]


def __getattr__(name):
    if name in _PIPELINE:
        from ray_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
