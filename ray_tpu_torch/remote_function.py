"""RemoteFunction: `@ray_tpu_torch.remote` on a function.

Equivalent of `python/ray/remote_function.py` (`RemoteFunction._remote`): the
function is exported once to the GCS function table; each `.remote()` builds a
TaskSpec and submits through the runtime (spillback handled there).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import TaskSpec, normalize_resources
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import TaskID
from ray_tpu_torch.object_ref import ObjectRef

_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "memory", "resources", "num_returns",
    "max_retries", "retry_exceptions", "name", "scheduling_strategy",
    "runtime_env", "max_calls", "_metadata",
}


def _resolve_pg_strategy(options: Dict[str, Any], resources: Dict[str, float]):
    """Rewrite resources to placement-group bundle resource names and pin the
    task to the bundle's node (reference: BundleSpec resource formatting)."""
    from ray_tpu_torch.util.placement_group import PlacementGroup
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    strategy = options.get("scheduling_strategy")
    if not isinstance(strategy, PlacementGroupSchedulingStrategy):
        return resources, strategy, None, -1
    pg: PlacementGroup = strategy.placement_group
    idx = strategy.placement_group_bundle_index
    node_hex = pg._bundle_node_hex(idx)
    from ray_tpu_torch.core.common import (
        pg_bundle_resource_name,
        pg_wildcard_resource_name,
    )

    renamed: Dict[str, float] = {}
    for r, amt in resources.items():
        if idx >= 0:
            renamed[pg_bundle_resource_name(r, idx, pg.id)] = amt
        else:
            renamed[pg_wildcard_resource_name(r, pg.id)] = amt
    return renamed, NodeAffinitySchedulingStrategy(node_hex, soft=False), pg.id, idx


class RemoteFunction:
    def __init__(self, function, options: Optional[Dict[str, Any]] = None):
        self._function = function
        self._options = dict(options or {})
        bad = set(self._options) - _VALID_OPTIONS
        if bad:
            raise ValueError(f"Invalid @remote options: {bad}")
        self._function_blob: Optional[bytes] = None
        # Per-(runtime, function) submit-path caches: the exported
        # function id (sha1 of the blob — constant per function) and the
        # normalized resource shape (constant per options dict). Keyed
        # by the exporting runtime's worker_id (NOT a weakref — a
        # RemoteFunction captured in a task closure must stay
        # picklable), so a fresh session re-exports to its GCS.
        self._function_id: Optional[str] = None
        self._cached_resources: Optional[Dict[str, float]] = None
        self._cached_rt_key = None  # worker_id of the exporting runtime
        self._name = getattr(function, "__qualname__", getattr(function, "__name__", "fn"))
        functools.update_wrapper(self, function)

    def options(self, **kwargs) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(kwargs)
        return RemoteFunction(self._function, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._name}' cannot be called directly; use "
            f"'{self._name}.remote()' or access the original via '.func'.")

    @property
    def func(self):
        return self._function

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node instead of submitting (reference
        `ray.dag`): compose with other bound nodes, run via execute()."""
        raise NotImplementedError(
            "bind() needs ray_tpu_torch.dag, not ported yet (ROADMAP M11)")

    def remote(self, *args, **kwargs):
        import ray_tpu_torch

        runtime = ray_tpu_torch._require_runtime()
        opts = self._options
        if self._cached_rt_key != runtime.worker_id:
            # New session (or first call): (re-)export to this runtime's
            # GCS and rebuild the per-runtime caches.
            if self._function_blob is None:
                self._function_blob = serialization.dumps(self._function)
            self._function_id = runtime.export_function(self._function_blob)
            self._cached_resources = normalize_resources(
                num_cpus=opts.get("num_cpus"),
                num_gpus=opts.get("num_gpus"),
                memory=opts.get("memory"),
                resources=opts.get("resources"),
                default_cpus=1.0,
            )
            self._cached_rt_key = runtime.worker_id
        function_id = self._function_id
        # Fresh copy per spec: downstream (PG renaming, lease keying)
        # treats spec.resources as its own.
        resources = dict(self._cached_resources)
        resources, strategy, pg_id, bundle_idx = _resolve_pg_strategy(opts, resources)
        ser_args, kwargs_keys, nested_refs = runtime.serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=TaskID.for_task(runtime.job_id),
            job_id=runtime.job_id,
            name=opts.get("name") or self._name,
            function_id=function_id,
            function_blob=None,
            args=ser_args,
            kwargs_keys=kwargs_keys,
            num_returns=opts.get("num_returns", 1),
            resources=resources,
            max_retries=opts.get("max_retries", GLOBAL_CONFIG.task_max_retries),
            retry_exceptions=opts.get("retry_exceptions", False),
            scheduling_strategy=strategy,
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle_idx,
            owner_address=runtime.worker_id.hex(),
            runtime_env=opts.get("runtime_env"),
            nested_refs=nested_refs,
        )
        return_ids = runtime.submit_task(spec)
        refs = [ObjectRef(oid) for oid in return_ids]
        if spec.num_returns == 1:
            return refs[0]
        return refs
