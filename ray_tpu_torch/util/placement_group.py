"""Placement groups: atomic gang reservation of resource bundles.

Equivalent of `python/ray/util/placement_group.py` (:34 `PlacementGroup`,
:137 `placement_group()`): bundles are reserved across raylets via the GCS
prepare/commit 2PC and become `{resource}_group_{index}_{pgid}` resources
tasks/actors consume through `PlacementGroupSchedulingStrategy`.

GPU note: the trainer's worker group reserves one bundle per worker,
`{"CPU": c, "GPU": g}`, and its torch.distributed group runs over the
workers placed on them (`train/worker_group.py`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.common import PlacementGroupInfo, PlacementStrategy
from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.exceptions import GetTimeoutError, PlacementGroupUnschedulableError


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self._bundle_nodes: Optional[Dict[int, str]] = None

    def _fetch(self):
        import ray_tpu_torch

        runtime = ray_tpu_torch._require_runtime()
        return runtime.gcs.call("get_placement_group", {"pg_id": self.id})

    def ready(self, timeout: float = 60.0) -> "PlacementGroup":
        """Block until all bundles are committed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = self._fetch()
            if info.get("known"):
                if info["state"] == "CREATED":
                    self._bundle_nodes = {
                        i: n.hex() for i, n in info["bundle_locations"].items()}
                    return self
                if info["state"] in ("INFEASIBLE", "REMOVED"):
                    raise PlacementGroupUnschedulableError(
                        f"placement group {self.id.hex()[:12]} is {info['state']}")
            time.sleep(0.05)
        raise GetTimeoutError(
            f"placement group {self.id.hex()[:12]} not ready in {timeout}s")

    def wait(self, timeout_seconds: float = 60.0) -> bool:
        try:
            self.ready(timeout=timeout_seconds)
            return True
        except (GetTimeoutError, PlacementGroupUnschedulableError):
            return False

    def _bundle_node_hex(self, index: int) -> str:
        if self._bundle_nodes is None:
            self.ready()
        if index < 0:
            # Wildcard: any bundle's node; pick bundle 0's for affinity.
            return self._bundle_nodes[min(self._bundle_nodes)]
        return self._bundle_nodes[index]

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self.bundles

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: Optional[str] = None,
                    lifetime: Optional[str] = None) -> PlacementGroup:
    import ray_tpu_torch

    runtime = ray_tpu_torch._require_runtime()
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    pg_id = PlacementGroupID.of(runtime.job_id)
    info = PlacementGroupInfo(
        pg_id=pg_id,
        bundles=[{k: float(v) for k, v in b.items()} for b in bundles],
        strategy=PlacementStrategy(strategy),
        name=name,
        job_id=runtime.job_id,
        lifetime=lifetime,
    )
    runtime.gcs.call("create_placement_group", {"pg": info})
    return PlacementGroup(pg_id, info.bundles, strategy)


def remove_placement_group(pg: PlacementGroup):
    import ray_tpu_torch

    runtime = ray_tpu_torch._require_runtime()
    runtime.gcs.call("remove_placement_group", {"pg_id": pg.id})


def get_placement_group(name: str) -> PlacementGroup:
    """Look up a live placement group by name (reference
    `ray.util.get_placement_group`)."""
    import ray_tpu_torch

    runtime = ray_tpu_torch._require_runtime()
    resp = runtime.gcs.call("get_named_placement_group", {"name": name})
    if not resp.get("found"):
        raise ValueError(f"Failed to look up placement group {name!r}. "
                         "It was either not created or was removed.")
    return PlacementGroup(resp["pg_id"], resp["bundles"], resp["strategy"])


def placement_group_table(pg: Optional[PlacementGroup] = None):
    import ray_tpu_torch

    runtime = ray_tpu_torch._require_runtime()
    if pg is not None:
        info = runtime.gcs.call("get_placement_group", {"pg_id": pg.id})
        return {pg.id.hex(): info}
    return {}
