"""Dynamic custom resources (reference
`python/ray/experimental/dynamic_resources.py`): change a node's custom
resource capacity at runtime — tasks queued on the resource dispatch as
soon as capacity appears, without restarting the node.
"""

from __future__ import annotations

from typing import Optional


def set_resource(resource_name: str, capacity: float,
                 node_id: Optional[str] = None) -> None:
    """Set `resource_name`'s TOTAL capacity on a node (default: the
    caller's node). capacity=0 deletes the resource. Built-in resources
    (CPU/GPU/memory) cannot be overridden; a node's GPU grants are
    untouched."""
    import ray_tpu_torch
    from ray_tpu_torch.core.ids import NodeID

    runtime = ray_tpu_torch._global_runtime
    if runtime is None:
        raise RuntimeError("ray_tpu_torch.init() first")
    nid = (NodeID.from_hex(node_id) if isinstance(node_id, str)
           else node_id) or runtime.node_id
    runtime.gcs.call("set_node_resource",
                     {"resource_name": resource_name,
                      "capacity": float(capacity), "node_id": nid},
                     timeout=15)
