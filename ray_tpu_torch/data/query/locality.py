"""Locality-routed consumption for the query tier.

The windowed shuffle's reduce tasks concat N bucket blocks scattered
across the cluster; left to the default policy they land wherever a
lease is warm and drag every bucket over the link model. This module
resolves bucket locations from the GCS object directory in ONE batch
RPC per partition and pins the reduce (softly) to the node already
holding the most bucket bytes — the task moves to the data, reference
`LocalityAwareLeasePolicy` (`lease_policy.h:56`), but for the data
plane's exchange operators instead of lease scoring.

Routing is advisory everywhere: a directory miss, a dead node, or the
`data_locality_routing` knob being off all degrade to the default
placement — never an error. Counters (`stats()`) record routed vs
fallback decisions so a benchmark can A/B the cross-node byte savings.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_stats = {"routed": 0, "fallback": 0}


def reset_stats() -> None:
    with _lock:
        _stats["routed"] = 0
        _stats["fallback"] = 0


def stats() -> Dict[str, int]:
    with _lock:
        return dict(_stats)


def _note(routed: bool) -> None:
    with _lock:
        _stats["routed" if routed else "fallback"] += 1


def _node_hex(node: Any) -> str:
    """Directory entries carry NodeID objects; every consumer here keys
    and compares by hex string (the form `local_node_hex` and
    `NodeAffinitySchedulingStrategy` speak)."""
    return node.hex() if hasattr(node, "hex") else str(node)


def locations_batch(refs: List[Any]) -> List[Dict[str, Any]]:
    """Directory entries (nodes + size, no payloads) for a list of
    ObjectRefs, one RPC; node ids normalized to hex strings. Empty on
    any failure — locality is advisory."""
    import ray_tpu_torch

    runtime = getattr(ray_tpu_torch, "_global_runtime", None)
    if runtime is None or not refs:
        return []
    try:
        resp = runtime.gcs.call(
            "object_locations_batch",
            {"object_ids": [r.object_id for r in refs]}, timeout=10)
        entries = resp.get("entries", [])
    except Exception:  # noqa: BLE001 — advisory, never fatal
        return []
    for entry in entries:
        entry["nodes"] = [_node_hex(n) for n in entry.get("nodes") or ()]
    return entries


def best_node_for(refs: List[Any]) -> Optional[str]:
    """Node hex holding the most resident bytes of `refs` (each holder
    has a full copy, so every listed node is charged the object's size).
    None when nothing is known — e.g. all blocks rode the GCS inline
    path and live nowhere in particular."""
    resident: Dict[str, int] = {}
    for entry in locations_batch(refs):
        if not entry.get("known"):
            continue
        size = int(entry.get("size") or 0)
        if size <= 0:
            continue
        for node_hex in entry.get("nodes", ()):
            resident[node_hex] = resident.get(node_hex, 0) + size
    if not resident:
        return None
    # Deterministic argmax (ties break by hex) so reruns route alike.
    return max(sorted(resident), key=lambda n: resident[n])


def reduce_affinity(refs: List[Any]) -> Optional[Dict[str, Any]]:
    """`.options()` kwargs pinning a reduce task (softly) onto the node
    holding most of its bucket bytes; None = no information, place by
    the default policy. Counts the decision either way."""
    node_hex = best_node_for(refs)
    if node_hex is None:
        _note(routed=False)
        return None
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    _note(routed=True)
    return {"scheduling_strategy":
            NodeAffinitySchedulingStrategy(node_hex, soft=True)}


def local_node_hex() -> Optional[str]:
    """This process's node, when known (driver and workers both carry
    it); None outside a cluster."""
    import ray_tpu_torch

    runtime = getattr(ray_tpu_torch, "_global_runtime", None)
    if runtime is None or runtime.node_id is None:
        return None
    return runtime.node_id.hex()


def block_is_local(ref: Any) -> bool:
    """Sealed copy already in THIS node's store (shared-memory read, no
    transfer at all)?"""
    import ray_tpu_torch

    runtime = getattr(ray_tpu_torch, "_global_runtime", None)
    if runtime is None:
        return False
    try:
        return runtime.store.contains(ref.object_id)
    except Exception:  # noqa: BLE001 — store mid-shutdown
        return False
