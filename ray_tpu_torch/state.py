"""State observability API.

Equivalent of the reference's state API (`python/ray/experimental/state/api.py`
:115 StateApiClient, :754 list_actors, :1302 summarize_tasks, served by
`dashboard/state_aggregator.py`): list cluster entities and summarize tasks.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional


def _gcs():
    import ray_tpu_torch

    return ray_tpu_torch._require_runtime().gcs


def list_nodes() -> List[Dict[str, Any]]:
    return _gcs().call("get_nodes")


def list_actors(filters: Optional[List] = None) -> List[Dict[str, Any]]:
    actors = _gcs().call("get_actors")
    if filters:
        for key, op, value in filters:
            assert op == "=", "only equality filters supported"
            actors = [a for a in actors if a.get(key) == value]
    return actors


def list_jobs() -> List[Dict[str, Any]]:
    return _gcs().call("get_jobs")


def list_named_actors(namespace: Optional[str] = None,
                      all_namespaces: bool = False) -> List[Dict[str, Any]]:
    """Registered actor names as [{"namespace", "name"}, ...] — the
    reference's `ray.util.list_named_actors`. With `namespace` omitted
    it lists the CURRENT runtime namespace, matching get_actor's
    resolution — not the GCS's literal "default"."""
    import ray_tpu_torch

    if namespace is None:
        namespace = ray_tpu_torch._require_runtime().namespace
    req: Dict[str, Any] = {"all_namespaces": all_namespaces,
                           "namespace": namespace}
    return _gcs().call("list_named_actors", req)["names"]


def list_placement_groups() -> List[Dict[str, Any]]:
    # PGs are published per-id; enumerate via the GCS table dump.
    import ray_tpu_torch

    runtime = ray_tpu_torch._require_runtime()
    return runtime.gcs.call("get_task_events", {"limit": 0}).get("pgs", []) or []


def list_tasks(limit: int = 10000) -> List[Dict[str, Any]]:
    return _gcs().call("get_task_events", {"limit": limit})["events"]


def list_objects() -> List[Dict[str, Any]]:
    import ray_tpu_torch

    runtime = ray_tpu_torch._require_runtime()
    out = []
    for node in runtime.gcs.call("get_nodes"):
        if not node["Alive"]:
            continue
        from ray_tpu_torch.core.rpc import RpcClient

        client = RpcClient(node["RayletAddress"], name="state-probe")
        try:
            state = client.call("debug_state")
            out.append({"NodeID": node["NodeID"], "Store": state["store"]})
        finally:
            client.close()
    return out


def summarize_tasks() -> Dict[str, Any]:
    events = list_tasks()
    by_name = Counter(e.get("name", "?") for e in events)
    by_state = Counter(e.get("state", "?") for e in events)
    return {"by_func_name": dict(by_name), "by_state": dict(by_state),
            "total": len(events)}


def summarize_actors() -> Dict[str, Any]:
    actors = list_actors()
    by_state = Counter(a["State"] for a in actors)
    by_class = Counter(a["ClassName"] for a in actors)
    return {"by_state": dict(by_state), "by_class": dict(by_class),
            "total": len(actors)}


def cluster_summary() -> Dict[str, Any]:
    import ray_tpu_torch

    return {
        "nodes": len([n for n in list_nodes() if n["Alive"]]),
        "resources_total": ray_tpu_torch.cluster_resources(),
        "resources_available": ray_tpu_torch.available_resources(),
        "actors": summarize_actors(),
    }
