"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside `ray_tpu/`: it imports torch, never jax, and
nothing of `ray_tpu`. The core API is the reference's
(`ray_tpu/__init__.py`): `init`, `shutdown`, `remote`, `method`, `get`,
`put`, `wait`, `get_actor`, `kill`, `cancel`, the `kv_*` functions,
`nodes`, `cluster_resources`, `available_resources` and `timeline`, with
`GPU` as the accelerator resource (`init(num_gpus=)`, `@remote(num_gpus=)`).
The training tier is `ray_tpu_torch.train`, the models and kernels are
under `ray_tpu_torch.models` and `ray_tpu_torch.ops`. Entry points that
compute run on the CUDA card unless the caller passes `device="cpu"`.

`import ray_tpu_torch` does not import torch, so that control-plane
processes and the worker forge's template stay light and leave CUDA
uninitialised; `resolve_device` is loaded on first use.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._version import __version__
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.runtime import CoreRuntime
from ray_tpu_torch.exceptions import (  # noqa: F401 (re-exported)
    GetTimeoutError,
    ObjectLostError,
    RayActorError,
    RaySystemError,
    RayTaskError,
    RayTpuError,
    TaskCancelledError,
)
from ray_tpu_torch.object_ref import ObjectRef
from ray_tpu_torch.remote_function import RemoteFunction

logger = logging.getLogger(__name__)

_global_runtime: Optional[CoreRuntime] = None
_global_node = None
_init_lock = threading.RLock()


def is_initialized() -> bool:
    return _global_runtime is not None


def _require_runtime() -> CoreRuntime:
    global _global_runtime
    if _global_runtime is None:
        init()
    return _global_runtime


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: int = 0,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    labels: Optional[Dict[str, str]] = None,
    _system_config: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Start a head node in-process (address=None) or connect a driver to an
    existing cluster (address="host:port" of the GCS)."""
    global _global_runtime, _global_node
    with _init_lock:
        if _global_runtime is not None:
            if ignore_reinit_error:
                return _context_info()
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(pass ignore_reinit_error=True to allow)")
        if address is None:
            # Submitted-job entrypoints (and any child process of a cluster)
            # inherit the cluster address from the environment.
            address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
        if address == "auto":
            # Connect to the cluster `python -m ray_tpu_torch start --head`
            # left running on this machine (reference:
            # /tmp/ray/ray_current_cluster).
            from ray_tpu_torch.scripts.cluster_cli import read_cluster_address

            address = read_cluster_address()
            if address is None:
                raise RaySystemError(
                    'init(address="auto"): no running cluster found — start '
                    "one with `python -m ray_tpu_torch start --head`")
        # Env vars set since the last session must be observed (the
        # memoized read cache is per-process; explicit sets persist).
        GLOBAL_CONFIG.refresh()
        GLOBAL_CONFIG.initialize(_system_config)
        from ray_tpu_torch.core.node import Node

        if address is not None and address.startswith("ray://"):
            # Client mode (reference Ray Client): no local raylet or shared
            # memory — every operation proxies to the head's client server.
            from ray_tpu_torch.client import connect

            _global_runtime = connect(address[len("ray://"):],
                                      namespace=namespace)
            atexit.register(shutdown)
            return _context_info()
        if address is None or address == "local":
            _global_node = Node(
                head=True,
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
                object_store_memory=object_store_memory,
            )
            gcs_address = _global_node.gcs_address
            raylet_address = _global_node.raylet_address
            session_suffix = _global_node.session_suffix
            node_id = _global_node.node_id
        else:
            gcs_address = address
            # Attach to a raylet on this machine (prefer the head node's).
            from ray_tpu_torch.core.rpc import RpcClient

            probe = RpcClient(gcs_address, name="init-probe")
            try:
                # Probing under _init_lock is deliberate: init() is a
                # one-shot — a concurrent init/shutdown must wait for the
                # connect outcome anyway, and the probe carries a timeout.
                nodes_ = probe.call("get_nodes")  # raylint: disable=RL002
            finally:
                probe.close()
            alive = [n for n in nodes_ if n["Alive"]]
            if not alive:
                raise RaySystemError("no alive nodes in cluster")
            head = next((n for n in alive if n.get("IsHead")), alive[0])
            raylet_address = head["RayletAddress"]
            from ray_tpu_torch.core.ids import NodeID

            node_id = NodeID.from_hex(head["NodeID"])
            probe2 = RpcClient(raylet_address, name="init-probe2")
            try:
                session_suffix = probe2.call(  # raylint: disable=RL002
                    "get_session_suffix")["session_suffix"]
            finally:
                probe2.close()
        _global_runtime = CoreRuntime(
            gcs_address=gcs_address,
            raylet_address=raylet_address,
            session_suffix=session_suffix,
            node_id=node_id,
            is_driver=True,
            namespace=namespace,
        )
        atexit.register(shutdown)
        return _context_info()


def _context_info() -> Dict[str, Any]:
    return {
        "gcs_address": _global_runtime.gcs.address,
        "raylet_address": getattr(
            getattr(_global_runtime, "raylet", None), "address", None),
        "node_id": _global_runtime.node_id.hex() if _global_runtime.node_id else None,
        "job_id": _global_runtime.job_id.hex(),
        "session_dir": getattr(_global_node, "session_dir", None),
        "dashboard_url": getattr(
            getattr(_global_node, "dashboard", None), "url", None),
    }


def shutdown():
    global _global_runtime, _global_node
    with _init_lock:
        if _global_runtime is not None:
            try:
                _global_runtime.shutdown()
            except Exception:
                pass
            _global_runtime = None
        if _global_node is not None:
            try:
                _global_node.shutdown()
            except Exception:
                pass
            _global_node = None


# ----------------------------------------------------------------- decorator


def remote(*args, **kwargs):
    """`@ray_tpu_torch.remote` on a function -> RemoteFunction; on a class
    -> ActorClass. With arguments: `@ray_tpu_torch.remote(num_cpus=2,
    num_gpus=1)`."""

    def make(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return make


def method(num_returns: int = 1, **_ignored):
    """Decorator to annotate actor methods with num_returns."""

    def wrap(m):
        m.__ray_num_returns__ = num_returns
        return m

    return wrap


# ----------------------------------------------------------------- data ops


def put(value: Any) -> ObjectRef:
    runtime = _require_runtime()
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return ObjectRef(runtime.put(value))


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    runtime = _require_runtime()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    values = runtime.get([r.object_id for r in ref_list], timeout=timeout)
    return values[0] if single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    runtime = _require_runtime()
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    ids = [r.object_id for r in refs]
    ready_ids, pending_ids = runtime.wait(ids, num_returns=num_returns,
                                          timeout=timeout)
    by_bin = {r.object_id.binary(): r for r in refs}
    return ([by_bin[o.binary()] for o in ready_ids],
            [by_bin[o.binary()] for o in pending_ids])


# ----------------------------------------------------------------- actors


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    runtime = _require_runtime()
    actor_id, spec = runtime.get_named_actor(name, namespace)
    return ActorHandle(actor_id, spec.name if spec else "Actor")


def kill(actor: ActorHandle, *, no_restart: bool = True):
    runtime = _require_runtime()
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle; use cancel() for tasks")
    runtime.kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Cancel the task that produces `ref` (reference `ray.cancel`):
    queued tasks are dropped; running tasks are interrupted (force=True
    kills the worker process). get() on the ref raises TaskCancelledError.
    Actor tasks: queued calls cancel; running async calls are interrupted
    at their next await; running sync calls are uninterruptible and
    force=True is rejected (it would destroy actor state)."""
    _require_runtime().cancel(ref.object_id, force=force)


# ------------------------------------------------------------ job-scoped KV


def kv_put(key: str, value: bytes, namespace: Optional[str] = None) -> None:
    """Store small metadata in the cluster KV, scoped to the calling
    job: keys live under a `job:<id>:` prefix and are purged when the
    job finishes — cross-job sharing goes through named detached actors
    or storage, never the KV."""
    _require_runtime().kv_put(key, value, namespace)


def kv_get(key: str, namespace: Optional[str] = None) -> Optional[bytes]:
    return _require_runtime().kv_get(key, namespace)


def kv_del(key: str, namespace: Optional[str] = None) -> None:
    _require_runtime().kv_del(key, namespace)


# ----------------------------------------------------------------- cluster


def nodes() -> List[Dict[str, Any]]:
    return _require_runtime().gcs.call("get_nodes")


def cluster_resources() -> Dict[str, float]:
    return _require_runtime().gcs.call("cluster_resources")["total"]


def available_resources() -> Dict[str, float]:
    return _require_runtime().gcs.call("cluster_resources")["available"]


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """Task lifecycle events; with `filename`, write chrome://tracing JSON
    (reference `ray.timeline`) — load it in chrome://tracing or Perfetto."""
    # limit=0 -> the GCS's full retained ring, not the 10k default slice.
    events = _require_runtime().gcs.call(
        "get_task_events", {"limit": 0})["events"]
    if filename is not None:
        import json as _json

        starts: Dict[str, Dict[str, Any]] = {}
        trace: List[Dict[str, Any]] = []
        for ev in events:
            if ev.get("state") == "RUNNING":
                starts[ev["task_id"]] = ev
            elif ev.get("state") in ("FINISHED", "FAILED"):
                st = starts.pop(ev["task_id"], None)
                if st is None:
                    continue
                trace.append({
                    "name": st.get("name", "task"),
                    "cat": "task",
                    "ph": "X",
                    "ts": st["ts"] * 1e6,
                    "dur": max(0.0, (ev["ts"] - st["ts"]) * 1e6),
                    "pid": st.get("node_id", "node"),
                    "tid": f"worker:{st.get('worker_id')}",
                    "args": {"state": ev["state"],
                             "task_id": ev["task_id"],
                             **{k: st[k] for k in
                                ("trace_id", "span_id", "parent_span_id")
                                if st.get(k) is not None}},
                })
        with open(filename, "w") as f:
            _json.dump(trace, f)
    return events


def __getattr__(name: str):
    # `resolve_device` imports torch: loaded on first use, not at import.
    if name == "resolve_device":
        from ray_tpu_torch._torch_env import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "__version__", "init", "shutdown", "is_initialized", "remote", "method",
    "put", "get", "wait", "get_actor", "kill", "cancel", "nodes",
    "cluster_resources", "available_resources", "timeline", "ObjectRef",
    "ActorHandle", "ActorClass", "RemoteFunction",
    "kv_put", "kv_get", "kv_del", "resolve_device",
]
