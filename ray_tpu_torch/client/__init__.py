"""Ray-client-equivalent: drive a cluster from a machine that isn't in it.

`ray_tpu_torch.init(address="ray://host:gcs_port")` builds a ClientRuntime — an
implementation of the runtime surface the public API uses (put/get/wait,
task/actor submission, named actors, GCS queries) that proxies every
operation over one RPC connection to the ClientServer on the head node
(reference `ray/util/client/`). No local raylet or shared memory needed:
values travel serialized over the wire, and the server holds object
references on the client's behalf (released on disconnect).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.rpc import RpcClient
from ray_tpu_torch.exceptions import RaySystemError, RayTaskError

from ray_tpu_torch.client.server import CLIENT_SERVER_KV_KEY, ClientServer

__all__ = ["ClientRuntime", "ClientServer", "connect"]


def connect(gcs_address: str, namespace: str = "default") -> "ClientRuntime":
    """Resolve the head's client server through the GCS KV and connect."""
    gcs = RpcClient(gcs_address, name="client->gcs-bootstrap")
    try:
        value = gcs.call("kv_get", {"namespace": "cluster",
                                    "key": CLIENT_SERVER_KV_KEY})["value"]
    finally:
        gcs.close()
    if not value:
        raise RaySystemError(
            "cluster has no client server (head started with "
            "enable_client_server=False?)")
    return ClientRuntime(value.decode(), gcs_address=gcs_address,
                         namespace=namespace)


class _GcsShim:
    """`runtime.gcs.call(...)` routed through the proxy. `address` is the
    REAL GCS endpoint (init()['gcs_address'] must be reusable by other
    processes), not the proxy's."""

    def __init__(self, client_runtime: "ClientRuntime", gcs_address: str):
        self._rt = client_runtime
        self.address = gcs_address

    def call(self, method: str, data: Any = None,
             timeout: Optional[float] = None):
        return self._rt._call("client_gcs", {"method": method, "data": data},
                              timeout=timeout)


class ClientRuntime:
    """Duck-typed CoreRuntime for remote clients."""

    is_driver = True

    # Client-side loop slice for blocking ops, paired with the server's
    # bounded BLOCK_SLICE_S so a never-resolving get can't wedge the
    # connection (each slice returns; the loop decides whether to go on).
    _SLICE_S = 30.0

    def __init__(self, server_address: str,
                 gcs_address: Optional[str] = None,
                 namespace: str = "default"):
        from ray_tpu_torch.core.ids import WorkerID

        self.address = server_address
        self._client = RpcClient(server_address, name="ray-client")
        hello = self._client.call("client_hello")
        self.job_id = hello["job_id"]
        self.namespace = namespace or hello["namespace"]
        self.worker_id = WorkerID.from_random()
        self.node_id = None
        self.gcs = _GcsShim(self, gcs_address or server_address)
        self._lock = threading.Lock()
        self._ref_counts: Dict[bytes, int] = {}
        self._env_cache = None  # lazy runtime_env.EnvCache
        self._closed = False

    # ------------------------------------------------------------ plumbing

    def _call(self, method: str, data: Any = None,
              timeout: Optional[float] = None):
        resp = self._client.call(method, data,
                                 timeout=timeout or
                                 GLOBAL_CONFIG.rpc_call_timeout_s)
        if isinstance(resp, dict) and resp.get("error") is not None:
            err = serialization.deserialize_exception(resp["error"])
            if isinstance(err, RayTaskError):
                raise err.as_instanceof_cause()
            raise err
        return resp["ok"] if isinstance(resp, dict) and "ok" in resp else resp

    # ------------------------------------------------------ object surface

    def put(self, value: Any, _owner=None, _register: bool = True):
        return self._call("client_put",
                          {"blob": serialization.serialize_to_bytes(value),
                           "register": _register})

    def get(self, object_ids: List, timeout: Optional[float] = None):
        import time

        from ray_tpu_torch.exceptions import GetTimeoutError

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            req_t = self._SLICE_S if remaining is None \
                else min(remaining, self._SLICE_S)
            try:
                blobs = self._call(
                    "client_get",
                    {"object_ids": object_ids, "timeout": req_t},
                    timeout=req_t + 30)
                return [serialization.deserialize(b) for b in blobs]
            except GetTimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                # timeout=None semantics: keep slicing forever.

    def wait(self, object_ids: List, num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[List, List]:
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            req_t = self._SLICE_S if remaining is None \
                else min(remaining, self._SLICE_S)
            ready, pending = self._call(
                "client_wait", {"object_ids": object_ids,
                                "num_returns": num_returns,
                                "timeout": req_t},
                timeout=req_t + 30)
            if len(ready) >= num_returns or not pending or \
                    (deadline is not None and time.monotonic() >= deadline):
                return ready, pending

    # -------------------------------------------------------- task surface

    def export_function(self, blob: bytes) -> str:
        import hashlib

        fn_id = hashlib.sha1(blob).hexdigest()
        self.gcs.call("kv_put", {"namespace": "fn", "key": fn_id.encode(),
                                 "value": blob, "overwrite": False})
        return fn_id

    def serialize_args(self, args, kwargs):
        from ray_tpu_torch.object_ref import ObjectRef, _NestedRefCapture

        out = []
        nested = []
        flat = list(args) + list(kwargs.values())
        for a in flat:
            if isinstance(a, ObjectRef):
                out.append(("r", a.object_id))
            else:
                with _NestedRefCapture() as captured:
                    blob = serialization.serialize_to_bytes(a)
                nested.extend(captured)
                if len(blob) > GLOBAL_CONFIG.object_inline_max_bytes:
                    # Promoted args live with the job (no per-client pin —
                    # nothing client-side would ever drop the ref).
                    out.append(("r", self.put(a, _register=False)))
                else:
                    out.append(("v", blob))
        return out, list(kwargs.keys()), nested

    def submit_task(self, spec) -> List:
        spec.runtime_env = self._prepare_runtime_env(spec.runtime_env)
        return self._call("client_submit", {"spec": spec})

    def _prepare_runtime_env(self, renv):
        """Package working_dir/py_modules on the CLIENT machine (the paths
        are client-local) and upload through the GCS proxy; the in-cluster
        server then sees only content URIs."""
        if not renv or not (renv.get("working_dir")
                            or renv.get("py_modules")):
            return renv
        if self._env_cache is None:
            from ray_tpu_torch.core.runtime_env import EnvCache

            self._env_cache = EnvCache(self.gcs)
        return self._env_cache.prepare(renv)

    # ------------------------------------------------------- actor surface

    def create_actor(self, spec):
        spec.runtime_env = self._prepare_runtime_env(spec.runtime_env)
        return self._call("client_create_actor", {"spec": spec})

    def submit_actor_task(self, spec, retry_on_restart: int = 1) -> List:
        return self._call("client_actor_call", {"spec": spec})

    def kill_actor(self, actor_id, no_restart: bool = True):
        return self._call("client_kill_actor",
                          {"actor_id": actor_id, "no_restart": no_restart})

    def get_named_actor(self, name: str, namespace: Optional[str] = None):
        return self._call("client_named_actor",
                          {"name": name,
                           "namespace": namespace or self.namespace})

    def cancel(self, oid, force: bool = False):
        return self._call("client_cancel",
                          {"object_id": oid, "force": force})

    # --------------------------------------------------------- ref counting

    def register_ref(self, oid):
        with self._lock:
            self._ref_counts[oid.binary()] = \
                self._ref_counts.get(oid.binary(), 0) + 1

    def deregister_ref(self, oid):
        if self._closed:
            return
        with self._lock:
            n = self._ref_counts.get(oid.binary(), 0) - 1
            if n > 0:
                self._ref_counts[oid.binary()] = n
                return
            self._ref_counts.pop(oid.binary(), None)
        try:
            self._call("client_drop_ref", {"object_ids": [oid]})
        except Exception:  # noqa: BLE001 — disconnect cleanup covers it
            pass

    def shutdown(self):
        self._closed = True
        self._client.close()
