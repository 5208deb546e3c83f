"""Client server: the cluster-side half of `ray://` connections.

Equivalent of the reference's Ray Client server (`ray/util/client/server/`):
remote Python processes that are NOT cluster nodes (no local raylet, no
shared memory) drive the cluster through this proxy. It owns a CoreRuntime
on the head node and executes put/get/submit/actor calls on each client's
behalf; per-connection ref tracking releases a client's objects when it
disconnects.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.rpc import Connection, RpcServer

logger = logging.getLogger(__name__)

CLIENT_SERVER_KV_KEY = b"client_server_address"


class ClientServer:
    # Server-side slice for blocking get/wait: clients loop over bounded
    # calls, so a never-resolving get can't wedge the connection forever.
    BLOCK_SLICE_S = 30.0

    def __init__(self, gcs_address: str, raylet_address: str,
                 session_suffix: str, node_id, host: str = "127.0.0.1",
                 port: int = 0):
        self._conn_info = (gcs_address, raylet_address, session_suffix,
                           node_id)
        # The runtime (a full driver: job registration, GCS/raylet
        # connections) is built lazily on the first client call — a local
        # cluster that never sees a ray:// client pays nothing.
        self._runtime = None
        self._runtime_lock = threading.Lock()
        self.server = RpcServer(host=host, port=port, name="client-server")
        self.server.register_instance(self)  # handle_client_* -> client_*
        self.server.on_disconnect = self._on_disconnect
        self._lock = threading.Lock()
        # conn id -> set of oid bytes the client holds refs to
        self._client_refs: Dict[int, set] = {}

    @property
    def address(self) -> str:
        return self.server.address

    @property
    def runtime(self):
        with self._runtime_lock:
            if self._runtime is None:
                from ray_tpu_torch.core.runtime import CoreRuntime

                gcs_address, raylet_address, session_suffix, node_id = \
                    self._conn_info
                self._runtime = CoreRuntime(
                    gcs_address=gcs_address, raylet_address=raylet_address,
                    session_suffix=session_suffix, node_id=node_id,
                    is_driver=True, namespace="default")
            return self._runtime

    def start(self) -> "ClientServer":
        self.server.start()
        # Advertise via a throwaway GCS connection (keeps the runtime lazy).
        from ray_tpu_torch.core.rpc import RpcClient

        gcs = RpcClient(self._conn_info[0], name="client-server-advertise")
        try:
            gcs.call("kv_put",
                     {"namespace": "cluster", "key": CLIENT_SERVER_KV_KEY,
                      "value": self.address.encode()})
        finally:
            gcs.close()
        return self

    def stop(self):
        self.server.stop()
        with self._runtime_lock:
            if self._runtime is not None:
                self._runtime.shutdown()

    # ------------------------------------------------------------ handlers
    # Every handler returns {"ok": ...} or {"error": <exception blob>} so
    # clients re-raise the ORIGINAL exception type, not a transport error.

    def _guard(self, fn):
        try:
            return {"ok": fn()}
        except BaseException as e:  # noqa: BLE001
            return {"error": serialization.serialize_exception(e)}

    def _refs_of(self, conn: Connection) -> set:
        with self._lock:
            return self._client_refs.setdefault(id(conn), set())

    def handle_client_hello(self, conn: Connection, data):
        return {"job_id": self.runtime.job_id,
                "namespace": self.runtime.namespace}

    def handle_client_put(self, conn: Connection, data):
        def run():
            value = serialization.deserialize(data["blob"])
            oid = self.runtime.put(value)
            if data.get("register", True):
                # User-held ObjectRef: pinned until the client drops or
                # disconnects. Task-arg promotions skip this (they live
                # with the job, like local-mode promoted args).
                self.runtime.register_ref(oid)
                self._refs_of(conn).add(oid.binary())
            return oid

        return self._guard(run)

    def handle_client_get(self, conn: Connection, data):
        def run():
            timeout = data.get("timeout")
            timeout = self.BLOCK_SLICE_S if timeout is None \
                else min(timeout, self.BLOCK_SLICE_S)
            values = self.runtime.get(data["object_ids"], timeout=timeout)
            return [serialization.serialize_to_bytes(v) for v in values]

        return self._guard(run)

    def handle_client_wait(self, conn: Connection, data):
        def run():
            timeout = data.get("timeout")
            timeout = self.BLOCK_SLICE_S if timeout is None \
                else min(timeout, self.BLOCK_SLICE_S)
            ready, pending = self.runtime.wait(
                data["object_ids"], num_returns=data["num_returns"],
                timeout=timeout)
            return (ready, pending)

        return self._guard(run)

    def handle_client_cancel(self, conn: Connection, data):
        return self._guard(lambda: self.runtime.cancel(
            data["object_id"], force=data.get("force", False)))

    def handle_client_submit(self, conn: Connection, data):
        def run():
            spec = data["spec"]
            oids = self.runtime.submit_task(spec)
            refs = self._refs_of(conn)
            for oid in oids:
                self.runtime.register_ref(oid)
                refs.add(oid.binary())
            return oids

        return self._guard(run)

    def handle_client_create_actor(self, conn: Connection, data):
        return self._guard(lambda: self.runtime.create_actor(data["spec"]))

    def handle_client_actor_call(self, conn: Connection, data):
        def run():
            oids = self.runtime.submit_actor_task(data["spec"])
            refs = self._refs_of(conn)
            for oid in oids:
                self.runtime.register_ref(oid)
                refs.add(oid.binary())
            return oids

        return self._guard(run)

    def handle_client_kill_actor(self, conn: Connection, data):
        return self._guard(lambda: self.runtime.kill_actor(
            data["actor_id"], data.get("no_restart", True)))

    def handle_client_named_actor(self, conn: Connection, data):
        return self._guard(lambda: self.runtime.get_named_actor(
            data["name"], data.get("namespace")))

    def handle_client_drop_ref(self, conn: Connection, data):
        def run():
            from ray_tpu_torch.core.ids import ObjectID

            for oid in data["object_ids"]:
                key = oid.binary() if isinstance(oid, ObjectID) else oid
                refs = self._refs_of(conn)
                if key in refs:
                    refs.discard(key)
                    self.runtime.deregister_ref(
                        oid if isinstance(oid, ObjectID) else ObjectID(oid))
            return True

        return self._guard(run)

    def handle_client_gcs(self, conn: Connection, data):
        """Read-mostly GCS passthrough (nodes, resources, timeline, kv)."""
        return self._guard(lambda: self.runtime.gcs.call(
            data["method"], data.get("data"), timeout=30))

    def _on_disconnect(self, conn: Connection):
        from ray_tpu_torch.core.ids import ObjectID

        with self._lock:
            refs = self._client_refs.pop(id(conn), set())
        for key in refs:
            try:
                self.runtime.deregister_ref(ObjectID(key))
            except Exception:  # noqa: BLE001
                pass
