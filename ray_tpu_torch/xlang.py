"""Cross-language gateway: msgpack-speaking entry point for non-Python
clients (the C++ user API in `cpp/`).

Equivalent surface to the reference's cross-language support (C++/Java
user APIs binding the same core — `cpp/include/ray/api.h`,
`java/runtime/.../RayNativeRuntime.java`) re-designed for this runtime's
shape: instead of embedding a native CoreWorker in every foreign-language
process, a Python-side gateway exposes the public API over raw-msgpack
RPC methods (`RpcServer.register_raw`), and foreign clients stay thin —
a socket, the 12-byte frame header, and a msgpack codec. Cross-language
VALUES are msgpack-encoded (the reference uses msgpack for its XLANG
serialization format too, `python/ray/_private/serialization.py`), which
bounds them to plain data: numbers, strings, binary, lists, maps.

Wire protocol (shared with `ray_tpu_torch/core/rpc.py` framing):

    [4B LE total][4B LE envlen][msgpack env {i,k,m}][msgpack payload]

Methods (payload -> response payload, all msgpack maps):
    xlang_ping      {}                                  -> {ok: true}
    xlang_kv_put    {ns, key(bin), value(bin)}          -> {ok}
    xlang_kv_get    {ns, key(bin)}                      -> {value(bin)|nil}
    xlang_put       {value}                             -> {id(hex str)}
    xlang_get       {id, timeout?}                      -> {value}
    xlang_free      {id}                                -> {freed(bool)}
    xlang_call      {fn "module:attr", args, kwargs,
                     mode: "sync"|"submit", timeout?}   -> {value}|{id}
    xlang_actor_call{name, namespace?, method, args,
                     kwargs, timeout?}                  -> {value}

Errors come back as the RPC envelope's `e` field (ValueError on the
client). Python sees cross-language objects as the decoded msgpack value
(a dict/list/str/int/bytes), so `ray_tpu_torch.get` on an id a C++ client put
just works, and vice versa for plain-data Python objects.
"""

from __future__ import annotations

import importlib
import logging
import threading
from typing import Any, Dict, Optional

import msgpack

logger = logging.getLogger(__name__)

GATEWAY_KV_NS = "xlang"
GATEWAY_KV_KEY = b"gateway_address"

_lock = threading.Lock()
_server = None


def _pack(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _unpack(payload: bytes) -> Any:
    return msgpack.unpackb(payload, raw=False, strict_map_key=False)


def _check_xlang_value(value: Any):
    """Raise if a value cannot cross the language boundary (msgpack-able
    plain data only — mirrors the reference's XLANG format limits)."""
    try:
        return _pack(value)
    except Exception as e:
        raise TypeError(
            f"value of type {type(value).__name__} is not cross-language "
            f"serializable (msgpack plain data only): {e}") from None


def _value_response(value: Any) -> bytes:
    """Encode {"value": value} reusing the validation pack — a large
    result is serialized once, not once to check and again to respond.
    Layout: fixmap(1) + fixstr(5) "value" + <packed value>."""
    return b"\x81\xa5value" + _check_xlang_value(value)


class XlangGateway:
    """Raw-msgpack handlers bound to a driver runtime."""

    def __init__(self, runtime):
        self._runtime = runtime
        # Objects whose ids crossed the language boundary: a foreign
        # client holds ids, not ObjectRefs, so nothing on the Python side
        # would keep the objects alive — the gateway pins them until the
        # client frees them (xlang_free) or the gateway stops. Without
        # this, a submit-mode task result is refcount-freed the moment
        # the handler returns and the client's later xlang_get polls a
        # dead object forever.
        self._held: Dict[str, Any] = {}
        self._held_lock = threading.Lock()

    def _hold(self, ref):
        with self._held_lock:
            self._held[ref.hex()] = ref

    # Handler helpers -------------------------------------------------

    def _resolve_fn(self, ref: str):
        """'pkg.mod:attr' (or 'pkg.mod.attr') -> callable. Only module
        attributes — cross-language calls are by name, like the reference's
        function descriptors (module + name), never by pickled code."""
        if ":" in ref:
            mod_name, _, attr = ref.partition(":")
        else:
            mod_name, _, attr = ref.rpartition(".")
        if not mod_name:
            raise ValueError(f"function reference {ref!r} must be "
                             "'module:attr' or 'module.attr'")
        fn = importlib.import_module(mod_name)
        for part in attr.split("."):
            fn = getattr(fn, part)
        if not callable(fn):
            raise TypeError(f"{ref!r} resolved to non-callable {type(fn)}")
        return fn

    # Handlers (conn, payload bytes) -> response bytes ----------------

    def ping(self, conn, payload: bytes) -> bytes:
        return _pack({"ok": True})

    def kv_put(self, conn, payload: bytes) -> bytes:
        req = _unpack(payload)
        self._runtime.gcs.call("kv_put", {
            "namespace": req.get("ns") or "xlang-user",
            "key": bytes(req["key"]),
            "value": bytes(req["value"]),
            "overwrite": True,
        })
        return _pack({"ok": True})

    def kv_get(self, conn, payload: bytes) -> bytes:
        req = _unpack(payload)
        resp = self._runtime.gcs.call("kv_get", {
            "namespace": req.get("ns") or "xlang-user",
            "key": bytes(req["key"]),
        })
        return _pack({"value": resp.get("value")})

    def put(self, conn, payload: bytes) -> bytes:
        from ray_tpu_torch.object_ref import ObjectRef

        req = _unpack(payload)
        oid = self._runtime.put(req["value"])
        self._hold(ObjectRef(oid))
        return _pack({"id": oid.hex()})

    def free(self, conn, payload: bytes) -> bytes:
        req = _unpack(payload)
        with self._held_lock:
            dropped = self._held.pop(req["id"], None) is not None
        return _pack({"freed": dropped})

    def get(self, conn, payload: bytes) -> bytes:
        from ray_tpu_torch.core.ids import ObjectID

        req = _unpack(payload)
        oid = ObjectID.from_hex(req["id"])
        value = self._runtime.get([oid], timeout=req.get("timeout"))[0]
        return _value_response(value)

    def call(self, conn, payload: bytes) -> bytes:
        import ray_tpu_torch

        req = _unpack(payload)
        fn = self._resolve_fn(req["fn"])
        remote_fn = ray_tpu_torch.remote(fn)
        ref = remote_fn.remote(*(req.get("args") or []),
                               **(req.get("kwargs") or {}))
        if req.get("mode") == "submit":
            self._hold(ref)
            return _pack({"id": ref.hex()})
        value = self._runtime.get([ref.object_id],
                                  timeout=req.get("timeout", 60))[0]
        return _value_response(value)

    def actor_call(self, conn, payload: bytes) -> bytes:
        import ray_tpu_torch

        req = _unpack(payload)
        handle = ray_tpu_torch.get_actor(req["name"],
                                   namespace=req.get("namespace"))
        method = getattr(handle, req["method"])
        ref = method.remote(*(req.get("args") or []),
                            **(req.get("kwargs") or {}))
        value = self._runtime.get([ref.object_id],
                                  timeout=req.get("timeout", 60))[0]
        return _value_response(value)


def start_gateway(host: str = "127.0.0.1", port: int = 0) -> str:
    """Start (idempotently) the cross-language gateway on this driver and
    publish its address to the GCS KV (`xlang/gateway_address`) so foreign
    clients can be pointed at the cluster. Returns the gateway address."""
    global _server
    import ray_tpu_torch
    from ray_tpu_torch.core.rpc import RpcServer

    runtime = ray_tpu_torch._require_runtime()
    with _lock:
        if _server is not None:
            return _server.address
        gw = XlangGateway(runtime)
        server = RpcServer(host=host, port=port, name="xlang-gateway")
        # Callers are out-of-tree non-Python clients (cpp/): RL014's
        # reference scan cannot see them, so each registration carries
        # the dead-endpoint waiver explicitly.
        server.register_raw(  # raylint: disable=RL014 — cpp client
            "xlang_ping", gw.ping)
        server.register_raw(  # raylint: disable=RL014 — cpp client
            "xlang_kv_put", gw.kv_put)
        server.register_raw(  # raylint: disable=RL014 — cpp client
            "xlang_kv_get", gw.kv_get)
        server.register_raw(  # raylint: disable=RL014 — cpp client
            "xlang_put", gw.put)
        server.register_raw(  # raylint: disable=RL014 — cpp client
            "xlang_free", gw.free)
        server.register_raw(  # raylint: disable=RL014 — cpp client
            "xlang_get", gw.get)
        server.register_raw(  # raylint: disable=RL014 — cpp client
            "xlang_call", gw.call)
        server.register_raw(  # raylint: disable=RL014 — cpp client
            "xlang_actor_call", gw.actor_call)
        server.start()
        _server = server
    try:
        runtime.gcs.call("kv_put", {"namespace": GATEWAY_KV_NS,
                                    "key": GATEWAY_KV_KEY,
                                    "value": server.address.encode(),
                                    "overwrite": True})
    except Exception:  # noqa: BLE001 — discovery is best-effort
        logger.warning("failed to publish xlang gateway address",
                       exc_info=True)
    logger.info("xlang gateway listening on %s", server.address)
    return server.address


def stop_gateway():
    global _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None
