"""gRPC ingress for Serve deployments.

Equivalent of the reference's gRPC proxy (`serve/_private/proxy.py`
gRPCProxy / `grpc_util.py`): a `grpc.aio` server whose requests route to
deployment replicas through the same ReplicaDispatcher (light lane +
heavy fallback) the HTTP proxy uses.

Protocol: generic RPC handlers, no protoc step. The fully-qualified
method is `/ray_tpu_torch.serve/<DeploymentName>`; request and response bodies
are raw bytes. A msgpack-decodable request is decoded and handed to the
deployment callable as a Python value (and a non-bytes result is
msgpack-encoded back); opaque bytes pass through untouched in both
directions, so any serialization the caller prefers — protobuf included
— rides as bytes. Deployment errors surface as StatusCode.INTERNAL with
the exception text; unknown deployments as NOT_FOUND. Unary only (HTTP
owns streaming responses).

Clients need no stubs either:

    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    call = ch.unary_unary("/ray_tpu_torch.serve/Echo")   # bytes in/out
    out = msgpack.unpackb(call(msgpack.packb({"x": 1})))
"""

from __future__ import annotations

import asyncio
import logging

logger = logging.getLogger(__name__)

SERVICE = "ray_tpu_torch.serve"


class GrpcProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._server = None
        self._router = None
        self._ready_lock = None

    async def ready(self) -> int:
        """Start the gRPC server; returns the bound port."""
        if self._ready_lock is None:  # created pre-await: no interleave yet
            self._ready_lock = asyncio.Lock()
        async with self._ready_lock:
            return await self._ready_locked()

    async def _ready_locked(self) -> int:
        if self._server is not None:
            return self._port
        import grpc

        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import (
            CONTROLLER_NAME,
            SERVE_NAMESPACE,
        )
        from ray_tpu_torch.serve.proxy import ReplicaDispatcher
        from ray_tpu_torch.serve.router import Router

        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                             namespace=SERVE_NAMESPACE)
        self._runtime = ray_tpu_torch._global_runtime
        # Router state is only adopted after the server binds: a failed
        # bind must leave the actor retryable without leaking a started
        # Router thread pair per attempt.
        router = Router(controller)
        await asyncio.get_running_loop().run_in_executor(
            None, router._ensure_started)

        proxy = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, call_details):
                # '/ray_tpu_torch.serve/<Deployment>' -> unary bytes handler.
                parts = call_details.method.lstrip("/").split("/")
                if len(parts) != 2 or parts[0] != SERVICE:
                    return None
                deployment = parts[1]

                async def unary(request: bytes, context):
                    return await proxy._handle(deployment, request, context)

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=None,   # raw bytes both ways
                    response_serializer=None)

        try:
            server = grpc.aio.server()
            server.add_generic_rpc_handlers((_Handler(),))
            bound = server.add_insecure_port(f"{self._host}:{self._port}")
            if bound == 0:
                # grpc reports bind failure as port 0, not an exception —
                # a silently-"ready" proxy on port 0 would strand every
                # caller.
                raise RuntimeError(
                    f"grpc proxy failed to bind {self._host}:{self._port}")
            # Handlers read these; they must exist before serving starts.
            self._router = router
            self._dispatcher = ReplicaDispatcher(router, self._runtime)
            await server.start()
        except BaseException:
            router.stop()
            self._router = None
            raise
        self._port = bound
        self._server = server
        logger.info("serve grpc proxy listening on %s:%d",
                    self._host, self._port)
        return self._port

    async def _handle(self, deployment: str, request: bytes, context):
        import grpc
        import msgpack

        with self._router._lock:
            known = deployment in self._router._table
        if not known:
            # A request fired right after serve.run can beat the proxy
            # router's long-poll refresh. One authoritative controller
            # fetch decides immediately: genuinely-unknown names get
            # NOT_FOUND now (no multi-second stall per typo/retry), while
            # an in-flight deploy waits out the router's own grace
            # (Router.UNKNOWN_GRACE_S) for the local table to catch up.
            import ray_tpu_torch

            loop = asyncio.get_running_loop()
            try:
                _, table = await loop.run_in_executor(
                    None, lambda: ray_tpu_torch.get(
                        self._router._controller.listen_for_change.remote(
                            -1, 0), timeout=10))
                authoritative = deployment in table
            except Exception:  # noqa: BLE001 — controller busy: fall back
                authoritative = True  # to the grace poll below
            if not authoritative:
                await context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"no deployment named {deployment!r}")
            from ray_tpu_torch.serve.router import Router

            deadline = loop.time() + Router.UNKNOWN_GRACE_S
            while True:
                with self._router._lock:
                    if deployment in self._router._table:
                        break
                if loop.time() >= deadline:
                    await context.abort(
                        grpc.StatusCode.NOT_FOUND,
                        f"no deployment named {deployment!r}")
                await asyncio.sleep(0.1)
        loop = asyncio.get_running_loop()
        # Fast data plane first — the SAME dispatch path as the HTTP
        # proxy (ReplicaDispatcher.fastlane), so the two ingresses cannot
        # drift: request bytes ride a raw frame, the replica decodes
        # msgpack/opaque bodies and encodes the reply symmetrically.
        from ray_tpu_torch.serve import dataplane

        try:
            out = await self._dispatcher.dispatch_call(loop, deployment,
                                                       bytes(request))
        except dataplane.QuotaExceeded as e:
            # Tenant over quota: the gRPC spelling of the HTTP 429.
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                f"{e} (retry after {e.retry_after_s:.3f}s)")
        except dataplane.ParkBufferFull as e:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except (asyncio.TimeoutError, TimeoutError):
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                "request timed out")
        except ConnectionError as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        if out is not None:
            entry, body = out
            sid = entry.get("stream")
            if sid:
                # Release the replica-side pump/queue NOW, not at the
                # 120s idle reap.
                self._dispatcher.fastlane.stream_cancel(loop, deployment,
                                                        sid)
            if entry.get("err"):
                code = grpc.StatusCode.UNIMPLEMENTED \
                    if entry.get("code") == 501 else grpc.StatusCode.INTERNAL
                await context.abort(code, entry["err"])
            return bytes(body)
        dataplane.COUNTERS["fallback_requests"] += 1
        try:
            payload = msgpack.unpackb(bytes(request), raw=False,
                                      strict_map_key=False)
        except Exception:  # noqa: BLE001 — opaque bytes pass through
            payload = bytes(request)
        try:
            result = await self._dispatcher.dispatch(
                loop, deployment, "__call__", (payload,))
        except asyncio.TimeoutError:
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                "request timed out after 60s")
        except Exception as e:  # noqa: BLE001 — user code error (a user
            # KeyError included: unknown deployments were pre-checked
            # above, so mapping KeyError to NOT_FOUND here would
            # misclassify application errors)
            await context.abort(grpc.StatusCode.INTERNAL,
                                f"{type(e).__name__}: {e}")
        if isinstance(result, dict) and (
                result.get("__serve_stream__") or result.get("__serve_http__")):
            # Generator/ASGI results need the HTTP proxy's stream pump;
            # leaking the internal sentinel would hand the client a
            # meaningless stream id while the replica's queue idles full.
            sid = (result.get("__serve_stream__")
                   or result.get("stream"))
            if sid:
                # Release the replica-side pump/queue NOW, not at the
                # 120s idle reap — each abandoned call otherwise strands
                # a full queue and a running generator.
                handle = self._router.replica_for_stream(deployment, sid)
                if handle is not None:
                    try:
                        handle.stream_cancel.remote(sid)
                    except Exception:  # noqa: BLE001 — reaper is backstop
                        pass
            await context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "streaming/ASGI deployments are not servable over the "
                "unary gRPC ingress — use the HTTP proxy")
        if isinstance(result, (bytes, bytearray, memoryview)):
            return bytes(result)
        try:
            return msgpack.packb(result, use_bin_type=True)
        except Exception as e:  # noqa: BLE001
            await context.abort(
                grpc.StatusCode.INTERNAL,
                f"result of type {type(result).__name__} is not "
                f"msgpack-serializable: {e}")

    async def counters(self) -> dict:
        """This proxy process's fast-path counters (shared-path test
        support: proves gRPC rides the same raw dispatch as HTTP)."""
        from ray_tpu_torch.serve import dataplane

        return dataplane.counters_snapshot()

    async def stop(self):
        if self._router is not None:
            self._router.stop()
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None
