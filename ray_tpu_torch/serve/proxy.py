"""HTTP proxy actor: aiohttp front door routing to deployment replicas.

Equivalent of the reference's `HTTPProxyActor`
(`serve/_private/http_proxy.py:250,463`): an async actor running an
aiohttp server; each request is matched against deployment route prefixes
from the (long-poll refreshed) routing table and dispatched through the
proxy's Router. ``ray_tpu_torch.get`` on the response ref runs in the default
executor so the event loop keeps accepting connections while replicas
work — request-level parallelism is bounded by the router's
max_concurrent_queries admission control, not the proxy.

Wire format: request body is JSON (or raw text) → the deployment callable
receives the decoded payload; dict/list/str/number results come back as
JSON (bytes results stream back raw). Matches what a text-generation
replica needs without dragging in an ASGI framework.

Request path (fast data plane, serve/dataplane.py): bodies ride raw-bytes
frames to the replica's direct RPC server — coalesced per event-loop tick,
no pickle, replies carry final response bytes — with the classic light
(pickled RPC) and heavy (actor task) lanes as fallback. docs/
SERVE_DATAPLANE.md has the wire contract.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from typing import Optional

from ray_tpu_torch.observability import tracing as _tracing
from ray_tpu_torch.serve import dataplane

logger = logging.getLogger(__name__)


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._host = host
        self._port = port
        self._runner = None
        self._router = None
        self._ready_lock = None
        self._route_cache = None  # (table version, [(prefix, name, entry)])

    async def ready(self) -> int:
        """Start the server; returns the bound port. Serialized: two
        concurrent first calls racing the awaits in the body would start
        two servers and leak a Router thread pair."""
        if self._ready_lock is None:  # created pre-await: no interleave yet
            self._ready_lock = asyncio.Lock()
        async with self._ready_lock:
            return await self._ready_locked()

    async def _ready_locked(self) -> int:
        if self._runner is not None:
            return self._port
        from aiohttp import web

        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import (
            CONTROLLER_NAME,
            SERVE_NAMESPACE,
        )
        from ray_tpu_torch.serve.router import Router

        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                             namespace=SERVE_NAMESPACE)
        self._runtime = ray_tpu_torch._global_runtime
        # deployment -> is it ASGI? (unknown = True: send full headers
        # until the first response reveals the shape)
        self._asgi_deployments: dict = {}
        # Nothing below may assign self state until the server is actually
        # listening: a failed start (port in use) must leave the actor
        # retryable, not "ready" with no server — and must not leak a
        # started Router thread pair per attempt.
        router = Router(controller)
        try:
            # First table fetch is blocking — keep it off the event loop.
            await asyncio.get_running_loop().run_in_executor(
                None, router._ensure_started)
            app = web.Application()
            app.router.add_route("*", "/{tail:.*}", self._handle)
            runner = web.AppRunner(app, access_log=None)
            await runner.setup()
            site = web.TCPSite(runner, self._host, self._port)
            await site.start()
        except BaseException:
            router.stop()
            raise
        self._router = router
        self._dispatcher = ReplicaDispatcher(router, self._runtime)
        self._runner = runner
        # Port 0 = ephemeral: recover the real one.
        if self._port == 0:
            self._port = runner.addresses[0][1]
        logger.info("serve proxy listening on %s:%d", self._host, self._port)
        return self._port

    async def _handle(self, request):
        # Root (or traceparent-continued) span for the whole HTTP
        # request: this is where serve traces begin. W3C propagation in:
        # clients set `traceparent`; the context then flows proxy ->
        # router -> replica -> engine over RPC framing and task specs.
        # Disabled tracing skips even the no-op span plumbing — this is
        # the per-request hot path.
        if not _tracing._ENABLED:
            return await self._handle_inner(request)
        span = _tracing.get_tracer().start_span(
            "serve.http",
            child_of=_tracing.parse_traceparent(
                request.headers.get("traceparent")),
            attrs={"method": request.method, "path": request.path})
        with span:
            resp = await self._handle_inner(request)
            span.set_attr("status", getattr(resp, "status", None))
            return resp

    async def _handle_inner(self, request):
        from aiohttp import web

        path = "/" + request.match_info["tail"]
        match = self._match_route(path)
        if match is None:
            return web.json_response(
                {"error": f"no deployment for path {path!r}"}, status=404)
        deployment, entry = match
        prefix = entry.get("route_prefix", "/") or "/"
        body = await request.read() if request.can_read_body else b""
        dispatch_version = self._router._version
        cached = self._asgi_deployments.get(deployment)
        # Full header set only when the deployment might be ASGI — plain
        # JSON deployments never read them, and encoding ~20 tuples per
        # request is measurable at high rps. Learned from the first
        # response's shape, invalidated on routing-table changes (a
        # redeploy can change the type). Names lowercase per the ASGI
        # spec (apps look up b"content-type", not the client's casing).
        want_headers = (cached is None or cached[0] != dispatch_version
                        or cached[1])
        loop = asyncio.get_running_loop()

        # Fast data plane: the request body rides a raw-bytes frame to
        # the replica's direct server (coalesced with its same-tick
        # neighbours) and the replica answers with final response bytes —
        # no pickle of bodies anywhere. None = fall back to the classic
        # pickle lanes (fast path disabled / saturated / transport says
        # the classic lane is safer).
        req_entry = {"k": "http", "m": request.method,
                     "p": self._strip_prefix(path, prefix),
                     "rp": prefix.rstrip("/"),
                     "q": request.query_string.encode("latin-1"),
                     "c": request.remote or "127.0.0.1"}
        if want_headers:
            req_entry["h"] = [(k.lower(), v)
                              for k, v in request.headers.items()]
        # Adapter-affinity routing hint for multiplexed deployments: the
        # model_id query param (the body stays opaque bytes on the fast
        # lane — the replica's engine reads the authoritative copy from
        # the payload). Parsed only when the table marks the deployment
        # multiplexed, so plain deployments never pay the query parse.
        model_id = None
        if entry.get("mux"):
            model_id = request.query.get("model_id") \
                or request.headers.get("x-model-id")
        try:
            out = await self._dispatcher.dispatch_raw_http(
                loop, deployment, req_entry, body, model_id=model_id)
        except dataplane.QuotaExceeded as e:
            # Fast 429 + Retry-After: over-quota traffic is answered at
            # the proxy door, never parked or fair-queued.
            retry_after = max(e.retry_after_s, 0.001)
            return web.json_response(
                {"error": str(e), "retry_after_s": round(retry_after, 3)},
                status=429,
                headers={"Retry-After": f"{retry_after:.3f}"})
        except dataplane.ParkBufferFull as e:
            return web.json_response({"error": str(e)}, status=503)
        except (asyncio.TimeoutError, TimeoutError):
            return web.json_response(
                {"error": "request timed out"}, status=504)
        except ConnectionError as e:
            return web.json_response({"error": str(e)}, status=502)
        except Exception as e:  # noqa: BLE001 — framing/transport bug → 500
            return web.json_response(
                {"error": f"{type(e).__name__}: {e}"}, status=500)
        if out is not None:
            resp_entry, resp_body = out
            return await self._respond_fast(request, deployment, resp_entry,
                                            resp_body, dispatch_version)

        dataplane.COUNTERS["fallback_requests"] += 1
        http_req = {
            "method": request.method,
            # ASGI path is relative to the deployment's mount point
            # (root_path), matching how the reference mounts FastAPI apps
            # under their route_prefix.
            "path": self._strip_prefix(path, prefix),
            "root_path": prefix.rstrip("/"),
            "query_string": request.query_string.encode("latin-1"),
            "client": (request.remote or "127.0.0.1", 0),
            "body": body,
        }
        if want_headers:
            http_req["headers"] = [
                (k.lower().encode("latin-1"), v.encode("latin-1"))
                for k, v in request.headers.items()]
        try:
            result = await self._dispatch(loop, deployment, http_req)
        except asyncio.TimeoutError:
            return web.json_response(
                {"error": "request timed out after 60s"}, status=500)
        except Exception as e:  # noqa: BLE001 — user code error → 500
            return web.json_response(
                {"error": f"{type(e).__name__}: {e}"}, status=500)
        return await self._respond(request, deployment, result,
                                   dispatch_version)

    async def _dispatch(self, loop, deployment: str, http_req: dict):
        return await self._dispatcher.dispatch(loop, deployment,
                                               "__serve_http__", (http_req,))

    @staticmethod
    def _strip_prefix(path: str, prefix: str) -> str:
        if prefix != "/" and path.startswith(prefix.rstrip("/")):
            rest = path[len(prefix.rstrip("/")):]
            return rest or "/"
        return path

    def _match_route(self, path: str) -> Optional[tuple]:
        """Longest-prefix route match against a per-version cache of the
        routing table — the per-request lock + table copy the old _match
        paid was measurable at fast-path rates (entries are immutable
        once published: the router swaps whole tables per version)."""
        version = self._router._version
        cache = self._route_cache
        if cache is None or cache[0] != version:
            with self._router._lock:
                routes = [(entry["route_prefix"], name, entry)
                          for name, entry in self._router._table.items()]
            cache = (version, routes)
            self._route_cache = cache
        best, best_len = None, -1
        for prefix, name, entry in cache[1]:
            if (path == prefix or path.startswith(prefix.rstrip("/") + "/")
                    or (prefix == "/" and path.startswith("/"))):
                if len(prefix) > best_len:
                    best, best_len = (name, entry), len(prefix)
        return best

    def _table_entry(self, deployment: str) -> Optional[dict]:
        with self._router._lock:
            return self._router._table.get(deployment)

    async def _respond_fast(self, request, deployment: str, entry: dict,
                            body, dispatch_version: int):
        """Write a fast-lane response: the replica already produced the
        final body bytes, status and content type — the proxy only frames
        HTTP. Streamed responses relay raw chunk frames."""
        from aiohttp import web
        from multidict import CIMultiDict

        if entry.get("err"):
            # No ASGI-ness cache update from error entries: they carry no
            # 'a' flag, and caching False here would strip headers from
            # every later request to an ASGI deployment.
            return web.json_response({"error": entry["err"]},
                                     status=int(entry.get("code") or 500))
        self._asgi_deployments[deployment] = (dispatch_version,
                                              bool(entry.get("a")))
        status = int(entry.get("status") or 200)
        if entry.get("hdr") is not None:
            # Multidict: repeated headers (Set-Cookie) must all survive.
            headers = CIMultiDict((k, v) for k, v in entry.get("hdr") or [])
        else:
            headers = CIMultiDict(
                {"Content-Type":
                 entry.get("ct") or "application/octet-stream"})
        sid = entry.get("stream")
        if sid is None:
            return web.Response(status=status, headers=headers,
                                body=bytes(body))
        # Streamed tail: chunked framing owns the length.
        headers.popall("Content-Length", None)
        headers.popall("Transfer-Encoding", None)
        resp = web.StreamResponse(status=status, headers=headers)
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        if len(body):
            await resp.write(bytes(body))
        ok = await self._relay_stream_fast(deployment, sid, resp.write)
        if not ok:
            # Truncated (generator error / replica gone): abort the
            # connection so the client can't mistake a partial body for a
            # complete 200.
            if request.transport is not None:
                request.transport.close()
            return resp
        await resp.write_eof()
        return resp

    async def _relay_stream_fast(self, deployment: str, sid: str,
                                 write) -> bool:
        """Drain a replica-side stream as raw chunk frames (the PR-3
        token stream rides this). Returns False on truncation."""
        loop = asyncio.get_running_loop()
        lane = self._dispatcher.fastlane
        try:
            while True:
                out = await lane.stream_pull(loop, deployment, sid)
                if out is None:
                    logger.warning("stream %s: replica unreachable "
                                   "(truncated)", sid)
                    return False
                meta, chunks = out
                for c in chunks:
                    await write(bytes(c))
                if meta.get("err"):
                    logger.warning("stream %s failed: %s", sid, meta["err"])
                    return False
                if meta.get("done"):
                    return True
        except BaseException:
            # Client disconnect (write failed) or handler cancellation:
            # release the replica-side pump/queue NOW instead of letting
            # the generator idle against a full queue until the 120s reap.
            lane.stream_cancel(loop, deployment, sid)
            raise

    async def _respond(self, request, deployment: str, result,
                       dispatch_version: int):
        from aiohttp import web

        # Stamp with the version the request was DISPATCHED under: a
        # redeploy landing mid-flight must not get its type cached from
        # the old replica's response shape.
        self._asgi_deployments[deployment] = (
            dispatch_version,
            isinstance(result, dict) and bool(result.get("__serve_http__")))
        if isinstance(result, dict) and result.get("__serve_http__"):
            from multidict import CIMultiDict

            # Multidict: repeated headers (Set-Cookie) must all survive.
            headers = CIMultiDict(
                (k, v) for k, v in result.get("headers") or [])
            sid = result.get("stream")
            if sid is None:
                return web.Response(status=result["status"], headers=headers,
                                    body=result.get("body") or b"")
            # Streamed ASGI body: first chunk(s) already in hand, relay
            # the rest from the replica's stream queue. Chunked framing
            # owns the length — the app's content-length (e.g. a
            # FileResponse) would make aiohttp reject chunked mode.
            headers.popall("Content-Length", None)
            headers.popall("Transfer-Encoding", None)
            resp = web.StreamResponse(status=result["status"],
                                      headers=headers)
            resp.enable_chunked_encoding()
            await resp.prepare(request)
            await resp.write(result.get("body") or b"")
            ok = await self._relay_stream(deployment, sid, resp.write)
            if not ok:
                # Truncated (generator error / replica gone): abort the
                # connection so the client can't mistake a partial body
                # for a complete 200.
                if request.transport is not None:
                    request.transport.close()
                return resp
            await resp.write_eof()
            return resp
        if isinstance(result, dict) and result.get("__serve_stream__"):
            # Plain deployment returned a generator: stream items as
            # chunked text/bytes.
            resp = web.StreamResponse(status=200)
            resp.enable_chunked_encoding()
            await resp.prepare(request)

            async def write(item):
                if isinstance(item, (bytes, bytearray, memoryview)):
                    await resp.write(bytes(item))
                elif isinstance(item, str):
                    await resp.write(item.encode())
                else:
                    await resp.write((json.dumps(item) + "\n").encode())

            ok = await self._relay_stream(deployment,
                                          result["__serve_stream__"], write)
            if not ok:
                if request.transport is not None:
                    request.transport.close()
                return resp
            await resp.write_eof()
            return resp
        if isinstance(result, (dict, list, int, float, bool)) \
                or result is None:
            return web.json_response({"result": result})
        if isinstance(result, (bytes, bytearray, memoryview)):
            # Lane parity: the fast lane returns bytes results raw; a
            # request that fell back here must not get the str() repr.
            return web.Response(body=bytes(result),
                                content_type="application/octet-stream")
        return web.Response(text=str(result))

    async def _relay_stream(self, deployment: str, sid: str, write) -> bool:
        """Drain a replica-side stream (stream_next pulls) into `write`.
        Returns False on truncation (stream error / replica gone)."""
        handle = self._router.replica_for_stream(deployment, sid)
        if handle is None:
            logger.warning("stream %s: replica left the table", sid)
            return False
        try:
            while True:
                ref = handle.stream_next.remote(sid)
                batch = await asyncio.wrap_future(
                    self._runtime.get_future(ref))
                for item in batch.get("items") or []:
                    await write(item)
                if batch.get("error"):
                    logger.warning("stream %s failed: %s", sid,
                                   batch["error"])
                    return False
                if batch.get("done"):
                    return True
        except BaseException:
            # Client disconnect (write failed) or handler cancellation:
            # release the replica-side pump/queue NOW instead of letting
            # the generator idle against a full queue until the 120s reap.
            try:
                handle.stream_cancel.remote(sid)
            except Exception:  # noqa: BLE001 — reaper is the backstop
                pass
            raise

    def _match(self, path: str) -> Optional[str]:
        match = self._match_route(path)
        return match[0] if match is not None else None

    async def counters(self) -> dict:
        """This proxy process's fast-path counters (the zero-pickle
        acceptance proof reads these)."""
        return dataplane.counters_snapshot()

    async def stop(self):
        if self._router is not None:
            self._router.stop()
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None


class ReplicaDispatcher:
    """Routes one call to a replica of a deployment; shared by the HTTP
    and gRPC proxies so the two ingresses cannot drift. Lanes, fastest
    first: (1) the raw fast lane (`self.fastlane`, serve/dataplane.py)
    — zero-pickle coalesced frames on the replica's direct server; (2)
    the light lane below: admission via router.reserve(), then
    `actor_call_light` — pickled args, result rides the RPC response,
    skipping the actor-task path (TaskSpec + ObjectRef + reply push);
    (3) the full actor-call path, which owns retries and backpressure.
    Any light-lane transport problem (replica restarting, stale
    connection, saturation) falls through to the heavy lane.

    `method` follows the router convention: the "__serve_http__" sentinel
    targets the replica's HTTP entry point; anything else is a user
    method routed through the replica's handle_request."""

    def __init__(self, router, runtime):
        self._router = router
        self._runtime = runtime
        # Raw fast lane: coalesced zero-pickle frames (serve/dataplane.py)
        # shared by the HTTP and gRPC ingresses so they cannot drift.
        self.fastlane = dataplane.FastLane(router, runtime)
        # replica_id -> RpcClient for the light request/response lane
        # (invalidated on any transport error; pruned against the routing
        # table when its version changes).
        self._light_clients: dict = {}
        self._light_version = -2  # != router's initial -1: prune on first use

    async def dispatch_raw_http(self, loop, deployment: str,
                                entry: dict, body, model_id=None):
        """HTTP request over the raw fast lane; None = use the classic
        lanes (the caller owns the fallback and its counter)."""
        return await self.fastlane.dispatch(loop, deployment, entry, body,
                                            model_id=model_id)

    async def dispatch_call(self, loop, deployment: str, body: bytes,
                            model_id=None):
        """Unary call (gRPC ingress parity) over the raw fast lane: the
        request bytes pass through untouched; the replica decodes
        msgpack-decodable bodies and encodes the result symmetrically."""
        return await self.fastlane.dispatch(
            loop, deployment, {"k": "call", "m": "__call__"}, body,
            model_id=model_id)

    @staticmethod
    def _light_call(method: str, args: tuple) -> dict:
        """actor_call_light payload for a router-convention call. The
        light lane invokes the replica wrapper's methods directly:
        handle_http for the HTTP sentinel, handle_request for user
        methods (both async on the replica's actor loop)."""
        from ray_tpu_torch.core import serialization

        if method == "__serve_http__":
            return {"m": "handle_http",
                    "a": serialization.serialize_to_bytes(args)}
        return {"m": "handle_request",
                "a": serialization.serialize_to_bytes((method, args, {}))}

    async def dispatch(self, loop, deployment: str, method: str,
                       args: tuple):
        span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            span = _tracing.get_tracer().start_span(
                "serve.dispatch", attrs={"deployment": deployment})
        with span:
            return await self._dispatch_traced(loop, deployment, method,
                                               args, span)

    async def _dispatch_traced(self, loop, deployment: str, method: str,
                               args: tuple, span):
        from ray_tpu_torch.core import serialization

        version = self._router._version
        if version != self._light_version:
            # Prune clients for replicas that left the table (scale-down /
            # redeploy): without this a long-lived proxy leaks one client
            # per dead replica under autoscaling churn.
            self._light_version = version
            with self._router._lock:
                live = {rid for entry in self._router._table.values()
                        for rid, _ in entry.get("replicas", ())}
            for rid in list(self._light_clients):
                if rid not in live:
                    self._light_clients.pop(rid, None)
        route_span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            route_span = _tracing.get_tracer().start_span(
                "serve.route", attrs={"deployment": deployment})
        with route_span:
            choice = self._router.reserve(deployment)
            route_span.set_attr("replica",
                                choice[0] if choice is not None else None)
        if choice is not None:
            span.set_attr("lane", "light")
            replica_id, handle = choice
            # Slot ownership: exactly one of (this coroutine, the late
            # callback) releases. On timeout the REPLICA IS STILL RUNNING
            # the request, so the slot transfers to the callback and is
            # only freed when the reply (or connection loss) arrives —
            # releasing early would let admission control dispatch on top
            # of an overloaded replica. pop-from-dict decides the owner.
            slot = {"owned": True}
            slot_lock = threading.Lock()

            def _release_once():
                with slot_lock:
                    owned, slot["owned"] = slot["owned"], False
                if owned:
                    self._router.release(replica_id)

            sent = False
            try:
                client = self._light_clients.get(replica_id)
                if client is None:
                    client = await loop.run_in_executor(
                        None, lambda: self._runtime._actor_client(
                            handle._actor_id).client)
                    self._light_clients[replica_id] = client
                fut = loop.create_future()

                def _complete(f, env, payload):
                    if not f.done():
                        f.set_result((env, payload))

                def cb(env, payload):
                    # Reply (or connection loss) arrived: the replica is
                    # done with this request — free the slot regardless of
                    # whether the waiter is still listening (it may have
                    # timed out; a timed-out request keeps its slot until
                    # here precisely because the replica was still busy).
                    try:
                        loop.call_soon_threadsafe(_complete, fut, env,
                                                  bytes(payload or b""))
                    finally:
                        _release_once()

                client.call_async("actor_call_light",
                                  self._light_call(method, args), cb)
                sent = True
                env, payload = await asyncio.wait_for(fut, timeout=60.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                if not sent:
                    _release_once()  # cancelled pre-send: cb never fires
                raise  # otherwise cb releases when the replica finishes
            except Exception:  # noqa: BLE001 — dead/stale connection
                self._light_clients.pop(replica_id, None)
                if sent:
                    # call_async raised after a possible partial send, and
                    # the client delivered (or will deliver) the loss to
                    # cb, which releases the slot. The request MAY have
                    # executed — re-dispatching would double-run
                    # non-idempotent work.
                    raise
                _release_once()  # cb never registered: we still own it
                span.set_attr("lane", "heavy")
                return await self._dispatch_heavy(loop, deployment, method,
                                                  args)
            if env.get("_lost"):
                # Connection died after delivery: ambiguous whether the
                # replica executed the request. Surface the failure —
                # at-most-once, like the heavy actor path — instead of
                # blindly re-executing.
                self._light_clients.pop(replica_id, None)
                raise ConnectionError(
                    f"replica {replica_id} connection lost mid-request")
            if env.get("e"):
                # Pre-execution failure (actor still initializing, direct
                # server up before the instance): provably not executed,
                # safe to fall back to the heavy path, which queues and
                # retries properly.
                self._light_clients.pop(replica_id, None)
                span.set_attr("lane", "heavy")
                return await self._dispatch_heavy(loop, deployment, method,
                                                  args)
            data = serialization.loads(payload)
            if data.get("err") is not None:
                raise serialization.deserialize_exception(data["err"])
            return serialization.deserialize(data["r"])
        span.set_attr("lane", "heavy")
        return await self._dispatch_heavy(loop, deployment, method, args)

    async def _dispatch_heavy(self, loop, deployment: str, method: str,
                              args: tuple):
        """Full actor-call path (blocking admission control on a thread;
        result via the runtime's future registry)."""
        import functools

        ref = self._router.try_assign(deployment, method, args, {})
        if ref is None:
            ref = await loop.run_in_executor(
                None, functools.partial(
                    self._router.assign, deployment, method,
                    args, {}, timeout_s=30.0))
        return await asyncio.wait_for(
            asyncio.wrap_future(self._runtime.get_future(ref)),
            timeout=60.0)
