"""Replica actor: hosts one copy of a deployment's user callable.

Equivalent of the reference's `RayServeReplica`
(`serve/_private/replica.py:285`, `handle_request` :508) — an async actor
whose asyncio loop gives request-level concurrency (the reference uses the
same design), tracks ongoing/processed counts for the controller's
autoscaler, and answers health checks. Inference runs on the replica's
card: the replica actor is scheduled with the deployment's
``ray_actor_options`` (e.g. ``num_gpus=1``) so the raylet sets its
``CUDA_VISIBLE_DEVICES`` before the process initializes CUDA.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import json
import time
from typing import Any, Dict, List, Tuple

from ray_tpu_torch.observability import tracing as _tracing
from ray_tpu_torch.serve import dataplane


class Replica:
    """Generic wrapper actor; instantiated via ActorClass options with
    max_concurrency > max_concurrent_queries so control-plane calls
    (stats/ping/prepare_shutdown) never starve behind user requests."""

    def __init__(self, deployment_name: str, user_cls, init_args,
                 init_kwargs, replica_id: str = "", shard_ctx=None):
        self._deployment = deployment_name
        self._replica_id = replica_id
        # Sharded replica groups: activate this rank's shard context
        # BEFORE user code runs — the gang's torch.distributed group forms
        # before the deployment ctor's first collective. The deployment
        # reads its mesh via `shardgroup.current_mesh()`.
        self._shard_ctx = None
        if shard_ctx is not None:
            from ray_tpu_torch import shardgroup

            self._shard_ctx = shardgroup.activate(shard_ctx)
        self._user = user_cls(*init_args, **(init_kwargs or {}))
        self._asgi_app = self._resolve_asgi_app(user_cls)
        self._ongoing = 0
        self._processed = 0
        self._errored = 0
        self._started_at = time.time()
        self._draining = False
        # Fast-lane method resolution cache: name -> (bound method,
        # needs_await). The user class is fixed for the replica's
        # lifetime, so iscoroutinefunction/batched checks run once per
        # method instead of per request.
        self._raw_methods: Dict[str, tuple] = {}
        # Streamed responses in flight: id -> [queue, pump_task, last_use]
        # (events: ("chunk", item) | ("end", None) | ("error", str)).
        # Reaped after STREAM_IDLE_S without a pull — an HTTP client that
        # disconnects mid-stream would otherwise leak the queue and a
        # pump coroutine forever.
        self._streams: Dict[str, list] = {}
        self._stream_seq = 0

    STREAM_IDLE_S = 120.0

    def _resolve_asgi_app(self, user_cls):
        """serve.ingress attachment: the ASGI callable itself, a zero-arg
        factory (apps that don't pickle), or a one-arg factory receiving
        the deployment instance (routes that need deployment state)."""
        app = getattr(user_cls, "__serve_asgi_app__", None)
        if app is None:
            return None
        params = []
        try:
            params = [p for p in inspect.signature(app).parameters.values()
                      if p.default is p.empty
                      and p.kind in (p.POSITIONAL_ONLY,
                                     p.POSITIONAL_OR_KEYWORD)]
        except (TypeError, ValueError):
            pass
        if len(params) >= 2:
            return app       # ASGI callable: (scope, receive, send)
        if len(params) == 1:
            return app(self._user)
        return app()

    async def handle_request(self, method_name: str, args, kwargs) -> Any:
        if self._draining:
            raise RuntimeError(
                f"replica of {self._deployment} is draining")
        # Replica-side span: the trace context arrived over the light
        # lane's RPC framing or the heavy path's task spec.
        span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            span = _tracing.get_tracer().start_span(
                "serve.replica", attrs={"deployment": self._deployment,
                                        "method": method_name,
                                        "replica": self._replica_id})
        with span:
            return await self._handle_request_inner(method_name, args,
                                                    kwargs)

    async def _handle_request_inner(self, method_name: str, args,
                                    kwargs) -> Any:
        self._ongoing += 1
        try:
            method = getattr(self._user, method_name)
            if inspect.iscoroutinefunction(method) or (
                    getattr(method, "__serve_is_batched__", False)):
                out = await method(*args, **(kwargs or {}))
            else:
                # Sync user callables must not block the replica's event
                # loop — request concurrency (and honest queue-depth stats
                # for the autoscaler) depends on it.
                import functools

                out = await asyncio.get_running_loop().run_in_executor(
                    None, functools.partial(method, *args,
                                            **(kwargs or {})))
                if inspect.iscoroutine(out):
                    out = await out
            if inspect.isgenerator(out) or inspect.isasyncgen(out):
                # Streamed result: pump items through a queue the caller
                # drains with stream_next (reference streaming generators,
                # `handle.options(stream=True)`).
                return {"__serve_stream__": self._pump_generator(out)}
            self._processed += 1
            return out
        except Exception:
            self._errored += 1
            raise
        finally:
            self._ongoing -= 1

    def _pump_generator(self, gen) -> str:
        queue: asyncio.Queue = asyncio.Queue(maxsize=256)
        loop = asyncio.get_running_loop()

        async def pump():
            try:
                if inspect.isasyncgen(gen):
                    async for item in gen:
                        await queue.put(("chunk", item))
                else:
                    sentinel = object()
                    while True:
                        item = await loop.run_in_executor(
                            None, next, gen, sentinel)
                        if item is sentinel:
                            break
                        await queue.put(("chunk", item))
                await queue.put(("end", None))
            except Exception as e:  # noqa: BLE001 — delivered to consumer
                await queue.put(("error", f"{type(e).__name__}: {e}"))

        task = asyncio.ensure_future(pump())
        return self._register_stream(queue, task)

    # ------------------------------------------------------------- HTTP

    async def handle_http(self, request: Dict[str, Any]) -> Any:
        """One HTTP request, translated by the proxy to a plain dict
        (method/path/query_string/headers/body). ASGI deployments
        (serve.ingress) get a full ASGI scope; plain deployments get the
        decoded JSON payload, preserving the simple wire format."""
        if self._asgi_app is not None:
            span = _tracing.NOOP_SPAN
            if _tracing._ENABLED:
                span = _tracing.get_tracer().start_span(
                    "serve.replica", attrs={"deployment": self._deployment,
                                            "method": "asgi",
                                            "replica": self._replica_id})
            with span:
                return await self._handle_asgi(request)
        payload = self._decode_http_payload(
            request.get("body") or b"",
            request.get("query_string") or b"")
        return await self.handle_request("__call__", (payload,), {})

    @staticmethod
    def _decode_http_payload(body: bytes, query_string: bytes):
        """HTTP body -> deployment payload, shared by the classic and
        raw lanes so their decode semantics cannot drift: JSON body if
        it parses, raw text otherwise, query-string dict (or None) for
        body-less requests."""
        if body:
            try:
                return json.loads(body)
            except json.JSONDecodeError:
                return body.decode("utf-8", "replace")
        from urllib.parse import parse_qsl

        qs = dict(parse_qsl(bytes(query_string).decode("latin-1")))
        return qs or None

    async def _handle_asgi(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Run the ASGI app; buffered responses return whole, streamed
        ones (more_body chunks) hand back a stream id the proxy drains
        via stream_next (reference `http_proxy.py:355` pipes ASGI sends
        straight to the socket; here they cross an actor boundary)."""
        self._ongoing += 1
        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request["method"],
            "scheme": "http",
            "path": request["path"],
            "raw_path": request["path"].encode("latin-1"),
            "query_string": request.get("query_string") or b"",
            "root_path": request.get("root_path") or "",
            "headers": [(k, v) for k, v in request.get("headers") or []],
            "client": tuple(request.get("client") or ("127.0.0.1", 0)),
            "server": ("127.0.0.1", 0),
        }
        body = request.get("body") or b""
        # Bounded: an abandoned stream must not buffer the app's whole
        # remaining body; the app's send() backpressures instead and the
        # idle reaper cancels the pump.
        queue: asyncio.Queue = asyncio.Queue(maxsize=256)
        state = {"status": 200, "headers": [], "started": False}

        body_sent = {"done": False}

        async def receive():
            if not body_sent["done"]:
                body_sent["done"] = True
                return {"type": "http.request", "body": body,
                        "more_body": False}
            return {"type": "http.disconnect"}

        async def send(event):
            if event["type"] == "http.response.start":
                state["status"] = event["status"]
                state["headers"] = [
                    (bytes(k).decode("latin-1"), bytes(v).decode("latin-1"))
                    for k, v in event.get("headers") or []]
                state["started"] = True
            elif event["type"] == "http.response.body":
                chunk = event.get("body") or b""
                if chunk:
                    await queue.put(("chunk", chunk))
                if not event.get("more_body"):
                    await queue.put(("end", None))

        async def run_app():
            try:
                await self._asgi_app(scope, receive, send)
                await queue.put(("end", None))
            except Exception as e:  # noqa: BLE001 — app error -> 500
                await queue.put(("error", f"{type(e).__name__}: {e}"))
            finally:
                self._ongoing -= 1
                self._processed += 1

        task = asyncio.ensure_future(run_app())
        # Drain eagerly: if the app finishes (or errors) before streaming
        # past one chunk, answer in one shot; otherwise register a stream.
        chunks = []
        while True:
            kind, item = await queue.get()
            if kind == "chunk":
                chunks.append(item)
                if not task.done():
                    # App still producing: stream the rest.
                    sid = self._register_stream(queue, task)
                    return {"__serve_http__": True, "status": state["status"],
                            "headers": state["headers"],
                            "body": b"".join(chunks), "stream": sid}
            elif kind == "end":
                return {"__serve_http__": True, "status": state["status"],
                        "headers": state["headers"],
                        "body": b"".join(chunks)}
            else:  # error
                self._errored += 1
                return {"__serve_http__": True, "status": 500,
                        "headers": [("content-type", "text/plain")],
                        "body": item.encode()}

    # ------------------------------------------------------ raw fast lane

    async def __serve_raw_dispatch__(self, frame: memoryview) -> list:
        """Serve fast-lane entry point (the worker's `serve_raw` raw
        handler): decode one coalesced request frame, answer every
        request, encode one reply frame. Bodies are raw bytes end to end
        — request payloads and response bodies never touch pickle, and a
        frame of N requests costs one replica wakeup (sync callables
        additionally share a single executor hop)."""
        meta, region = dataplane.decode_frame(frame)
        reqs = meta.get("reqs") or []
        bodies = dataplane.slice_bodies(region,
                                        [r.get("n", 0) for r in reqs])
        dataplane.COUNTERS["raw_dispatch_frames"] += 1
        dataplane.COUNTERS["raw_dispatch_requests"] += len(reqs)
        span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            span = _tracing.get_tracer().start_span(
                "serve.replica", attrs={"deployment": self._deployment,
                                        "replica": self._replica_id,
                                        "raw": True,
                                        "frame_size": len(reqs)})
        with span:
            results = await self._raw_dispatch_all(reqs, bodies)
        entries: List[Dict[str, Any]] = []
        out_bodies: List[Any] = []
        for entry, body in results:
            entry["n"] = len(body)
            entries.append(entry)
            if entry["n"]:
                out_bodies.append(body)
        return dataplane.encode_frame({"v": 1, "resps": entries},
                                      out_bodies)

    async def _raw_dispatch_all(self, reqs, bodies
                                ) -> List[Tuple[Dict[str, Any], bytes]]:
        if self._draining:
            # Provably not executed: the proxy may safely re-route these
            # to another replica (retriable).
            return [({"err": f"replica of {self._deployment} is draining",
                      "code": 503, "retriable": True}, b"")
                    for _ in reqs]
        n = len(reqs)
        results: List[Any] = [None] * n
        sync_jobs: List[Tuple[int, Any]] = []   # (idx, zero-arg callable)
        coro_jobs: List[Tuple[int, Any]] = []   # (idx, coroutine)
        # ASGI requests account their own ongoing/processed counts inside
        # _handle_asgi — counting them here too would double the load the
        # autoscaler sees. ("call"-kind requests on an ASGI deployment
        # still count here: they bypass the ASGI app.)
        def _self_counting(req):
            return self._asgi_app is not None and req.get("k") == "http"

        n_own = sum(1 for r in reqs if not _self_counting(r))
        self._ongoing += n_own
        try:
            for i, (req, body) in enumerate(zip(reqs, bodies)):
                try:
                    kind, job = self._raw_prepare(req, body)
                except Exception as e:  # noqa: BLE001 — per-request error
                    results[i] = e
                    continue
                if kind == "sync":
                    sync_jobs.append((i, job))
                else:
                    coro_jobs.append((i, job))
            if sync_jobs:
                # ONE executor hop for the whole frame's sync callables:
                # per-request hops were a measurable tax at proxy rates.
                def run_sync():
                    out = []
                    for i, job in sync_jobs:
                        try:
                            out.append((i, job(), None))
                        except Exception as e:  # noqa: BLE001 — per-request
                            out.append((i, None, e))
                    return out

                loop = asyncio.get_running_loop()
                for i, value, err in await loop.run_in_executor(None,
                                                                run_sync):
                    results[i] = err if err is not None else (value,)
            if coro_jobs:
                gathered = await asyncio.gather(
                    *(job for _, job in coro_jobs), return_exceptions=True)
                for (i, _), value in zip(coro_jobs, gathered):
                    results[i] = value if isinstance(value, BaseException) \
                        else (value,)
            out: List[Tuple[Dict[str, Any], bytes]] = []
            for i, req in enumerate(reqs):
                r = results[i]
                if isinstance(r, BaseException):
                    self._errored += 1
                    out.append(({"err": f"{type(r).__name__}: {r}",
                                 "code": 500}, b""))
                    continue
                value = r[0]
                if inspect.iscoroutine(value):
                    # A sync callable returned a coroutine: await on loop.
                    try:
                        value = await value
                    except Exception as e:  # noqa: BLE001 — per-request
                        self._errored += 1
                        out.append(({"err": f"{type(e).__name__}: {e}",
                                     "code": 500}, b""))
                        continue
                if inspect.isgenerator(value) or inspect.isasyncgen(value):
                    value = {"__serve_stream__": self._pump_generator(value)}
                if not _self_counting(req):
                    self._processed += 1
                out.append(self._encode_raw_result(req, value))
            return out
        finally:
            self._ongoing -= n_own

    def _resolve_raw_method(self, name: str) -> tuple:
        cached = self._raw_methods.get(name)
        if cached is None:
            method = getattr(self._user, name, None)
            if method is None:
                raise AttributeError(
                    f"deployment {self._deployment!r} has no method "
                    f"{name!r}")
            needs_await = inspect.iscoroutinefunction(method) or bool(
                getattr(method, "__serve_is_batched__", False))
            # Keys are the user class's method names (getattr above
            # rejects anything else): bounded by the deployment's code.
            # raylint: disable=RL011 — bounded by user-class methods
            cached = self._raw_methods[name] = (method, needs_await)
        return cached

    def _raw_prepare(self, req: Dict[str, Any], body: memoryview):
        """One request entry -> ("sync", zero-arg callable) or ("coro",
        coroutine). Raising here is a per-request error."""
        kind = req.get("k")
        if kind == "http":
            if self._asgi_app is not None:
                return "coro", self._handle_asgi(self._raw_http_req(req,
                                                                    body))
            method, needs_await = self._resolve_raw_method("__call__")
            if needs_await:
                decode = functools.partial(self._raw_http_payload, req,
                                           bytes(body))

                async def run():
                    return await method(decode())
                return "coro", run()
            # Payload decode (json) rides the sync job into the shared
            # executor hop — the loop never touches request bodies.
            return "sync", functools.partial(
                self._call_sync_http, method, req, bytes(body))
        if kind == "call":
            method, needs_await = self._resolve_raw_method(
                req.get("m") or "__call__")
            payload = self._raw_call_payload(bytes(body))
            if needs_await:
                async def run_call():
                    return await method(payload)
                return "coro", run_call()
            return "sync", functools.partial(method, payload)
        raise ValueError(f"unknown fast-lane request kind {kind!r}")

    def _call_sync_http(self, method, req, body: bytes):
        return method(self._raw_http_payload(req, body))

    @staticmethod
    def _raw_http_req(req: Dict[str, Any], body) -> Dict[str, Any]:
        return {
            "method": req.get("m") or "GET",
            "path": req.get("p") or "/",
            "root_path": req.get("rp") or "",
            "query_string": req.get("q") or b"",
            "client": (req.get("c") or "127.0.0.1", 0),
            # ASGI scope headers are (bytes, bytes) pairs — the frame
            # meta carries them as str (msgpack), encode like the classic
            # lane does.
            "headers": [
                (k.encode("latin-1") if isinstance(k, str) else bytes(k),
                 v.encode("latin-1") if isinstance(v, str) else bytes(v))
                for k, v in req.get("h") or []],
            "body": bytes(body),
        }

    def _raw_http_payload(self, req: Dict[str, Any], body: bytes):
        return self._decode_http_payload(body, req.get("q") or b"")

    @staticmethod
    def _raw_call_payload(body: bytes):
        """gRPC-parity payload: msgpack-decodable bodies are decoded to a
        Python value, opaque bytes pass through untouched."""
        import msgpack

        try:
            return msgpack.unpackb(body, raw=False, strict_map_key=False)
        except Exception:  # noqa: BLE001 — opaque bytes pass through
            return body

    def _encode_raw_result(self, req: Dict[str, Any], result
                           ) -> Tuple[Dict[str, Any], bytes]:
        if req.get("k") == "call":
            import msgpack

            if isinstance(result, dict) and (
                    result.get("__serve_stream__")
                    or result.get("__serve_http__")):
                sid = (result.get("__serve_stream__")
                       or result.get("stream"))
                return {"stream": sid or "", "err":
                        "streaming/ASGI deployments are not servable over "
                        "the unary gRPC ingress — use the HTTP proxy",
                        "code": 501}, b""
            if isinstance(result, (bytes, bytearray, memoryview)):
                return {"enc": "bin"}, bytes(result)
            try:
                return {"enc": "msgpack"}, msgpack.packb(result,
                                                         use_bin_type=True)
            except Exception as e:  # noqa: BLE001 — per-request error
                return {"err": f"result of type {type(result).__name__} is "
                        f"not msgpack-serializable: {e}", "code": 500}, b""
        # HTTP result -> final response: status + headers + body bytes so
        # the proxy writes them through without touching the payload.
        if isinstance(result, dict) and result.get("__serve_http__"):
            entry = {"status": result.get("status", 200),
                     "hdr": list(result.get("headers") or []), "a": 1}
            sid = result.get("stream")
            if sid:
                entry["stream"] = sid
            return entry, bytes(result.get("body") or b"")
        if isinstance(result, dict) and result.get("__serve_stream__"):
            return {"status": 200, "stream": result["__serve_stream__"],
                    "ct": "application/octet-stream"}, b""
        if isinstance(result, (bytes, bytearray, memoryview)):
            return {"status": 200,
                    "ct": "application/octet-stream"}, bytes(result)
        if isinstance(result, str):
            return {"status": 200, "ct": "text/plain; charset=utf-8"}, \
                result.encode()
        if isinstance(result, (dict, list, int, float, bool)) \
                or result is None:
            return {"status": 200, "ct": "application/json"}, \
                json.dumps({"result": result}).encode()
        return {"status": 200, "ct": "text/plain; charset=utf-8"}, \
            str(result).encode()

    async def __serve_stream_raw__(self, frame: memoryview) -> list:
        """Raw stream pull (the worker's `serve_stream` handler): drain
        the next batch of a registered stream as length-prefixed chunk
        bytes — the PR-3 token stream rides this as just another
        consumer. `cancel` frames release the pump immediately."""
        meta, _ = dataplane.decode_frame(frame)
        sid = meta.get("sid") or ""
        if meta.get("cancel"):
            await self.stream_cancel(sid)
            return dataplane.encode_frame({"done": True, "lens": []}, [])
        batch = await self.stream_next(sid,
                                       max_items=meta.get("max") or 64,
                                       timeout_s=meta.get("timeout") or 30.0)
        chunks = [self._encode_stream_item(it)
                  for it in batch.get("items") or []]
        out = {"done": bool(batch.get("done")),
               "lens": [len(c) for c in chunks]}
        if batch.get("error"):
            out["err"] = batch["error"]
        return dataplane.encode_frame(out, chunks)

    @staticmethod
    def _encode_stream_item(item) -> bytes:
        if isinstance(item, (bytes, bytearray, memoryview)):
            return bytes(item)
        if isinstance(item, str):
            return item.encode()
        return (json.dumps(item) + "\n").encode()

    def _register_stream(self, queue: asyncio.Queue, task) -> str:
        self._reap_idle_streams()
        self._stream_seq += 1
        sid = f"{self._replica_id}:{self._stream_seq}"
        self._streams[sid] = [queue, task, time.monotonic()]
        return sid

    def _reap_idle_streams(self):
        now = time.monotonic()
        for sid, (queue, task, last) in list(self._streams.items()):
            if now - last > self.STREAM_IDLE_S:
                self._streams.pop(sid, None)
                if task is not None and not task.done():
                    task.cancel()

    async def stream_cancel(self, sid: str) -> bool:
        """Abandon a registered stream: cancel its pump task and drop the
        queue now instead of letting them idle until the reaper (a caller
        that cannot consume the stream — e.g. the unary gRPC ingress —
        must not strand a full queue + running generator per request)."""
        rec = self._streams.pop(sid, None)
        if rec is None:
            return False
        task = rec[1]
        if task is not None and not task.done():
            task.cancel()
        return True

    async def stream_next(self, sid: str, max_items: int = 64,
                          timeout_s: float = 30.0) -> Dict[str, Any]:
        """Pull the next batch of items from a registered stream."""
        self._reap_idle_streams()
        rec = self._streams.get(sid)
        if rec is None:
            return {"items": [], "done": True,
                    "error": "unknown stream (expired or replica restart)"}
        queue = rec[0]
        rec[2] = time.monotonic()
        items, done, error = [], False, None
        try:
            kind, item = await asyncio.wait_for(queue.get(), timeout_s)
        except asyncio.TimeoutError:
            return {"items": [], "done": False}
        while True:
            if kind == "chunk":
                items.append(item)
            elif kind == "end":
                done = True
            else:
                done, error = True, item
            if done or len(items) >= max_items or queue.empty():
                break
            kind, item = queue.get_nowait()
        if done:
            self._streams.pop(sid, None)
        else:
            rec[2] = time.monotonic()
        return {"items": items, "done": done, "error": error}

    @staticmethod
    def _node_hex() -> str:
        """This replica's node id (for the controller's locality table);
        empty when instantiated outside a cluster (unit tests)."""
        import ray_tpu_torch

        rt = ray_tpu_torch._global_runtime
        if rt is None or rt.node_id is None:
            return ""
        return rt.node_id.hex()

    def stats(self) -> Dict[str, Any]:
        out = {
            "deployment": self._deployment,
            "ongoing": self._ongoing,
            "processed": self._processed,
            "errored": self._errored,
            "uptime_s": time.time() - self._started_at,
            "node": self._node_hex(),
            "fastpath": {
                "frames": dataplane.COUNTERS["raw_dispatch_frames"],
                "requests": dataplane.COUNTERS["raw_dispatch_requests"],
            },
        }
        if self._shard_ctx is not None:
            out["shard"] = self._shard_ctx.as_dict()
        # User-exported metrics (e.g. the inference engine's queue depth
        # and tokens/s): the controller folds `queue_depth` into its
        # autoscaling signal so backlog inside the deployment counts as
        # pressure, not just in-flight RPCs.
        hook = getattr(self._user, "__serve_metrics__", None)
        if hook is not None:
            try:
                out["user"] = dict(hook())
            except Exception:  # noqa: BLE001 — stats must never fail
                pass
        return out

    def ping(self) -> Dict[str, Any]:
        # The controller health-checks periodically: piggyback the idle
        # stream sweep so abandoned streams are reaped even when no new
        # streaming request ever reaches this replica. The node id rides
        # along so the controller can publish replica placement in the
        # routing table (locality-aware direct routing) without an extra
        # round trip.
        self._reap_idle_streams()
        return {"ok": True, "node": self._node_hex()}

    async def prepare_shutdown(self, timeout_s: float = 5.0) -> int:
        """Graceful drain: refuse new requests, wait for ongoing ones,
        then tear down user-side resources — every `@serve.batch` queue
        (its flusher task and parked futures would otherwise leak) and
        the optional `__serve_shutdown__` hook (e.g. the inference
        engine's scheduler thread)."""
        self._draining = True
        deadline = time.time() + timeout_s
        # Streamed responses decrement _ongoing as soon as the stream id
        # is returned — wait on the registered streams too, or a graceful
        # drain would kill the engine mid-generation for clients that are
        # still pulling tokens.
        while (self._ongoing > 0 or self._streams) \
                and time.time() < deadline:
            await asyncio.sleep(0.02)
        from ray_tpu_torch.serve.batching import _BatchQueue

        for value in list(getattr(self._user, "__dict__", {}).values()):
            if isinstance(value, _BatchQueue):
                try:
                    value.stop()
                except Exception:  # noqa: BLE001 — teardown is best effort
                    pass
        hook = getattr(self._user, "__serve_shutdown__", None)
        if hook is not None:
            try:
                out = hook()
                if inspect.iscoroutine(out):
                    await out
            except Exception:  # noqa: BLE001
                pass
        return self._ongoing

    def reconfigure(self, user_config: Any) -> None:
        hook = getattr(self._user, "reconfigure", None)
        if hook is not None:
            hook(user_config)


def make_function_wrapper(fn):
    """Adapt a bare function deployment into a callable class."""

    class _FunctionDeployment:
        def __init__(self, *args, **kwargs):
            self._args = args
            self._kwargs = kwargs

        def __call__(self, request):
            return fn(request, *self._args, **self._kwargs)

    _FunctionDeployment.__name__ = getattr(fn, "__name__", "function")
    return _FunctionDeployment
