"""Serve fast data plane: raw-bytes frames, coalescing, direct routing.

The classic serve path pays, per request: pickle framing of args and
result, an executor hop for admission, and one RPC wakeup per request on
the replica. This module is the proxy half of the fast path that removes
all three:

- **Zero-copy frames.** Request/response bodies travel as raw bytes on
  the worker's direct RPC server (``serve_raw``/``serve_stream`` raw
  methods) — no pickle of bodies anywhere on the path. A frame is
  ``[4B LE meta length][msgpack meta][bodies...]``; the msgpack meta
  lists per-request entries, each with its body length ``n``, so bodies
  are sliced out of the received buffer as memoryviews.
- **Connection-level coalescing.** Concurrent requests to the same
  replica that land in the same event-loop tick ride ONE frame (one
  send, one replica wakeup) and their responses come back in one reply
  frame — `@serve.batch` on the replica forms its gang batch from a
  single wakeup instead of N.
- **Locality-aware direct routing.** Replica choice (Router._pick)
  prefers a co-located replica and falls back to power-of-two-choices by
  pushed queue depth; the fast lane dispatches straight to the chosen
  replica's direct server (`serve.direct` span).
- **Retry-once on replica death.** A frame lost to a dead connection (or
  a per-request `retriable` error, e.g. a draining replica) re-routes
  each affected request to a different replica exactly once; a second
  loss surfaces as ConnectionError. Note the documented at-least-once
  caveat: a request lost AFTER delivery may have executed.
- **Scale-to-zero buffering.** Requests for a parked (0-replica)
  deployment wake the controller and wait buffered at the proxy, bounded
  by ``serve_park_max_bytes`` / ``serve_park_timeout_s``, then dispatch
  normally once the cold-started replica lands in the routing table
  (`serve.coldstart` span).

Frame meta schema (request): ``{"v": 1, "reqs": [entry, ...]}`` where an
entry is ``{"k": "http"|"call", "n": body_len, ...}`` (http: ``m`` method,
``p`` path, ``rp`` root_path, ``q`` query string, ``c`` client ip, ``h``
optional header pairs; call: ``m`` method name). Response:
``{"v": 1, "resps": [entry, ...]}`` with per-entry ``n`` plus ``status``/
``ct``/``hdr``/``stream``/``a`` (http) or ``enc`` (call), and ``err`` +
``code`` + ``retriable`` for per-request failures — one bad request never
poisons its coalesced neighbours. A frame-level failure is
``{"v": 1, "err": msg}``. Stream pull: ``{"sid": id, "max": n}`` →
``{"done": bool, "err": msg?, "lens": [..]}`` + chunk bytes.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import msgpack

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.observability import tracing as _tracing
from ray_tpu_torch.tenancy.admission import (
    QuotaExceeded,
    TenantAdmission,
    WfqScheduler,
)

logger = logging.getLogger(__name__)

_HDR = struct.Struct("<I")

# Process-local fast-path accounting: proxies count dispatch outcomes,
# replicas count frame arrivals (replica.py increments the raw_dispatch_*
# keys). The echo acceptance proof reads these: raw_requests == N and
# fallback_requests == 0 means no request body was ever pickled.
COUNTERS: Dict[str, int] = {
    "raw_frames": 0,          # frames sent by this proxy
    "raw_requests": 0,        # requests answered via the fast lane
    "coalesced_requests": 0,  # requests that shared a frame with others
    "fallback_requests": 0,   # requests that left for the pickle lanes
    "retries": 0,             # requests re-routed after a lost replica
    "stream_pulls": 0,        # raw stream chunk frames pulled
    "park_buffered": 0,       # requests buffered for a parked deployment
    "park_rejected": 0,       # requests refused by the park byte cap
    "quota_rejected": 0,      # tenant over-quota 429s (never parked)
    "wfq_queued": 0,          # requests that waited in the fair queue
    "raw_dispatch_frames": 0,    # replica side: frames received
    "raw_dispatch_requests": 0,  # replica side: requests decoded from frames
}


def counters_snapshot() -> Dict[str, int]:
    return dict(COUNTERS)


def counters_reset() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


# ------------------------------------------------------------------ codec


def encode_frame(meta: Dict[str, Any], bodies: List[Any]) -> List[Any]:
    """Frame a meta dict + body buffers as a raw-RPC parts list. Bodies
    pass through as-is (bytes/memoryview) — the RPC layer's vectored send
    puts them on the wire without concatenation."""
    packed = msgpack.packb(meta, use_bin_type=True)
    return [_HDR.pack(len(packed)), packed, *bodies]


def encode_error_frame(exc: BaseException) -> List[Any]:
    return encode_frame({"v": 1, "err": f"{type(exc).__name__}: {exc}"}, [])


def decode_frame(buf) -> Tuple[Dict[str, Any], memoryview]:
    """Split a received frame into (meta, body region view). The body
    region is one contiguous memoryview; slice it with `slice_bodies`
    using the per-entry lengths the meta carries."""
    view = memoryview(buf)
    (mlen,) = _HDR.unpack(view[:4])
    meta = msgpack.unpackb(bytes(view[4:4 + mlen]), raw=False,
                           strict_map_key=False)
    return meta, view[4 + mlen:]


def slice_bodies(region: memoryview, lens: List[int]) -> List[memoryview]:
    out, pos = [], 0
    for n in lens:
        out.append(region[pos:pos + n])
        pos += n
    return out


# -------------------------------------------------------------- fast lane


class FrameLostError(ConnectionError):
    """The connection to the replica died with the frame in flight."""


# Resolved to a fair-queued waiter whose deployment stopped being
# routable ("active") while it waited — deleted, redeployed, or parked.
# The dispatch loop re-runs its state handling (classic-lane fallback /
# cold-start buffering) instead of polling a dead closure to timeout.
_STATE_CHANGED = object()


class PreExecError(Exception):
    """The replica provably never started executing the frame (transport
    refused pre-send, or the server rejected it before dispatch) — safe
    to fall back to the classic lane."""


class ParkBufferFull(RuntimeError):
    """Scale-to-zero buffer cap hit: the proxy is already holding the
    configured byte budget for this parked deployment."""


class _Pending:
    __slots__ = ("entry", "body", "fut", "replica_id")

    def __init__(self, entry, body, fut, replica_id):
        self.entry = entry
        self.body = body
        self.fut = fut
        self.replica_id = replica_id


class _Channel:
    """Per-replica send channel: one direct RPC client + the coalescing
    buffer of requests waiting for the next flush."""

    __slots__ = ("client", "pending", "scheduled")

    def __init__(self):
        self.client = None
        self.pending: List[_Pending] = []
        self.scheduled = False


class FastLane:
    """Raw-frame dispatcher for one proxy process. All public coroutines
    run on the proxy's event loop; RPC completions arrive on client
    reader threads and hop back via call_soon_threadsafe."""

    REQUEST_TIMEOUT_S = 60.0

    def __init__(self, router, runtime):
        self._router = router
        self._runtime = runtime
        # Per-replica send channels mutate without locks: every dispatch,
        # flush and prune runs on the proxy's event loop (RPC completions
        # marshal back via call_soon_threadsafe). RL016-checked.
        self._channels: Dict[str, _Channel] = {}  # raylint: confine=loop
        self._version = -2  # != router's initial -1: prune on first use
        # Scale-to-zero buffer accounting, per deployment: one parked
        # deployment's cold-start backlog must not 503 another's first
        # request.
        self._park_bytes: Dict[str, int] = {}  # raylint: confine=loop
        # Multi-tenant QoS (docs/MULTITENANCY.md): per-tenant token
        # buckets + in-flight caps off the table-pushed QoS, and the
        # weighted fair queue that orders waiters under contention.
        self._admission = TenantAdmission()
        self._wfq = WfqScheduler()

    # ------------------------------------------------------------ dispatch

    async def dispatch(self, loop, deployment: str, entry: Dict[str, Any],
                       body, model_id: Optional[str] = None
                       ) -> Optional[Tuple[Dict[str, Any], memoryview]]:
        """Route one request entry (+ raw body) to a replica over the raw
        frame lane. Returns (response entry, body view) — the entry may
        carry a per-request "err" — or None when the fast lane cannot
        serve it (disabled, unknown deployment, saturated, or a transport
        path that is safer on the classic lane). Raises QuotaExceeded /
        ParkBufferFull / TimeoutError / ConnectionError for terminal
        fast-lane failures."""
        if not GLOBAL_CONFIG.serve_fastpath_enabled:
            return None
        self._prune_channels()
        table_entry = self._router.entry_snapshot(deployment)
        tenant = self._admission.resolve(table_entry)
        # Admission ordering: the quota gate runs FIRST — an over-quota
        # request answers 429 in one dict lookup, never occupying a
        # replica slot, a park buffer, or a fair-queue position.
        try:
            self._admission.admit(tenant)
        except QuotaExceeded:
            COUNTERS["quota_rejected"] += 1
            raise
        try:
            return await self._dispatch_admitted(
                loop, deployment, entry, body, model_id, table_entry)
        finally:
            # In-flight accounting covers queue time + execution: that is
            # what max_inflight bounds.
            self._admission.release(tenant)

    async def _dispatch_admitted(self, loop, deployment: str,
                                 entry: Dict[str, Any], body,
                                 model_id, table_entry
                                 ) -> Optional[Tuple[Dict[str, Any],
                                                     memoryview]]:
        nbytes = len(body) if body is not None else 0
        entry = dict(entry)
        entry["n"] = nbytes
        attempts = 0
        exclude: Optional[set] = None
        deadline = loop.time() + self.REQUEST_TIMEOUT_S
        while True:
            choice = None
            if not self._wfq.has_waiters() \
                    or not self._wfq.has_waiters_for(deployment):
                # With a backlog queued FOR THIS deployment, newcomers
                # must not jump it — contended reservations go through
                # the fair queue's virtual-time order. A backlog on
                # some other deployment's pool is irrelevant: routing
                # an idle deployment's request through the pump would
                # tax every tenant with the pump's backoff latency.
                choice = self._router.reserve_fast(deployment,
                                                   exclude=exclude,
                                                   model_id=model_id)
            if choice is None:
                state = self._router.deployment_state(deployment)
                if state == "unknown":
                    return None  # classic lane owns the KeyError grace
                if state == "parked":
                    await self._await_cold_start(loop, deployment, nbytes)
                    continue
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no replica of {deployment!r} available within "
                        f"{self.REQUEST_TIMEOUT_S}s")
                # Saturated: park in the weighted fair queue. A hot
                # tenant's backlog drains behind its own weight; other
                # tiers interleave by theirs, so saturation by one
                # tenant cannot starve the rest.
                qos = (table_entry or {}).get("qos") or {}
                COUNTERS["wfq_queued"] += 1
                excl = exclude

                def try_reserve():
                    c = self._router.reserve_fast(
                        deployment, exclude=excl, model_id=model_id)
                    if c is not None:
                        return c
                    if self._router.deployment_state(deployment) \
                            != "active":
                        # Deleted or parked mid-wait: leave the queue
                        # NOW — the dispatch loop owns state handling.
                        return _STATE_CHANGED
                    return None

                def drop_grant(c):
                    # A granted choice the waiter can't consume carries
                    # a reserved router slot — return it.
                    if c is not _STATE_CHANGED:
                        self._router.release(c[0])

                choice = await self._wfq.acquire(
                    loop, qos.get("name"), qos.get("weight", 1),
                    try_reserve, remaining, deployment=deployment,
                    on_drop=drop_grant)
                if choice is _STATE_CHANGED:
                    continue
            replica_id, handle, colocated = choice
            if _tracing._ENABLED:
                span = _tracing.get_tracer().start_span(
                    "serve.direct", attrs={"deployment": deployment,
                                           "replica": replica_id,
                                           "colocated": colocated})
            else:
                span = _tracing.NOOP_SPAN
            try:
                with span:
                    resp, view = await self._send(loop, replica_id, handle,
                                                  entry, body)
            except PreExecError:
                # Provably not executed: the classic lane (which queues
                # and retries properly) owns it — and its counter.
                return None
            except FrameLostError:
                attempts += 1
                if attempts > 1:
                    raise ConnectionError(
                        f"request to {deployment} lost on two replicas "
                        f"(last: {replica_id}); giving up")
                COUNTERS["retries"] += 1
                exclude = {replica_id}
                continue
            if resp.get("err") and resp.get("retriable") and attempts == 0:
                # Provably-not-executed replica-side refusal (draining):
                # safe to re-route once without the at-least-once caveat.
                attempts += 1
                COUNTERS["retries"] += 1
                exclude = {replica_id}
                continue
            COUNTERS["raw_requests"] += 1
            return resp, view

    async def _await_cold_start(self, loop, deployment: str, nbytes: int):
        cap = GLOBAL_CONFIG.serve_park_max_bytes
        held = self._park_bytes.get(deployment, 0)
        if held + nbytes > cap:
            COUNTERS["park_rejected"] += 1
            raise ParkBufferFull(
                f"scale-to-zero buffer for {deployment!r} is full "
                f"({held}B held, cap {cap}B)")
        COUNTERS["park_buffered"] += 1
        self._park_bytes[deployment] = held + nbytes
        span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            span = _tracing.get_tracer().start_span(
                "serve.coldstart", attrs={"deployment": deployment,
                                          "buffered_bytes": nbytes})
        t0 = time.monotonic()
        timeout = GLOBAL_CONFIG.serve_park_timeout_s
        try:
            with span:
                # Loop-friendly wait: hundreds of requests can buffer for
                # one cold start, and each parking an executor thread
                # would starve the pool for every deployment in this
                # proxy. A 20ms poll costs ~nothing against a ~100ms
                # cold start and holds no thread.
                while True:
                    if self._router.has_replicas(deployment):
                        span.set_attr("wait_ms",
                                      round((time.monotonic() - t0) * 1e3))
                        return
                    self._router.wake(deployment)  # throttled internally
                    if time.monotonic() - t0 > timeout:
                        raise TimeoutError(
                            f"deployment {deployment!r} did not cold-start "
                            f"a replica within {timeout}s")
                    await asyncio.sleep(0.02)
        finally:
            left = self._park_bytes.get(deployment, 0) - nbytes
            if left > 0:
                self._park_bytes[deployment] = left
            else:
                self._park_bytes.pop(deployment, None)

    # ----------------------------------------------------- frame transport

    def _prune_channels(self):
        version = self._router._version
        if version == self._version:
            return
        self._version = version
        live = self._router.live_replica_ids()
        for rid in list(self._channels):
            ch = self._channels[rid]
            # Never drop a channel with queued requests: its flush task is
            # about to consume ch.pending.
            if rid not in live and not ch.pending:
                self._channels.pop(rid, None)
        # Tenant admission state follows the table too: quota buckets for
        # tenants whose deployments all left must not accumulate forever.
        self._admission.prune(self._router.live_tenants())

    def _send(self, loop, replica_id: str, handle, entry, body):
        """Queue one request on the replica's channel and return the
        future for its slice of the reply frame. Coalescing window = the
        current event-loop tick: every request queued before the flush
        task runs shares the frame. No per-request wait_for — the frame
        schedules ONE timeout timer for all its requests (a per-request
        timer handle was measurable at fast-path rates)."""
        ch = self._channels.get(replica_id)
        if ch is None:
            ch = self._channels[replica_id] = _Channel()
        fut = loop.create_future()
        ch.pending.append(_Pending(entry, body, fut, replica_id))
        if not ch.scheduled:
            ch.scheduled = True
            loop.create_task(self._flush(loop, replica_id, handle, ch))
        return fut

    async def _flush(self, loop, replica_id: str, handle, ch: _Channel):
        """Drain the channel's pending requests as one or more frames.
        Slot ownership: the router slot for every request in a sent frame
        is released by the frame's completion callback (reply OR
        connection loss — the client guarantees exactly one fires); a
        frame that provably never left releases here."""
        max_reqs = GLOBAL_CONFIG.serve_coalesce_max_requests
        max_bytes = GLOBAL_CONFIG.serve_coalesce_max_bytes
        try:
            while ch.pending:
                batch: List[_Pending] = []
                total = 0
                while ch.pending and len(batch) < max_reqs:
                    nxt = ch.pending[0]
                    # A request that would push the frame past the byte
                    # cap waits for the next frame (a single oversized
                    # body still goes alone).
                    if batch and total + nxt.entry["n"] > max_bytes:
                        break
                    batch.append(ch.pending.pop(0))
                    total += nxt.entry["n"]
                client = await self._ensure_client(loop, replica_id, handle)
                if client is None:
                    self._fail_batch(batch, PreExecError(
                        f"no direct connection to replica {replica_id}"))
                    continue
                self._send_frame(loop, client, replica_id, batch)
        finally:
            ch.scheduled = False
            if ch.pending and not ch.scheduled:
                # Requests raced in while we were unwinding: reschedule.
                ch.scheduled = True
                loop.create_task(self._flush(loop, replica_id, handle, ch))

    async def _ensure_client(self, loop, replica_id: str, handle):
        ch = self._channels.get(replica_id)
        if ch is not None and ch.client is not None \
                and not ch.client.is_closed:
            return ch.client
        try:
            client = await loop.run_in_executor(
                None,
                lambda: self._runtime._actor_client(handle._actor_id).client)
        except Exception:  # noqa: BLE001 — replica gone/restarting
            return None
        if ch is not None:
            ch.client = client
        return client

    def _fail_batch(self, batch: List[_Pending], exc: Exception,
                    release: bool = True):
        for p in batch:
            if release:
                self._router.release(p.replica_id)
            if not p.fut.done():
                p.fut.set_exception(exc)

    def _send_frame(self, loop, client, replica_id: str,
                    batch: List[_Pending]):
        meta = {"v": 1, "reqs": [p.entry for p in batch]}
        parts = encode_frame(meta, [p.body for p in batch if p.entry["n"]])
        COUNTERS["raw_frames"] += 1
        if len(batch) > 1:
            COUNTERS["coalesced_requests"] += len(batch)
        timer = None

        def timeout_all():
            # Waiters stop waiting; the slots stay owned by complete() —
            # a timed-out request's replica is still busy with it, and
            # releasing early would let admission dispatch on top of it.
            for p in batch:
                if not p.fut.done():
                    p.fut.set_exception(TimeoutError(
                        f"request to replica {replica_id} timed out after "
                        f"{self.REQUEST_TIMEOUT_S}s"))

        def complete(env, payload):
            # Reader thread: decode outside the loop (cheap), resolve on
            # the loop. Slots release here unconditionally — the replica
            # is done with (or dead to) every request in the frame.
            if timer is not None:
                loop.call_soon_threadsafe(timer.cancel)
            try:
                results = self._frame_results(env, payload, batch)
            finally:
                for p in batch:
                    self._router.release(p.replica_id)
            loop.call_soon_threadsafe(self._resolve_batch, batch, results)

        try:
            client.call_raw_async("serve_raw", parts, complete)
        except Exception:  # noqa: BLE001 — send failed before the slot
            # registered: complete() will never fire, we still own slots.
            self._drop_channel_client(replica_id)
            self._fail_batch(batch, FrameLostError(
                f"connection to replica {replica_id} lost pre-send"))
            return
        timer = loop.call_later(self.REQUEST_TIMEOUT_S, timeout_all)

    def _frame_results(self, env, payload, batch: List[_Pending]) -> list:
        """Map one reply envelope/frame to a per-request result list:
        (entry, body) tuples or exceptions."""
        if env.get("_lost"):
            self._drop_channel_client(batch[0].replica_id)
            return [FrameLostError("connection to replica "
                                   f"{batch[0].replica_id} lost mid-frame")
                    ] * len(batch)
        if env.get("e"):
            # Server-side rejection before dispatch (actor still
            # initializing, no serve hook): provably not executed.
            self._drop_channel_client(batch[0].replica_id)
            return [PreExecError(str(env["e"]))] * len(batch)
        try:
            meta, region = decode_frame(payload)
            if meta.get("err"):
                raise RuntimeError(f"replica frame error: {meta['err']}")
            resps = meta["resps"]
            if len(resps) != len(batch):
                raise RuntimeError(
                    f"frame answered {len(resps)}/{len(batch)} requests")
            bodies = slice_bodies(region, [r.get("n", 0) for r in resps])
            return list(zip(resps, bodies))
        except Exception as e:  # noqa: BLE001 — corrupt/short frame
            return [e] * len(batch)

    @staticmethod
    def _resolve_batch(batch: List[_Pending], results: list):
        for p, r in zip(batch, results):
            if p.fut.done():
                continue  # timed out waiter; slot already released
            if isinstance(r, BaseException):
                p.fut.set_exception(r)
            else:
                p.fut.set_result(r)

    def _drop_channel_client(self, replica_id: str):
        ch = self._channels.get(replica_id)
        if ch is not None:
            ch.client = None

    # -------------------------------------------------------------- streams

    async def stream_pull(self, loop, deployment: str, sid: str,
                          max_items: int = 64, timeout_s: float = 30.0
                          ) -> Optional[Tuple[Dict[str, Any],
                                              List[memoryview]]]:
        """Pull the next raw chunk frame of a replica-side stream.
        Returns (meta, chunk views) or None when the replica left the
        table / the connection died (truncation — caller aborts)."""
        replica_id = sid.rsplit(":", 1)[0]
        handle = self._router.replica_for_stream(deployment, sid)
        if handle is None:
            return None
        client = await self._ensure_client(loop, replica_id, handle)
        if client is None:
            return None
        fut = loop.create_future()

        def complete(env, payload):
            def _set():
                if fut.done():
                    return
                if env.get("_lost") or env.get("e"):
                    fut.set_result(None)
                    return
                try:
                    meta, region = decode_frame(payload)
                    fut.set_result(
                        (meta, slice_bodies(region, meta.get("lens") or [])))
                except Exception as e:  # noqa: BLE001 — corrupt frame
                    fut.set_exception(e)
            loop.call_soon_threadsafe(_set)

        frame = encode_frame({"sid": sid, "max": max_items,
                              "timeout": timeout_s}, [])
        try:
            client.call_raw_async("serve_stream", frame, complete)
        except Exception:  # noqa: BLE001 — replica gone: truncated
            self._drop_channel_client(replica_id)
            return None
        COUNTERS["stream_pulls"] += 1
        try:
            return await asyncio.wait_for(fut, timeout_s + 30.0)
        except asyncio.TimeoutError:
            return None

    def stream_cancel(self, loop, deployment: str, sid: str) -> None:
        """Best-effort release of an abandoned stream's replica-side pump
        (fire-and-forget raw frame; the idle reaper is the backstop).
        Runs on the event loop, so it only ever uses an ALREADY-OPEN
        channel client — dialing a fresh connection here (the replica is
        often dead when cancels fire) would block every in-flight request
        in the proxy behind the connect timeout."""
        replica_id = sid.rsplit(":", 1)[0]
        ch = self._channels.get(replica_id)
        client = ch.client if ch is not None else None
        if client is None or client.is_closed:
            return  # no live channel: the idle reaper cleans up
        try:
            client.call_raw_async("serve_stream",
                                  encode_frame({"sid": sid, "cancel": True},
                                               []),
                                  lambda env, payload: None)
        except Exception:  # noqa: BLE001 — reaper is the backstop
            pass
