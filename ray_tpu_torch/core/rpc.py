"""Internal RPC: length-prefixed messages over TCP.

Plays the role of the reference's gRPC layer (`src/ray/rpc/grpc_server.h:73`,
`client_call.h:181`) for control-plane traffic between driver, GCS, raylets and
workers. Wire format per message:

    [4B LE length][msgpack envelope {i, k, m, e} ][payload bytes]

where `k` is req|resp|push, `m` the method name, `e` an error string on failed
responses. Payloads are cloudpickle for control messages; bulk object data is
raw bytes. Servers are thread-per-connection (connection counts here are tens,
not thousands); clients have a background reader so servers can push
unsolicited messages (task dispatch, pubsub) down the same connection.
"""

from __future__ import annotations

import itertools
import logging
import queue
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import msgpack

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.exceptions import RaySystemError
from ray_tpu_torch.observability import tracing as _tracing

logger = logging.getLogger(__name__)

_HDR = struct.Struct("<I")


class ConnectionLost(RaySystemError):
    pass


# --- Chaos fault hook (ray_tpu_torch/chaos) ----------------------------------------
# Installed by the chaos plane's RpcFaultInjector; None in production. The
# disabled path costs exactly one module-global None check on the send path
# (proven inert by bench_chaos's A-B-A overhead measurement). When installed,
# the filter sees (client_name, address, method) BEFORE a request frame is
# sent and returns an action:
#   None / "pass"        send normally
#   ("delay", seconds)   sleep, then send — a slow link
#   "error"              raise ConnectionLost without sending — a reset
#                        connection (ReconnectingClient re-dials, the actor
#                        submit path retries)
#   "drop"               swallow the send — a blackhole partition. Blocking
#                        callers run into their own RPC timeout; pipelined
#                        callers with a callback get the loss envelope (a
#                        drop on an ordered stream is indistinguishable from
#                        a dead connection to the sender).
# Only REQUEST frames from RpcClient are filtered: every cross-process hop in
# the system originates at some client, so node-pair partitions are expressed
# by matching the client's name/address, and response/push frames of an
# unfiltered peer stay intact (a real partition would cut both directions —
# injectors install matching filters on both sides when they want that).

_CHAOS_FILTER = None


def install_chaos_filter(fn) -> None:
    """Install `fn(client_name, address, method) -> action` as the
    process-wide RPC fault filter (see the action table above)."""
    global _CHAOS_FILTER
    _CHAOS_FILTER = fn


def clear_chaos_filter() -> None:
    global _CHAOS_FILTER
    _CHAOS_FILTER = None


def _chaos_action(client: "RpcClient", method: str):
    """Evaluate the installed filter defensively: a broken filter must
    degrade to fault-free RPC, never take the control plane down."""
    try:
        return _CHAOS_FILTER(client._name, client.address, method)
    except Exception:  # noqa: BLE001 — chaos tooling must not add faults
        logger.exception("chaos filter raised; treating as pass")
        return None


def _as_view(p) -> memoryview:
    v = p if isinstance(p, memoryview) else memoryview(p)
    if v.format != "B" or v.ndim != 1:
        v = v.cast("B") if v.contiguous else memoryview(bytes(v))
    return v


def _sendall_vectored(sock: socket.socket, views: list):
    """sendall over a list of buffers without concatenating them (one
    gather syscall per iteration; partial sends trim the head view)."""
    views = [v for v in views if v.nbytes]
    while views:
        sent = sock.sendmsg(views)
        while sent:
            if sent >= views[0].nbytes:
                sent -= views[0].nbytes
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


# Below this, one sendall of a joined frame beats the sendmsg setup cost.
_VECTOR_MIN_BYTES = 64 * 1024


def _send_msg(sock: socket.socket, envelope: dict, payload, lock: threading.Lock):
    """Frame and send one message. `payload` is bytes, a memoryview, or a
    list of buffer parts — large parts are sent with a vectored gather
    write, so chunk payloads (memoryview slices of sealed store segments)
    reach the socket without an intermediate copy."""
    env = msgpack.packb(envelope)
    parts = payload if isinstance(payload, (list, tuple)) else (payload,)
    views = [_as_view(p) for p in parts]
    plen = sum(v.nbytes for v in views)
    hdr = _HDR.pack(len(env) + 4 + plen) + _HDR.pack(len(env)) + env
    with lock:
        if plen < _VECTOR_MIN_BYTES:
            sock.sendall(hdr + b"".join(views))
        else:
            _sendall_vectored(sock, [memoryview(hdr), *views])


def _recv_into_exact(sock: socket.socket, view: memoryview):
    """Fill `view` completely from the socket (single-copy receive)."""
    pos = 0
    n = view.nbytes
    while pos < n:
        r = sock.recv_into(view[pos:])
        if r == 0:
            raise ConnectionLost("peer closed connection")
        pos += r


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_into_exact(sock, memoryview(buf))
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Tuple[dict, bytes]:
    (total,) = _HDR.unpack(_recv_exact(sock, 4))
    body = memoryview(bytearray(total))
    _recv_into_exact(sock, body)
    (elen,) = _HDR.unpack(body[:4])
    envelope = msgpack.unpackb(body[4 : 4 + elen])
    return envelope, bytes(body[4 + elen :])


# Handler return sentinel: the response will be sent later by the handler
# itself via Connection.reply(msg_id, ...) — used by long-running calls
# (e.g. actor_call_light) so the connection thread isn't parked while the
# method executes.
DEFERRED = object()


class Connection:
    """Server-side handle for one client connection; supports pushes."""

    def __init__(self, sock: socket.socket, peer: str):
        self.sock = sock
        self.peer = peer
        self.send_lock = threading.Lock()
        self.meta: Dict[str, Any] = {}  # handlers stash identity here (node id, worker id)
        self.alive = True
        # msg id of the request currently being handled (connection threads
        # process requests serially; a DEFERRED handler must read this
        # synchronously in its body).
        self.current_msg_id = 0

    def reply(self, msg_id: int, method: str, data: Any = None,
              error: Optional[str] = None):
        """Send the response for a DEFERRED request."""
        env = {"i": msg_id, "k": "resp", "m": method}
        if error is not None:
            env["e"] = error
            payload = b""
        else:
            payload = serialization.dumps_ctrl(data)
        try:
            _send_msg(self.sock, env, payload, self.send_lock)
        except OSError as e:
            self.alive = False
            raise ConnectionLost(str(e))

    def reply_raw(self, msg_id: int, method: str, payload):
        """Send a raw-bytes response for a DEFERRED raw request. `payload`
        may be a list of buffer parts (vectored, zero-copy) — used by the
        object transfer plane so a handler can hold a pin on the store
        segment for exactly the duration of the send."""
        try:
            _send_msg(self.sock, {"i": msg_id, "k": "resp", "m": method},
                      payload, self.send_lock)
        except OSError as e:
            self.alive = False
            raise ConnectionLost(str(e))

    def push(self, method: str, data: Any):
        payload = serialization.dumps_ctrl(data)
        try:
            _send_msg(self.sock, {"i": 0, "k": "push", "m": method}, payload, self.send_lock)
        except OSError as e:
            self.alive = False
            raise ConnectionLost(str(e))

    def push_raw(self, method: str, payload: bytes):
        """Push a PRE-SERIALIZED payload: fan-out paths (pubsub delta
        batches) serialize one frame once and send it to N subscribers,
        instead of paying N pickles of identical content."""
        try:
            _send_msg(self.sock, {"i": 0, "k": "push", "m": method},
                      payload, self.send_lock)
        except OSError as e:
            self.alive = False
            raise ConnectionLost(str(e))

    def close(self):
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class RpcServer:
    """Thread-per-connection RPC server.

    Handlers: fn(conn: Connection, data: Any) -> Any. Raising propagates the
    error string to the caller, which re-raises RaySystemError.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, name: str = "rpc",
                 reuse_port: bool = False):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # Opt-in REUSEPORT lets a restarted server (GCS failover) rebind its
        # old port while the previous incarnation's accepted sockets are
        # still draining through FIN_WAIT/TIME_WAIT. Off by default so an
        # accidental double-bind stays a loud EADDRINUSE.
        if reuse_port and hasattr(socket, "SO_REUSEPORT"):
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._listener.bind((host, port))
        self._listener.listen(512)
        self.host, self.port = self._listener.getsockname()
        self.address = f"{self.host}:{self.port}"
        self._name = name
        self._handlers: Dict[str, Callable[[Connection, Any], Any]] = {}
        self._raw_handlers: Dict[str, Callable[[Connection, bytes], bytes]] = {}
        self._conns: Dict[int, Connection] = {}
        self._conn_counter = itertools.count()
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self.on_disconnect: Optional[Callable[[Connection], None]] = None

    def register(self, method: str, handler: Callable[[Connection, Any], Any]):
        # Keyed by method name, registered once at server bring-up.
        # raylint: disable=RL011 — the key space is fixed by the code
        self._handlers[method] = handler

    def register_raw(self, method: str,
                     handler: Callable[[Connection, bytes], bytes]):
        """Register a handler that speaks raw payload bytes (no pickle on
        either side). This is the cross-language surface: non-Python
        clients (cpp/) frame msgpack envelopes like everyone else but
        cannot produce or parse pickled payloads, so raw methods let them
        carry msgpack (or any agreed encoding) end to end."""
        # raylint: disable=RL011 — method names, registered at bring-up
        self._raw_handlers[method] = handler

    def register_instance(self, obj: Any, prefix: str = ""):
        """Register all `handle_*` methods of obj as RPC methods."""
        for attr in dir(obj):
            if attr.startswith("handle_"):
                self.register(prefix + attr[len("handle_") :], getattr(obj, attr))

    def start(self):
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{self._name}-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            if self._stopped.is_set():
                # Stopped while blocked in accept: this connection belongs
                # to our successor (same port via REUSEPORT), not to us.
                try:
                    sock.close()
                except OSError:
                    pass
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = Connection(sock, f"{addr[0]}:{addr[1]}")
            cid = next(self._conn_counter)
            with self._lock:
                self._conns[cid] = conn
            t = threading.Thread(
                target=self._serve_conn, args=(cid, conn), name=f"{self._name}-conn{cid}", daemon=True
            )
            t.start()

    def _serve_conn(self, cid: int, conn: Connection):
        close_reason = "server stopping"
        try:
            while not self._stopped.is_set():
                envelope, payload = _recv_msg(conn.sock)
                if envelope["k"] != "req":
                    continue
                method = envelope["m"]
                handler = self._handlers.get(method)
                resp_env = {"i": envelope["i"], "k": "resp", "m": method}
                # Restore the caller's trace context for the handler (the
                # server half of wire propagation); reset after — this
                # connection thread serves many unrelated requests.
                trace_tok = None
                wire_t = envelope.get("t")
                if wire_t is not None:
                    trace_tok = _tracing.activate_wire(wire_t)
                try:
                    raw = self._raw_handlers.get(method)
                    if raw is not None:
                        conn.current_msg_id = envelope["i"]
                        out = raw(conn, payload)
                        if out is DEFERRED:
                            continue  # handler replied via conn.reply_raw()
                        _send_msg(conn.sock, resp_env, out, conn.send_lock)
                        continue
                    if handler is None:
                        raise RaySystemError(f"{self._name}: no handler for '{method}'")
                    data = serialization.loads(payload) if payload else None
                    conn.current_msg_id = envelope["i"]
                    result = handler(conn, data)
                    if result is DEFERRED:
                        continue  # handler replies via conn.reply()
                    out = serialization.dumps_ctrl(result)
                except Exception as e:
                    # Handler failures — including ConnectionLost from the
                    # handler's own outbound RPCs — must not tear down THIS
                    # connection; only IO errors on conn.sock do.
                    logger.debug("%s handler %s failed: %s", self._name, method,
                                 e, exc_info=True)
                    resp_env["e"] = f"{type(e).__name__}: {e}"
                    out = b""
                finally:
                    if trace_tok is not None:
                        _tracing.deactivate(trace_tok)
                _send_msg(conn.sock, resp_env, out, conn.send_lock)
        except (ConnectionLost, OSError) as e:
            close_reason = f"{type(e).__name__}: {e}"
        finally:
            if not self._stopped.is_set():
                logger.info("%s: connection from %s closed (%s)", self._name,
                            conn.peer, close_reason)
            conn.alive = False
            with self._lock:
                self._conns.pop(cid, None)
            if self.on_disconnect:
                try:
                    self.on_disconnect(conn)
                except Exception:
                    logger.exception("on_disconnect callback failed")
            conn.close()

    def stop(self):
        self._stopped.set()
        # shutdown() (not just close) wakes a thread blocked in accept();
        # a closed-but-still-blocked listener would otherwise keep its
        # kernel socket in LISTEN state and steal connections from a
        # restarted server on the same port.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            c.close()


class RpcClient:
    """Blocking RPC client with a background reader for responses + pushes."""

    def __init__(
        self,
        address: str,
        name: str = "client",
        push_handler: Optional[Callable[[str, Any], None]] = None,
        connect_timeout: Optional[float] = None,
        on_close: Optional[Callable[[], None]] = None,
    ):
        self.on_close = on_close
        host, port = address.rsplit(":", 1)
        timeout = connect_timeout or GLOBAL_CONFIG.rpc_connect_timeout_s
        deadline = time.monotonic() + timeout
        last_err: Optional[Exception] = None
        backoff = 0.05
        while True:
            try:
                self._sock = socket.create_connection((host, int(port)), timeout=5)
                break
            except OSError as e:
                last_err = e
                if time.monotonic() > deadline:
                    raise ConnectionLost(f"connect to {address} failed: {e}")
                # Exponential backoff, capped: a long outage (GCS restart)
                # must not spin the dial loop at 20 attempts/s for its
                # whole duration.
                time.sleep(min(backoff,
                               max(0.0, deadline - time.monotonic())))
                backoff = min(backoff * 2, 1.0)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        self.address = address
        self._name = name
        self._send_lock = threading.Lock()
        self._msg_counter = itertools.count(1)
        self._pending: Dict[int, dict] = {}
        self._pending_lock = threading.Lock()
        self._push_handler = push_handler
        self._closed = threading.Event()
        # Pushes dispatch from their own thread, NEVER the reader: a push
        # handler that blocks on a lock held by code awaiting an RPC
        # response over this client would otherwise deadlock the response
        # dispatch (observed: raylet _on_gcs_push vs _enqueue's gcs.call).
        self._push_queue: "queue.Queue" = queue.Queue()
        self._reader = threading.Thread(target=self._read_loop, name=f"{name}-reader", daemon=True)
        self._reader.start()
        if push_handler is not None:
            self._push_thread = threading.Thread(
                target=self._push_loop, name=f"{name}-push", daemon=True)
            self._push_thread.start()

    @property
    def is_closed(self) -> bool:
        return self._closed.is_set()

    def _push_loop(self):
        while not self._closed.is_set():
            try:
                item = self._push_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            method, payload = item
            try:
                data = serialization.loads(payload) if payload else None
                self._push_handler(method, data)
            except Exception:
                logger.exception("%s push handler failed", self._name)

    # Frames at or below this read as one recv (the control-plane common
    # case); larger frames parse the envelope first so chunk payloads can
    # stream straight into a registered sink buffer.
    _INLINE_FRAME_MAX = 64 * 1024

    def _peek_slot(self, envelope: dict) -> Optional[dict]:
        if envelope["k"] != "resp":
            return None
        with self._pending_lock:
            return self._pending.get(envelope["i"])

    def _read_one(self) -> Tuple[dict, bytes]:
        """Read one message — large-frame payloads land directly in a
        response's registered sink buffer when one matches (the zero-copy
        receive half of the transfer plane: chunk bytes go into the
        pre-created store segment with no intermediate buffers).

        The pending slot is only PEEKED here, never popped: if the
        connection dies mid-payload, the caller's slot must still be in
        _pending so the reader's drain delivers ConnectionLost (a popped
        slot would strand the caller until TimeoutError, skipping
        ReconnectingClient's re-dial path)."""
        (total,) = _HDR.unpack(_recv_exact(self._sock, 4))
        if total <= self._INLINE_FRAME_MAX:
            body = memoryview(bytearray(total))
            _recv_into_exact(self._sock, body)
            (elen,) = _HDR.unpack(body[:4])
            envelope = msgpack.unpackb(body[4: 4 + elen])
            payload = bytes(body[4 + elen:])
            slot = self._peek_slot(envelope)
            sink = slot.get("sink") if slot is not None else None
            if sink is not None and not envelope.get("e") and len(payload) > 4:
                # Tiny chunk (single-recv frame): honor the sink contract
                # with an explicit copy so callers see a uniform API.
                (mlen,) = _HDR.unpack(payload[:4])
                rest = len(payload) - 4 - mlen
                if rest == sink.nbytes and rest > 0:
                    sink[:] = memoryview(payload)[4 + mlen:]
                    slot["sunk"] = rest
                    payload = payload[: 4 + mlen]
            return envelope, payload
        (elen,) = _HDR.unpack(_recv_exact(self._sock, 4))
        envelope = msgpack.unpackb(_recv_exact(self._sock, elen))
        plen = total - 4 - elen
        slot = self._peek_slot(envelope)
        sink = slot.get("sink") if slot is not None else None
        if sink is not None and not envelope.get("e") and plen > 4:
            # Sink framing: [4B meta len][meta][chunk]. When the chunk part
            # is exactly the sink's size, it is received in place and the
            # returned payload carries only the meta prefix.
            hdr = _recv_exact(self._sock, 4)
            (mlen,) = _HDR.unpack(hdr)
            meta = _recv_exact(self._sock, min(mlen, plen - 4))
            rest = plen - 4 - len(meta)
            if rest == sink.nbytes:
                _recv_into_exact(self._sock, sink)
                slot["sunk"] = rest
                return envelope, hdr + meta
            return envelope, hdr + meta + _recv_exact(self._sock, rest)
        return envelope, _recv_exact(self._sock, plen) if plen else b""

    def _read_loop(self):
        reason = "reader exited"
        try:
            while not self._closed.is_set():
                envelope, payload = self._read_one()
                kind = envelope["k"]
                if kind == "resp":
                    with self._pending_lock:
                        slot = self._pending.pop(envelope["i"], None)
                    if slot is not None:
                        # Drop the sink export NOW: this frame parks in
                        # recv until the next message, and a lingering
                        # memoryview would block the segment's close.
                        slot.pop("sink", None)
                        cb = slot.get("cb")
                        if cb is not None:
                            # Async-call completion: runs ON the reader
                            # thread — callbacks must be quick and must not
                            # block on RPCs over this same client.
                            try:
                                cb(envelope, payload)
                            except Exception:
                                logger.exception("%s async callback failed",
                                                 self._name)
                        else:
                            slot["env"] = envelope
                            slot["payload"] = payload
                            slot["event"].set()
                elif kind == "push":
                    if self._push_handler is not None:
                        self._push_queue.put((envelope["m"], payload))
        except (ConnectionLost, OSError) as e:
            reason = f"{type(e).__name__}: {e}"
        finally:
            if not self._closed.is_set():
                logger.info("%s: connection to %s closed (%s)", self._name,
                            self.address, reason)
            self._closed.set()
            with self._pending_lock:
                pending = list(self._pending.values())
                self._pending.clear()
            for slot in pending:
                slot.pop("sink", None)
                cb = slot.get("cb")
                if cb is not None:
                    try:
                        cb({"e": "connection lost", "_lost": True}, b"")
                    except Exception:
                        logger.exception("%s async callback failed",
                                         self._name)
                else:
                    slot["env"] = {"e": "connection lost", "_lost": True}
                    slot["payload"] = b""
                    slot["event"].set()
            if self.on_close is not None:
                try:
                    self.on_close()
                except Exception:
                    logger.exception("%s on_close callback failed", self._name)

    def call_async(self, method: str, data: Any = None,
                   callback: Optional[Callable[[dict, bytes], None]] = None):
        """Pipelined request: send without waiting for the response.

        With `callback`, it is invoked as callback(envelope, payload) on the
        reader thread when the response (or connection loss: envelope has
        `_lost`) arrives — keep it quick and never block on RPCs over this
        client. Without, the response is dropped (fire-and-forget). This is
        the submission fast path: N tasks cost N sends, not N round trips.
        """
        self._async_send(method, serialization.dumps_ctrl(data), callback)

    def call_raw_async(self, method: str, payload,
                       callback: Callable[[dict, bytes], None]):
        """Pipelined raw-bytes request against a `register_raw` handler:
        `payload` (bytes or a list of buffer parts) travels verbatim — no
        pickle framing on either side. Same callback contract as
        call_async. This is the serve fast lane's transport: a coalesced
        request frame costs one send, and the reply frame's bytes reach
        the callback without an intermediate decode."""
        self._async_send(method, payload, callback)

    def _async_send(self, method: str, payload,
                    callback: Optional[Callable[[dict, bytes], None]]):
        """Shared pipelined-send core: pending-slot registration, the
        closed-between-check-and-insert drain race, and the OSError
        double-delivery guard live HERE once — both async entry points
        differ only in payload framing."""
        if self._closed.is_set():
            raise ConnectionLost(
                f"{self._name}: connection to {self.address} is closed")
        msg_id = next(self._msg_counter)
        if callback is not None:
            with self._pending_lock:
                self._pending[msg_id] = {"cb": callback}
            if self._closed.is_set():
                # Connection died between the check above and the slot
                # insert: the reader's drain may have missed this slot, so
                # deliver the loss ourselves (pop decides the winner).
                with self._pending_lock:
                    slot = self._pending.pop(msg_id, None)
                if slot is not None:
                    callback({"e": "connection lost", "_lost": True}, b"")
                return
        env = {"i": msg_id, "k": "req", "m": method}
        if _tracing._ENABLED:
            t = _tracing.wire_ctx()
            if t is not None:
                env["t"] = t
        if _CHAOS_FILTER is not None:
            act = _chaos_action(self, method)
            if isinstance(act, tuple) and act and act[0] == "delay":
                time.sleep(act[1])
            elif act == "drop":
                # Blackhole: the send is swallowed. A pipelined caller's
                # callback gets the loss envelope (on an ordered stream a
                # silent drop and a dead connection look identical to the
                # sender); without a callback it is fire-and-forget anyway.
                with self._pending_lock:
                    slot = self._pending.pop(msg_id, None)
                if callback is not None and slot is not None:
                    callback({"e": "chaos: dropped", "_lost": True}, b"")
                return
            elif act == "error":
                with self._pending_lock:
                    self._pending.pop(msg_id, None)
                raise ConnectionLost(
                    f"{self._name}: chaos fault injected on '{method}'")
        try:
            _send_msg(self._sock, env, payload, self._send_lock)
        except OSError as e:
            self._closed.set()
            with self._pending_lock:
                slot = self._pending.pop(msg_id, None)
            if callback is not None and slot is None:
                # The reader's drain already delivered the loss to the
                # callback; raising here would make the caller (e.g.
                # ReconnectingClient) resend with the same callback and
                # fire it twice.
                return
            raise ConnectionLost(str(e))

    def _call_framed(self, method: str, payload,
                     timeout: Optional[float],
                     sink: Optional[memoryview] = None) -> Tuple[bytes, int]:
        """Send one request payload (bytes or buffer parts) and block for
        the raw response payload. Shared by call()/call_raw(). With
        `sink`, a response whose chunk part matches the sink's size is
        received directly into it; returns (payload, bytes_sunk)."""
        if self._closed.is_set():
            raise ConnectionLost(f"{self._name}: connection to {self.address} is closed")
        msg_id = next(self._msg_counter)
        slot = {"event": threading.Event()}
        if sink is not None:
            slot["sink"] = sink
        with self._pending_lock:
            self._pending[msg_id] = slot
        env = {"i": msg_id, "k": "req", "m": method}
        if _tracing._ENABLED:
            t = _tracing.wire_ctx()
            if t is not None:
                env["t"] = t
        suppress_send = False
        if _CHAOS_FILTER is not None:
            act = _chaos_action(self, method)
            if isinstance(act, tuple) and act and act[0] == "delay":
                time.sleep(act[1])
            elif act == "error":
                with self._pending_lock:
                    self._pending.pop(msg_id, None)
                raise ConnectionLost(
                    f"{self._name}: chaos fault injected on '{method}'")
            elif act == "drop":
                # Blackhole: skip the send; the slot wait below delivers
                # this caller's own bounded TimeoutError.
                suppress_send = True
        if not suppress_send:
            try:
                _send_msg(self._sock, env, payload, self._send_lock)
            except OSError as e:
                self._closed.set()
                raise ConnectionLost(str(e))
        if not slot["event"].wait(timeout or GLOBAL_CONFIG.rpc_call_timeout_s):
            with self._pending_lock:
                self._pending.pop(msg_id, None)
            raise TimeoutError(f"{self._name}: RPC '{method}' to {self.address} timed out")
        env = slot["env"]
        if env.get("_lost"):
            # The connection died with this request in flight: typed as a
            # transport failure so reconnecting callers retry.
            raise ConnectionLost(
                f"{self._name}: connection lost during RPC '{method}'")
        if env.get("e"):
            raise RaySystemError(f"RPC '{method}' failed remotely: {env['e']}")
        return slot["payload"], slot.get("sunk", 0)

    def call(self, method: str, data: Any = None, timeout: Optional[float] = None) -> Any:
        payload, _ = self._call_framed(method, serialization.dumps_ctrl(data), timeout)
        return serialization.loads(payload) if payload else None

    def call_raw(self, method: str, payload,
                 timeout: Optional[float] = None) -> bytes:
        """Raw-bytes RPC against a `register_raw` server handler: the
        request payload (bytes or a list of buffer parts) travels verbatim
        — no pickle on either side — and the handler's raw reply bytes are
        returned. Safe to call concurrently from many threads: message ids
        multiplex the in-flight requests, which is how the transfer plane
        keeps a window of chunk fetches pipelined on one connection."""
        out, _ = self._call_framed(method, payload, timeout)
        return out

    def call_raw_into(self, method: str, payload, sink: memoryview,
                      timeout: Optional[float] = None) -> Tuple[bytes, int]:
        """call_raw whose response chunk part is received DIRECTLY into
        `sink` (a writable memoryview) when its size matches — the
        receive-side half of zero-copy transfer. Returns (meta payload,
        bytes written into sink); 0 means the reply didn't match the sink
        (busy/missing/short) and any chunk bytes are in the payload."""
        return self._call_framed(method, payload, timeout, sink=sink)

    def close(self):
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class ReconnectingClient:
    """RPC client that re-dials on connection loss (one retry per call).

    The GCS link must survive transient drops — GCS fault tolerance lets
    raylets and workers reconnect after a GCS restart (reference
    `gcs_failover_worker_reconnect_timeout`); this is the client half. The
    optional `resubscribe` callback re-establishes per-connection state
    (pubsub subscriptions, node registration) on the fresh connection.
    """

    def __init__(self, address: str, name: str, push_handler=None,
                 resubscribe=None, resolve=None):
        self.address = address
        self._name = name
        self._push_handler = push_handler
        self._resubscribe = resubscribe
        # Optional address provider, consulted before EVERY dial attempt:
        # a client that cached its address while the server was down (e.g.
        # a GCS killed and restarted elsewhere) re-resolves instead of
        # re-dialing the dead endpoint forever.
        self._resolve = resolve
        self._lock = threading.Lock()
        self._terminal = False  # close() is final: no resurrection
        self._client = RpcClient(address, name=name, push_handler=push_handler)

    @property
    def is_closed(self) -> bool:
        return self._terminal or self._client.is_closed

    def wait_disconnected(self, timeout: Optional[float] = None) -> bool:
        """Block until the underlying connection is observed closed (e.g.
        a test killed the server and must not proceed on a fixed sleep).
        True when the loss was seen within `timeout`."""
        return self._client._closed.wait(timeout)

    def _reconnect(self) -> RpcClient:
        # Bounded-backoff re-dial: each attempt re-resolves the address
        # and dials with a short per-attempt timeout, so a server that
        # comes back mid-outage (GCS restart) is picked up quickly while
        # the overall wait stays bounded by gcs_reconnect_timeout_s (a
        # dead server fails the call with ConnectionLost, never hangs
        # it). Dial attempts serialize on the lock (one racer re-dials,
        # the rest adopt its fresh client); backoff sleeps run OUTSIDE
        # the lock (RL002).
        deadline = time.monotonic() + GLOBAL_CONFIG.gcs_reconnect_timeout_s
        backoff = 0.05
        last_err: Optional[Exception] = None
        while True:
            with self._lock:
                if self._terminal:
                    raise ConnectionLost(f"{self._name}: client closed")
                if not self._client.is_closed:
                    return self._client
                addr = self.address
                if self._resolve is not None:
                    try:
                        addr = self._resolve() or self.address
                    except Exception:  # noqa: BLE001 — fall back to cached
                        logger.debug("%s: address re-resolve failed",
                                     self._name, exc_info=True)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionLost(
                        f"{self._name}: reconnect to {addr} timed out "
                        f"after {GLOBAL_CONFIG.gcs_reconnect_timeout_s}s"
                    ) from last_err
                try:
                    client = RpcClient(
                        addr, name=self._name,
                        push_handler=self._push_handler,
                        connect_timeout=min(max(backoff * 2, 0.2),
                                            remaining))
                except ConnectionLost as e:
                    client = None
                    last_err = e
                if client is not None:
                    self.address = addr
                    self._client = client
                    if self._resubscribe is not None:
                        try:
                            self._resubscribe(self._client)
                        except Exception:
                            logger.warning("%s: resubscribe failed",
                                           self._name)
                    return self._client
            time.sleep(min(backoff, max(0.0, deadline - time.monotonic())))
            backoff = min(backoff * 2, 1.0)

    def call(self, method: str, data: Any = None, timeout: Optional[float] = None):
        if self._terminal:
            # A racing in-flight call must not re-dial after an intentional
            # close — e.g. a stopped raylet's heartbeat would re-register
            # the dead node with the GCS as ALIVE.
            raise ConnectionLost(f"{self._name}: client closed")
        try:
            return self._client.call(method, data, timeout=timeout)
        except ConnectionLost:
            client = self._reconnect()
            return client.call(method, data, timeout=timeout)

    def call_async(self, method: str, data: Any = None, callback=None):
        """Pipelined send (see RpcClient.call_async); re-dials once."""
        if self._terminal:
            raise ConnectionLost(f"{self._name}: client closed")
        try:
            return self._client.call_async(method, data, callback)
        except ConnectionLost:
            client = self._reconnect()
            return client.call_async(method, data, callback)

    def close(self):
        self._terminal = True
        self._client.close()


def find_free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port
