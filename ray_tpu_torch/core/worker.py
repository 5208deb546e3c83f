"""Worker process: executes tasks and hosts actors.

Equivalent of the reference's Python worker (`python/ray/_private/workers/
default_worker.py` + the execution half of CoreWorker, `core_worker.cc:2529`
ExecuteTask and the scheduling queues in `core_worker/transport/`):

- Normal tasks arrive as pushes from the raylet over the registration
  connection and run on a single executor thread.
- Actor method calls arrive on the worker's *direct* RPC server, one
  connection per caller. Per-connection handler threads give per-caller FIFO;
  an executor sized by `max_concurrency` runs them (async `async def` methods
  run on an asyncio loop, matching the reference's async actors on fibers,
  `core_worker/fiber.h`).
- Results: small values returned inline; large values sealed straight into
  the node's shared-memory store.

GPU note: a worker granted GPU resources starts with
`RAY_TPU_TORCH_GRANTED_GPU` and `CUDA_VISIBLE_DEVICES` set to its cards,
every other worker with `CUDA_VISIBLE_DEVICES=""`; torch is imported
lazily by user code, so a plain CPU worker never pays the torch import.
"""

from __future__ import annotations

import asyncio
import logging
import os
import queue
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import TaskSpec
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.rpc import DEFERRED, Connection, RpcServer
from ray_tpu_torch.core.runtime import CoreRuntime
from ray_tpu_torch.observability import tracing as _tracing

logger = logging.getLogger(__name__)


class WorkerRuntime(CoreRuntime):
    """CoreRuntime + task execution loop."""

    def __init__(self):
        worker_id = WorkerID.from_hex(os.environ["RAY_TPU_TORCH_WORKER_ID"])
        # Items: (spec, reply_conn) — reply_conn None for raylet-dispatched
        # tasks (completion via task_done), set for direct-lease pushes
        # (completion via task_result push on that connection).
        self._task_queue: "queue.Queue" = queue.Queue()
        # Direct server must exist before registration (address is reported).
        self.direct_server = RpcServer(name="worker-direct")
        self.direct_server.register("actor_call", self._handle_actor_call)
        self.direct_server.register("actor_call_light",
                                    self._handle_actor_call_light)
        self.direct_server.register_raw("serve_raw", self._handle_serve_raw)
        self.direct_server.register_raw("serve_stream",
                                        self._handle_serve_stream)
        self.direct_server.register("direct_call", self._handle_direct_call)
        self.direct_server.register("direct_call_batch",
                                    self._handle_direct_call_batch)
        self.direct_server.register("cancel_direct", self._handle_cancel_direct)
        self.direct_server.register("cancel_actor_task",
                                    self._handle_cancel_actor_task)
        self.direct_server.start()
        self._cancelled_direct: set = set()
        # Direct-result coalescing: completed lease-task results buffered
        # per owner connection and flushed as ONE task_result_batch frame
        # by a tick-bounded flusher thread (started on first use) — burst
        # completions share a frame, while any single result is delayed
        # by at most the flush tick, never by the NEXT task's runtime.
        # Entries are popped on every flush and on connection failure.
        self._direct_reply_buf: Dict[Connection, list] = {}
        self._direct_reply_lock = threading.Lock()
        self._direct_reply_event = threading.Event()
        self._direct_reply_flusher: Optional[threading.Thread] = None
        # task_id -> (future, caller conn, spec) for in-flight actor calls,
        # so cancel_actor_task can cancel queued (and async running) work.
        self._actor_calls: Dict[bytes, tuple] = {}
        # Cancellation reply dedup: fut.cancel() on a coroutine future can
        # return True while the body is mid-execution (run_coroutine_
        # threadsafe futures never enter RUNNING), so the cancel handler
        # and the coroutine's own error path may both try to reply.
        self._replied: set = set()
        # Cancels that arrived while their call was in the submit window
        # (registered in _actor_calls but future not yet created).
        self._cancel_requested: set = set()
        self._reply_lock = threading.Lock()
        super().__init__(
            gcs_address=os.environ["RAY_TPU_TORCH_GCS_ADDRESS"],
            raylet_address=os.environ["RAY_TPU_TORCH_RAYLET_ADDRESS"],
            session_suffix=os.environ["RAY_TPU_TORCH_SESSION"],
            node_id=NodeID.from_hex(os.environ["RAY_TPU_TORCH_NODE_ID"]),
            job_id=JobID.nil(),
            worker_id=worker_id,
            is_driver=False,
        )
        self.current_task_id = TaskID.for_task(JobID.nil())
        self._fn_cache: Dict[str, Any] = {}
        # Deserialized-value cache for owner-deduped immutable args
        # (kind "c"): blob -> value, LRU-capped in _resolve_args.
        from collections import OrderedDict as _OD

        self._arg_value_cache: "_OD" = _OD()
        # Actor state
        self.actor_instance: Any = None
        self.actor_spec: Optional[TaskSpec] = None
        self._actor_executor: Optional[Any] = None
        self._async_loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopping = threading.Event()
        self._cancel_task_id = None  # ray.cancel target (see on_cancel_exec)
        # Task-event batching (reference task_event_buffer_.h: events are
        # buffered and flushed on an interval, never sent per task — an
        # inline RPC per task costs more than dispatching the task).
        self._event_buf: list = []
        self._event_lock = threading.Lock()
        self._event_flusher = threading.Thread(
            target=self._event_flush_loop, name="task-event-flush",
            daemon=True)
        self._event_flusher.start()

    def _buffer_task_events(self, events: list):
        with self._event_lock:
            self._event_buf.extend(events)

    def _event_flush_loop(self, period_s: float = 1.0):
        while not self._stopping.wait(period_s):
            self._flush_task_events()
        # Final drain: the last tasks before a graceful exit must still
        # reach the timeline/state API (they were sent inline pre-batching).
        self._flush_task_events()

    def _flush_task_events(self):
        with self._event_lock:
            batch, self._event_buf = self._event_buf, []
        if not batch:
            return
        try:
            self.raylet.call_async("direct_task_event", {"events": batch})
        except Exception:  # noqa: BLE001 — observability only
            pass

    # ------------------------------------------------------------ plumbing

    def register(self):
        resp = self.raylet.call(
            "register_worker",
            {"worker_id": self.worker_id, "pid": os.getpid(),
             "direct_address": self.direct_server.address})
        if not resp.get("ok"):
            raise RuntimeError("raylet refused worker registration")

    def on_execute_task(self, spec: TaskSpec):
        # Called on the RpcClient reader thread: enqueue only.
        self._task_queue.put((spec, None))

    def _handle_direct_call(self, conn: Connection, data: Dict[str, Any]):
        """A lease holder pushes a normal task over the direct channel
        (reference: PushTask on a leased worker, direct_task_transport).
        Execution happens on the main task thread, FIFO with raylet work."""
        self._task_queue.put((data["spec"], conn))
        return {"accepted": True}

    def _handle_direct_call_batch(self, conn: Connection,
                                  data: Dict[str, Any]):
        """Submission bursts arrive as one framed message carrying many
        specs — per-task framing/syscall overhead dominates small-task
        throughput otherwise (reference batches lease-side pushes too)."""
        for spec in data["specs"]:
            self._task_queue.put((spec, conn))
        return {"accepted": len(data["specs"])}

    def _handle_cancel_direct(self, conn: Connection, data: Dict[str, Any]):
        task_id = data["task_id"]
        spec = self.executing_task
        if spec is not None and spec.task_id == task_id:
            self._cancelled_direct.add(task_id.binary())
            self.on_cancel_exec(task_id)
            return {}
        # Only mark queued targets: a cancel racing past completion must
        # not leak an entry that nothing will ever discard.
        with self._task_queue.mutex:
            queued = any(s.task_id == task_id
                         for s, _conn in self._task_queue.queue)
        if queued:
            self._cancelled_direct.add(task_id.binary())
        return {}

    def on_cancel_exec(self, task_id):
        """ray.cancel: record the target and poke the main thread; the
        SIGUSR1 handler raises only if the target is still executing."""
        self._cancel_task_id = task_id
        import signal as _signal

        os.kill(os.getpid(), _signal.SIGUSR1)

    def main_loop(self):
        while not self._stopping.is_set():
            try:
                spec, reply_conn = self._task_queue.get(timeout=1.0)
            except queue.Empty:
                if self.raylet.is_closed:
                    logger.info("raylet connection closed; worker exiting")
                    return
                continue
            if reply_conn is None:
                self._execute(spec)
            else:
                self._execute_direct(spec, reply_conn)
            if getattr(self, "_env_setup_error", None):
                # The failure has been delivered to exactly one task (as
                # RuntimeEnvSetupError); exit so this poisoned worker
                # leaves the pool — a retry gets a FRESH worker whose env
                # build may succeed, instead of re-leasing this one and
                # failing the same env forever.
                logger.error("exiting after runtime_env setup failure")
                self._stopping.set()
                return

    # ----------------------------------------------------------- execution

    def _resolve_function(self, spec: TaskSpec):
        if spec.function_blob is not None:
            return serialization.loads(spec.function_blob)
        fn_id = spec.function_id
        fn = self._fn_cache.get(fn_id)
        if fn is None:
            resp = self.gcs.call("kv_get", {"namespace": "fn", "key": fn_id.encode()})
            blob = resp["value"]
            if blob is None:
                raise RuntimeError(f"function {fn_id} not found in GCS function table")
            fn = serialization.loads(blob)
            # The exported-function cache (one entry per distinct
            # @remote definition, same as the reference's function
            # table): bounded by driver code size.
            # raylint: disable=RL011 — bounded by @remote definitions
            self._fn_cache[fn_id] = fn
        return fn

    def _resolve_args(self, spec: TaskSpec) -> Tuple[list, dict]:
        # Batch-fetch every ref arg in ONE get: a reduce-style task taking
        # n refs (push shuffle fan-in) must not pay n sequential fetch
        # round trips.
        ref_ids = [payload for kind, payload in spec.args
                   if kind not in ("v", "c")]
        fetched = iter(self.get(ref_ids)) if ref_ids else iter(())
        values = []
        arg_cache = self._arg_value_cache
        for kind, payload in spec.args:
            if kind == "c":
                # Owner-deduped immutable leaf (str/bytes/int/float/bool/
                # None — see CoreRuntime.serialize_args): safe to share
                # the deserialized value across tasks, so repeat args cost
                # a dict hit instead of a pickle parse.
                val = arg_cache.get(payload)
                if val is None and payload not in arg_cache:
                    val = serialization.deserialize(payload)
                    arg_cache[payload] = val
                    cap = max(1, GLOBAL_CONFIG.arg_dedupe_cache_entries)
                    while len(arg_cache) > cap:
                        arg_cache.popitem(last=False)
                else:
                    arg_cache.move_to_end(payload)
                values.append(val)
            elif kind == "v":
                values.append(serialization.deserialize(payload))
            else:
                values.append(next(fetched))
        nk = len(spec.kwargs_keys)
        if nk:
            pos, kwvals = values[:-nk], values[-nk:]
            return pos, dict(zip(spec.kwargs_keys, kwvals))
        return values, {}

    def _run_task_body(self, spec: TaskSpec
                       ) -> Tuple[List[Dict[str, Any]], Optional[bytes]]:
        """Shared execution core for raylet-dispatched and direct tasks:
        resolve args + function, run (awaiting coroutines), store results.
        Returns (results, error_blob)."""
        self.executing_task = spec
        # Children submitted by the body join this task's trace.
        self.set_trace_ctx(spec.trace_ctx)
        # The span ADOPTS the spec's ids: the submitter minted them, so
        # the executed span and the caller's parent edge line up.
        span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            span = _tracing.get_tracer().start_span(
                "task.run", ctx=spec.trace_ctx, attrs={"task": spec.name})
        results: List[Dict[str, Any]] = []
        error_blob: Optional[bytes] = None
        trace_err: Optional[str] = None
        try:
            if getattr(self, "_env_setup_error", None):
                from ray_tpu_torch.exceptions import RuntimeEnvSetupError

                raise RuntimeEnvSetupError(
                    f"runtime_env setup failed on this worker: "
                    f"{self._env_setup_error}")
            args, kwargs = self._resolve_args(spec)
            if spec.actor_creation:
                cls = serialization.loads(spec.actor_class_blob)
                self.actor_instance = cls(*args, **kwargs)
                restart_count = getattr(spec, "actor_restart_count", 0)
                if restart_count > 0:
                    # State-restore hook: this is incarnation N of a
                    # max_restarts actor — __init__ re-ran with the
                    # original args, and the hook lets the class rebuild
                    # state __init__ cannot (reload a checkpoint,
                    # re-subscribe). A raising hook fails the creation
                    # (the GCS declares the actor dead) — a half-restored
                    # actor must never serve calls.
                    hook = getattr(self.actor_instance,
                                   "__ray_restart__", None)
                    if hook is not None:
                        hook(restart_count)
                self.actor_spec = spec
                self._setup_actor_executor(spec.actor_max_concurrency)
                values = []
            else:
                fn = self._resolve_function(spec)
                out = fn(*args, **kwargs)
                if asyncio.iscoroutine(out):
                    out = asyncio.new_event_loop().run_until_complete(out)
                values = self._pack_returns(spec, out)
            results = [self._store_result(oid, v)
                       for oid, v in zip(spec.return_ids(), values)]
        except BaseException as e:  # noqa: BLE001 - worker must survive user errors
            error_blob = serialization.serialize_exception(e, spec.name)
            trace_err = f"{type(e).__name__}: {e}"
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                self._stopping.set()
        finally:
            self.executing_task = None
            span.end(error=trace_err)
            self.set_trace_ctx(None)
        return results, error_blob

    def _execute(self, spec: TaskSpec):
        results, error_blob = self._run_task_body(spec)
        try:
            # Pipelined: the worker is free for the next task the moment the
            # report is on the wire; failures surface via the callback.
            self.raylet.call_async(
                "task_done",
                {"task_id": spec.task_id, "results": results,
                 "error": error_blob},
                lambda env, _p: logger.error(
                    "task_done for %s failed: %s", spec.name, env.get("e"))
                if (env.get("e") or env.get("_lost")) else None)
        except Exception:
            logger.exception("failed to report task_done")

    def _execute_direct(self, spec: TaskSpec, conn: Connection):
        """Run a lease-pushed normal task; reply straight to the owner
        (inline results) / seal large results into the node store. The
        raylet never sees the task, so the worker reports its lifecycle
        events (timeline/state API parity with raylet-dispatched tasks)."""
        import time as _time

        from ray_tpu_torch.exceptions import TaskCancelledError

        started = _time.time()
        if spec.task_id.binary() in self._cancelled_direct:
            self._cancelled_direct.discard(spec.task_id.binary())
            self._reply_direct_result(
                conn, spec, [],
                serialization.serialize_exception(
                    TaskCancelledError(spec.task_id), spec.name))
            return
        try:
            results, error_blob = self._run_task_body(spec)
        finally:
            self._cancelled_direct.discard(spec.task_id.binary())
        self._reply_direct_result(conn, spec, results, error_blob)
        base = {
            "task_id": spec.task_id.hex(), "name": spec.name,
            "node_id": os.environ.get("RAY_TPU_TORCH_NODE_ID", "")[:12],
            "worker_id": self.worker_id.hex()[:12], "pid": os.getpid(),
            "queued_at": spec.submitted_at,
            **(spec.trace_ctx or {}),
        }
        self._buffer_task_events([
            dict(base, state="RUNNING", ts=started),
            dict(base, state="FAILED" if error_blob is not None
                 else "FINISHED", ts=_time.time()),
        ])

    def _pack_returns(self, spec: TaskSpec, out: Any) -> List[Any]:
        if spec.num_returns == 1:
            return [out]
        if spec.num_returns == 0:
            return []
        vals = list(out)
        if len(vals) != spec.num_returns:
            raise ValueError(
                f"Task {spec.name} declared num_returns={spec.num_returns} but "
                f"returned {len(vals)} values")
        return vals

    def _store_result(self, oid: ObjectID, value: Any) -> Dict[str, Any]:
        from ray_tpu_torch.object_ref import _NestedRefCapture

        with _NestedRefCapture() as captured:
            parts = serialization.serialize(value)
        if captured:
            # Return value embeds ObjectRefs: pin them to the result
            # container's lifetime BEFORE replying — this worker's own
            # borrows drop as soon as its locals go out of scope, which can
            # be before the caller deserializes the result.
            self._register_container_refs(oid, captured)
        size = serialization.serialized_size(parts)
        if size <= GLOBAL_CONFIG.object_inline_max_bytes:
            blob = b"".join(bytes(p) if isinstance(p, memoryview) else p for p in parts)
            return {"object_id": oid, "kind": "inline", "data": blob}
        self._write_segment(oid, parts, size)
        return {"object_id": oid, "kind": "store", "size": size}

    # -------------------------------------------------------------- actors

    def _setup_actor_executor(self, max_concurrency: int):
        from concurrent.futures import ThreadPoolExecutor

        self._actor_executor = ThreadPoolExecutor(
            max_workers=max(1, max_concurrency), thread_name_prefix="actor-exec")
        loop = asyncio.new_event_loop()
        self._async_loop = loop
        threading.Thread(target=loop.run_forever, name="actor-asyncio",
                         daemon=True).start()

    def _handle_actor_call(self, conn: Connection, data: Dict[str, Any]):
        spec: TaskSpec = data["spec"]
        if self.actor_instance is None:
            raise RuntimeError("actor not initialized")
        method = getattr(self.actor_instance, spec.method_name, None)
        if method is None and spec.method_name != "__ray_terminate__":
            # A task-level error, not a transport error: the caller gets an
            # AttributeError on get() and the actor stays alive.
            err = serialization.serialize_exception(
                AttributeError(f"actor {type(self.actor_instance).__name__!r} "
                               f"has no method {spec.method_name!r}"), spec.name)
            self._reply_actor_result(conn, spec, [], err)
            return {"accepted": True}
        if spec.method_name == "__ray_terminate__":
            self._actor_executor.submit(self._run_actor_method, conn, spec,
                                        method or (lambda: None))
            return {"accepted": True}
        tid = spec.task_id.binary()
        # Register BEFORE submitting: the method's finally-pop must find
        # the entry even when a trivial body finishes before this handler
        # resumes (a post-submit insert would leak the entry forever).
        with self._reply_lock:
            self._actor_calls[tid] = (None, conn, spec)
        if asyncio.iscoroutinefunction(getattr(method, "__func__", method)):
            fut = asyncio.run_coroutine_threadsafe(
                self._run_actor_method_async(conn, spec, method), self._async_loop)
        else:
            fut = self._actor_executor.submit(
                self._run_actor_method, conn, spec, method)
        with self._reply_lock:
            if tid in self._actor_calls:  # not yet completed
                self._actor_calls[tid] = (fut, conn, spec)
            pending_cancel = tid in self._cancel_requested
            self._cancel_requested.discard(tid)
        if pending_cancel:
            # A cancel arrived in the submit window (between registration
            # and future creation): complete it now instead of dropping it.
            self._try_cancel_actor_call(tid, fut, conn, spec)
        return {"accepted": True}

    def _handle_actor_call_light(self, conn: Connection, data: Dict[str, Any]):
        """Lean request/response actor invocation — no TaskSpec, no
        ObjectRefs, no lineage, result rides the RPC response itself.

        The actor-task machinery costs ~10x a raw RPC round trip (spec
        build + arg framing + record/ref bookkeeping on the caller, spec
        decode + reply push + task events here), which is pure overhead
        for high-rate stateless dispatch like the Serve proxy's
        per-request hop (the reference's proxy pays the equivalent C++
        fast path, `core_worker` direct actor submit). Semantics kept:
        runs on the actor executor (max_concurrency respected, async
        methods on the actor loop); dropped: ordering, cancellation,
        retries, task events — callers that need those use the full
        actor_call. Caller contract: args must not reference driver
        ``__main__`` types (serialize() falls back to by-value capture,
        so in practice any picklable args work)."""
        mid = conn.current_msg_id
        name = data["m"]
        if self.actor_instance is None:
            raise RuntimeError("actor not initialized")
        method = getattr(self.actor_instance, name, None)
        if method is None:
            raise AttributeError(
                f"actor {type(self.actor_instance).__name__!r} "
                f"has no method {name!r}")
        args = serialization.deserialize(data["a"]) if data.get("a") else ()
        kwargs = serialization.deserialize(data["kw"]) if data.get("kw") else {}

        def reply_ok(out):
            conn.reply(mid, "actor_call_light",
                       {"r": serialization.serialize_to_bytes(out)})

        def reply_err(e: BaseException):
            conn.reply(mid, "actor_call_light",
                       {"err": serialization.serialize_exception(e, name)})

        if asyncio.iscoroutinefunction(getattr(method, "__func__", method)):
            # Trace context crosses into the loop automatically:
            # run_coroutine_threadsafe schedules via call_soon_threadsafe,
            # which snapshots THIS thread's contextvars (set by the RPC
            # server from the envelope's wire context).
            async def run_async():
                try:
                    reply_ok(await method(*args, **kwargs))
                except BaseException as e:  # noqa: BLE001 — delivered to caller
                    reply_err(e)
            asyncio.run_coroutine_threadsafe(run_async(), self._async_loop)
        else:
            # Executor threads do NOT inherit contextvars: hand the wire
            # trace context across explicitly (None when tracing is off).
            tctx = _tracing.capture()

            def run():
                try:
                    if _tracing._ENABLED:
                        # Unconditional when tracing: also CLEARS any
                        # stale context a previous request left on this
                        # pooled executor thread.
                        _tracing.set_current(tctx)
                    reply_ok(method(*args, **kwargs))
                except BaseException as e:  # noqa: BLE001 — delivered to caller
                    reply_err(e)
            self._actor_executor.submit(run)
        return DEFERRED

    def _dispatch_serve_raw(self, conn: Connection, payload: bytes,
                            method: str, hook_name: str):
        """Shared core of the serve fast-lane raw handlers: hand the raw
        frame to the actor instance's dispatch hook on its asyncio loop
        and reply with the raw parts it returns.

        Reply discipline (raylint RL001): pre-schedule failures raise
        BEFORE the DEFERRED return — the server loop converts them to an
        error reply (the fast lane reads that as provably-not-executed
        and falls back). Once the coroutine is scheduled, IT owns the
        reply: every exit path of `run` replies, errors included (an
        error frame, not a transport error — user-code failures ride
        inside the frame so one bad request cannot poison a coalesced
        batch)."""
        from ray_tpu_torch.serve import dataplane

        mid = conn.current_msg_id
        inst = self.actor_instance
        loop = self._async_loop
        hook = getattr(inst, hook_name, None) if inst is not None else None
        if hook is None or loop is None:
            raise RuntimeError(
                f"actor is not a serve replica (no {hook_name})")
        view = memoryview(payload)

        async def run():
            try:
                parts = await hook(view)
            except BaseException as e:  # noqa: BLE001 — delivered as error frame
                try:
                    conn.reply_raw(mid, method,
                                   dataplane.encode_error_frame(e))
                except Exception:  # noqa: BLE001 — caller gone; its client
                    pass           # delivers the loss
                return
            try:
                conn.reply_raw(mid, method, parts)
            except Exception:  # noqa: BLE001 — caller gone mid-reply
                pass

        asyncio.run_coroutine_threadsafe(run(), loop)
        return DEFERRED

    def _handle_serve_raw(self, conn: Connection, payload: bytes):
        """Serve fast-lane request frame: raw bytes end to end (no pickle
        of request/response bodies). The frame carries 1..N coalesced
        requests; the replica's dispatch hook answers them all in one
        reply frame."""
        return self._dispatch_serve_raw(conn, payload, "serve_raw",
                                        "__serve_raw_dispatch__")

    def _handle_serve_stream(self, conn: Connection, payload: bytes):
        """Serve fast-lane stream pull: drains a replica-side stream
        queue as raw chunk frames (the token-stream consumer path)."""
        return self._dispatch_serve_raw(conn, payload, "serve_stream",
                                        "__serve_stream_raw__")

    def _try_cancel_actor_call(self, tid: bytes, fut, caller_conn: Connection,
                               spec: TaskSpec) -> bool:
        """Cancel a queued (or async mid-run — see _replied) call and report
        the cancellation; the _replied guard suppresses a duplicate reply
        from a coroutine that was actually executing."""
        cancelled = fut.cancel()
        if cancelled:
            from ray_tpu_torch.exceptions import TaskCancelledError

            with self._reply_lock:
                self._actor_calls.pop(tid, None)
                self._replied.add(tid)
                if len(self._replied) > 4096:
                    # Stale never-ran entries; ids never recur, and a
                    # dropped in-flight entry only risks a duplicate push
                    # the caller already ignores.
                    self._replied.clear()
                    self._replied.add(tid)
            self._reply_actor_result(
                caller_conn, spec, [],
                serialization.serialize_exception(
                    TaskCancelledError(spec.task_id), spec.name))
        return cancelled

    def _handle_cancel_actor_task(self, conn: Connection, data: Dict[str, Any]):
        """ray.cancel on an actor task: queued calls are dropped (caller
        gets TaskCancelledError); async running calls get CancelledError
        at their next await; sync running calls are uninterruptible
        (reference semantics: only queued/async actor tasks cancel)."""
        tid = data["task_id"].binary()
        with self._reply_lock:
            rec = self._actor_calls.get(tid)
            if rec is not None and rec[0] is None:
                # Submit window: the call is registered but its future
                # doesn't exist yet. Mark it; the post-submit
                # re-registration in _handle_actor_call completes the
                # cancellation instead of silently no-opping.
                self._cancel_requested.add(tid)
                return {"cancelled": True}
        if rec is None:
            return {"cancelled": False}
        fut, caller_conn, spec = rec
        return {"cancelled":
                self._try_cancel_actor_call(tid, fut, caller_conn, spec)}

    def _reply_actor_result_once(self, conn: Connection, spec: TaskSpec,
                                 results, error_blob):
        with self._reply_lock:
            if spec.task_id.binary() in self._replied:
                self._replied.discard(spec.task_id.binary())
                return  # cancel handler already answered this task
        self._reply_actor_result(conn, spec, results, error_blob)

    def _run_actor_method(self, conn: Connection, spec: TaskSpec, method):
        results: List[Dict[str, Any]] = []
        error_blob: Optional[bytes] = None
        trace_err: Optional[str] = None
        self.set_trace_ctx(spec.trace_ctx)
        span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            span = _tracing.get_tracer().start_span(
                "actor.call", ctx=spec.trace_ctx,
                attrs={"method": spec.method_name})
        try:
            if spec.method_name == "__ray_terminate__":
                self._graceful_exit(conn, spec)
                return
            args, kwargs = self._resolve_args(spec)
            out = method(*args, **kwargs)
            values = self._pack_returns(spec, out)
            results = [self._store_result(oid, v)
                       for oid, v in zip(spec.return_ids(), values)]
        except BaseException as e:  # noqa: BLE001
            error_blob = serialization.serialize_exception(e, spec.name)
            trace_err = f"{type(e).__name__}: {e}"
        finally:
            span.end(error=trace_err)
            self.set_trace_ctx(None)
            with self._reply_lock:
                self._actor_calls.pop(spec.task_id.binary(), None)
        self._reply_actor_result_once(conn, spec, results, error_blob)

    async def _run_actor_method_async(self, conn: Connection, spec: TaskSpec, method):
        results: List[Dict[str, Any]] = []
        error_blob: Optional[bytes] = None
        trace_err: Optional[str] = None
        self.set_trace_ctx(spec.trace_ctx)
        span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            span = _tracing.get_tracer().start_span(
                "actor.call", ctx=spec.trace_ctx,
                attrs={"method": spec.method_name})
        try:
            args, kwargs = self._resolve_args(spec)
            out = await method(*args, **kwargs)
            values = self._pack_returns(spec, out)
            results = [self._store_result(oid, v)
                       for oid, v in zip(spec.return_ids(), values)]
        except asyncio.CancelledError:
            # ray.cancel on a running async actor task: surface the typed
            # cancellation, not a bare CancelledError.
            from ray_tpu_torch.exceptions import TaskCancelledError

            error_blob = serialization.serialize_exception(
                TaskCancelledError(spec.task_id), spec.name)
            trace_err = "TaskCancelledError"
        except BaseException as e:  # noqa: BLE001
            error_blob = serialization.serialize_exception(e, spec.name)
            trace_err = f"{type(e).__name__}: {e}"
        finally:
            span.end(error=trace_err)
            self.set_trace_ctx(None)
            with self._reply_lock:
                self._actor_calls.pop(spec.task_id.binary(), None)
        self._reply_actor_result_once(conn, spec, results, error_blob)

    def _reply_direct_result(self, conn: Connection, spec: TaskSpec,
                             results, error_blob):
        """Reply for a lease-pushed direct task, coalescing with its
        neighbours: results buffer per owner connection and a tick-bounded
        flusher sends each run as one task_result_batch frame — per-result
        framing + a syscall + an owner-side wakeup each would otherwise
        dominate small-task throughput. A full buffer flushes inline; the
        flush tick bounds how long any result can sit, so a fast result is
        never held hostage by a slow successor task."""
        # Store-path results must be raylet-registered BEFORE the owner
        # learns of them (same ordering as _reply_actor_result).
        for r in results:
            if r["kind"] == "store":
                try:
                    self.raylet.call(
                        "object_sealed",
                        {"object_id": r["object_id"], "size": r["size"],
                         "owner": self.worker_id.hex()}, timeout=30)
                except Exception:
                    logger.exception("failed to register direct result")
        item = {"task_id": spec.task_id, "results": results,
                "error": error_blob}
        batch_max = GLOBAL_CONFIG.direct_result_batch_max
        if batch_max <= 1 or GLOBAL_CONFIG.direct_flush_tick_ms <= 0:
            # Coalescing off: per-result push (the A-B-A inert baseline).
            try:
                conn.push("task_result", item)
            except Exception:
                logger.warning("direct result push failed (caller gone?)")
            return
        flush_now = None
        with self._direct_reply_lock:
            buf = self._direct_reply_buf.setdefault(conn, [])
            buf.append(item)
            if len(buf) >= batch_max:
                flush_now = self._direct_reply_buf.pop(conn)
            elif self._direct_reply_flusher is None:
                self._direct_reply_flusher = threading.Thread(
                    target=self._direct_reply_flush_loop,
                    name="direct-reply-flush", daemon=True)
                self._direct_reply_flusher.start()
        if flush_now is not None:
            self._push_direct_replies(conn, flush_now)
        else:
            self._direct_reply_event.set()

    def _push_direct_replies(self, conn: Connection, batch: list):
        try:
            if len(batch) == 1:
                conn.push("task_result", batch[0])
            else:
                conn.push("task_result_batch", {"batch": batch})
        except Exception:
            logger.warning("direct result push failed (caller gone?)")

    def _direct_reply_flush_loop(self):
        while not self._stopping.is_set():
            if not self._direct_reply_event.wait(timeout=0.5):
                continue
            self._direct_reply_event.clear()
            tick = GLOBAL_CONFIG.direct_flush_tick_ms / 1000.0
            if tick > 0:
                time.sleep(tick)  # coalesce the completion burst
            self._flush_direct_replies()
        self._flush_direct_replies()  # final drain on graceful stop

    def _flush_direct_replies(self):
        with self._direct_reply_lock:
            drained = self._direct_reply_buf
            self._direct_reply_buf = {}
        for conn, batch in drained.items():
            self._push_direct_replies(conn, batch)

    def _reply_actor_result(self, conn: Connection, spec: TaskSpec,
                            results, error_blob):
        # Register large results with the raylet so other nodes can pull them.
        for r in results:
            if r["kind"] == "store":
                try:
                    self.raylet.call("object_sealed",
                                     {"object_id": r["object_id"], "size": r["size"],
                                      "owner": self.worker_id.hex()}, timeout=30)
                except Exception:
                    logger.exception("failed to register actor result")
        try:
            conn.push("task_result",
                      {"task_id": spec.task_id, "results": results, "error": error_blob})
        except Exception:
            logger.warning("actor result push failed (caller gone?)")

    def _graceful_exit(self, conn: Connection, spec: TaskSpec):
        self._reply_actor_result(conn, spec, [], None)
        self._stopping.set()
        # os._exit kills the daemon flushers before their final drains —
        # flush the last tasks' events and buffered results synchronously.
        self._flush_direct_replies()
        self._flush_task_events()
        threading.Thread(target=lambda: (os._exit(0)), daemon=True).start()


def forked_main():
    """Entry for forge-forked workers (core/worker_forge.py): the template
    already paid the module imports, so this only resets per-process state
    the fork duplicated — RNG streams (two forked workers must not draw
    identical randomness from the template's inherited state; framework
    ids reseed themselves via the pid-keyed PRNG in ids._random_bytes)
    and the template's logging handlers (main()'s basicConfig would
    otherwise be a no-op and worker logs would carry the forge's
    formatting) — then runs the normal main. The granted env vars were
    applied by the forge child before this call."""
    import random

    random.seed()  # fresh entropy, not the template's inherited state
    np = sys.modules.get("numpy")
    if np is not None:
        # Legacy global stream (new-style Generators are per-use). Seeded
        # from the just-reseeded stdlib RNG: the no-arg form gathers OS
        # entropy and costs ~30ms per fork — pure spawn-latency tax.
        np.random.seed(random.getrandbits(32))
    root = logging.getLogger()
    for h in root.handlers[:]:
        root.removeHandler(h)
    main()


def main():
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format=(f"%(asctime)s [worker pid={os.getpid()}] "
                "%(levelname)s %(name)s: %(message)s"),
    )
    runtime = WorkerRuntime()
    if os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV"):
        from ray_tpu_torch.core import runtime_env as renv_mod

        try:
            renv_mod.materialize(runtime.gcs,
                                 os.environ.get("RAY_TPU_TORCH_SESSION_DIR",
                                                "/tmp"))
        except Exception as e:  # noqa: BLE001 — surface to tasks, below
            # Dying here would crash-loop worker spawns while the queued
            # task waits forever; instead stay registered and fail every
            # dispatched task with a typed setup error (reference:
            # RuntimeEnvSetupError on the task, runtime_env_agent path).
            logging.getLogger(__name__).error(
                "runtime_env setup failed: %s", e)
            runtime._env_setup_error = f"{type(e).__name__}: {e}"
    if GLOBAL_CONFIG.log_to_driver:
        from ray_tpu_torch.core.log_streaming import LogStreamer

        def _current_job():
            spec = runtime.executing_task or runtime.actor_spec
            return spec.job_id.hex() if spec is not None else None

        streamer = LogStreamer(runtime.gcs, runtime.worker_id.hex(),
                               os.getpid(), job_provider=_current_job)
        streamer.install()

    def _term(signum, frame):
        # Drain buffered task events on a SEPARATE thread with a bounded
        # join: the handler runs on the main thread, which may be holding
        # _event_lock (mid-buffer) or the RPC send lock (mid-call) right
        # now — flushing inline would self-deadlock and the worker would
        # never exit.
        t = threading.Thread(target=runtime._flush_task_events, daemon=True)
        t.start()
        t.join(timeout=0.5)
        os._exit(0)

    def _cancel(signum, frame):
        # ray.cancel: raise in the main thread (where normal tasks run),
        # but only if the requested task is STILL the one executing — the
        # worker may have finished it and started another.
        spec = runtime.executing_task
        target = runtime._cancel_task_id
        if spec is not None and target is not None and \
                spec.task_id == target:
            runtime._cancel_task_id = None
            from ray_tpu_torch.exceptions import TaskCancelledError

            raise TaskCancelledError(spec.task_id)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGUSR1, _cancel)
    if os.environ.get("RAY_TPU_TORCH_WORKER_STACK_SAMPLING"):
        import faulthandler
        faulthandler.register(
            signal.SIGUSR2,
            file=open(f"/tmp/wstack-{os.getpid()}.txt", "w"))
    # Bind the process-global runtime so user code calling ray_tpu_torch.get/put/
    # remote inside tasks routes through this worker's CoreRuntime.
    import ray_tpu_torch

    ray_tpu_torch._global_runtime = runtime
    runtime.register()
    try:
        runtime.main_loop()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
