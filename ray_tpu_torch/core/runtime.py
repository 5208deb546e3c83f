"""CoreRuntime: the embedded runtime of every driver and worker process.

Equivalent of the reference's CoreWorker (`src/ray/core_worker/core_worker.h:284`):
task submission with spillback retry (`direct_task_transport.h`), object
put/get against the node store + inline fast path, `wait`, actor handle
management and the direct actor transport with per-caller ordering
(`direct_actor_task_submitter.h`), task retries, and owner-side object
lifetime (frees propagate to the directory on ref drop).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import time
from collections import OrderedDict, defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import TaskSpec
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_store import ObjectStoreClient, _segment_name
from ray_tpu_torch.core.rpc import ConnectionLost, ReconnectingClient, RpcClient
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    RayActorError,
    RaySystemError,
    RayTaskError,
    TaskCancelledError,
)

logger = logging.getLogger(__name__)

_PENDING = object()


# --- Parked-operation registry (chaos zero-hangs watchdog) -------------------
# Every potentially-unbounded blocking wait in the public API (get / wait /
# actor resolution) registers itself here for its duration. The chaos
# plane's HangWatchdog samples the registry to enforce "no parked future
# outlives the recovery deadline": a hang becomes an attributed assertion
# (which op, for how long) instead of a silent wedge. Cost when nobody
# watches: one dict insert + delete per blocking call.

_parked_ops: Dict[int, Tuple[str, float]] = {}
_parked_lock = threading.Lock()
_parked_counter = 0


class _ParkedOp:
    __slots__ = ("token",)

    def __init__(self, desc: str):
        global _parked_counter
        with _parked_lock:
            _parked_counter += 1
            self.token = _parked_counter
            _parked_ops[self.token] = (desc, time.monotonic())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        with _parked_lock:
            _parked_ops.pop(self.token, None)
        return False


def parked_ops() -> List[Tuple[int, str, float]]:
    """(token, description, seconds parked) for every blocking public-API
    op currently in flight in THIS process."""
    now = time.monotonic()
    with _parked_lock:
        return [(tok, desc, now - t0)
                for tok, (desc, t0) in _parked_ops.items()]


class _TaskRecord:
    __slots__ = ("event", "results", "error", "crashed", "spec", "attempts",
                 "reconstructions", "submitted_addr")

    def __init__(self, spec: Optional[TaskSpec] = None):
        self.event = threading.Event()
        self.results: Optional[List[Dict[str, Any]]] = None
        self.error: Optional[bytes] = None
        self.crashed = False
        self.spec = spec
        self.attempts = 0
        self.reconstructions = 0  # lineage re-executions after object loss
        self.submitted_addr: Optional[str] = None  # raylet holding the task


class ActorClient:
    """Direct connection to an actor's worker (per caller, ordered)."""

    def __init__(self, runtime: "CoreRuntime", actor_id: ActorID, address: str):
        self.actor_id = actor_id
        self.address = address
        self.seq = 0
        # Held across seq assignment + send so the wire order matches seq
        # order even with concurrent submitters.
        self.lock = threading.Lock()
        self.client = RpcClient(
            address, name=f"actor-{actor_id.hex()[:8]}",
            push_handler=runtime._on_raylet_push,
            on_close=lambda: runtime._on_actor_conn_lost(actor_id))


class CoreRuntime:
    def __init__(
        self,
        gcs_address: str,
        raylet_address: str,
        session_suffix: str,
        node_id: Optional[NodeID] = None,
        job_id: Optional[JobID] = None,
        worker_id: Optional[WorkerID] = None,
        is_driver: bool = True,
        namespace: str = "default",
    ):
        self.is_driver = is_driver
        self.worker_id = worker_id or WorkerID.from_random()
        self.namespace = namespace
        self.node_id = node_id
        self.gcs = ReconnectingClient(gcs_address, name="runtime->gcs",
                                      push_handler=self._on_gcs_push,
                                      resubscribe=self._resubscribe_gcs)
        self.raylet = RpcClient(raylet_address, name="runtime->raylet",
                                push_handler=self._on_raylet_push)
        self.store = ObjectStoreClient(session_suffix)
        self.session_suffix = session_suffix
        from ray_tpu_torch.core.object_store import SegmentPool

        self._segment_pool = SegmentPool(
            session_suffix, GLOBAL_CONFIG.segment_pool_max_bytes)
        if job_id is None:
            resp = self.gcs.call(
                "register_job",
                {"pid": os.getpid(), "namespace": namespace,
                 "entrypoint": " ".join(os.sys.argv),
                 # Set by the job agent for submitted-job drivers: links
                 # this driver job to its submission record (job-tier
                 # status, tenant QoS, job-scoped cleanup).
                 "submission_id": os.environ.get("RAY_TPU_TORCH_SUBMISSION_ID",
                                                 "")})
            job_id = resp["job_id"]
        self.job_id = job_id
        # Job-level runtime_env: a submitted driver inherits its job's
        # prepared runtime_env (RAY_TPU_TORCH_JOB_RUNTIME_ENV, set by the job
        # agent) as the default for every task/actor it submits — that's
        # what routes the job's tasks to its per-env forge workers. A
        # worker inherits the prepared-URI subset riding its own grant
        # (RAY_TPU_TORCH_RUNTIME_ENV), so nested tasks stay in the job's env.
        _renv_blob = os.environ.get("RAY_TPU_TORCH_JOB_RUNTIME_ENV") \
            or os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
        try:
            self._job_runtime_env = json.loads(_renv_blob) \
                if _renv_blob else None
        except ValueError:
            self._job_runtime_env = None
        # The "driver task" context: puts and submissions hang off this id.
        self.current_task_id = TaskID.for_task(job_id)
        self._put_counter = 0
        # Process-wide count of lineage re-executions (_try_reconstruct
        # resubmits): the data plane's recomputed-block accounting reads
        # deltas of this to prove recovery after a node death is bounded.
        self.reconstructions_total = 0
        self._lock = threading.RLock()
        self._tasks: Dict[bytes, _TaskRecord] = {}          # task_id -> record
        self._object_to_task: Dict[bytes, bytes] = {}        # return oid -> task_id
        # Retained lineage of freed objects (task_key -> retained bytes):
        # specs stay re-executable after their outputs are freed, bounded
        # by lineage_max_bytes (oldest evicted first; see _retire_lineage).
        self._retired_lineage: "OrderedDict[bytes, int]" = OrderedDict()
        self._retired_lineage_bytes = 0
        self._object_cache: Dict[bytes, Any] = {}            # oid -> deserialized value
        self._exported_functions: set = set()
        self._actor_clients: Dict[bytes, ActorClient] = {}
        self._actor_states: Dict[bytes, Dict[str, Any]] = {}
        self._env_cache = None  # lazy runtime_env.EnvCache
        self._actor_events: Dict[bytes, threading.Event] = defaultdict(threading.Event)
        # Actor ids whose register_actor this runtime pipelined and whose
        # first state push hasn't landed yet (see create_actor /
        # wait_for_actor: suppresses the per-poll directory query).
        self._created_pending: set = set()
        self._raylet_clients: Dict[str, RpcClient] = {raylet_address: self.raylet}
        # addr -> monotonic time of last failed dial (see _raylet_for);
        # entries expire after _DEAD_DIAL_TTL_S and are pruned inline.
        self._raylet_dial_failures: Dict[str, float] = {}
        # By-value argument dedupe cache (see serialize_args): LRU of
        # (type, value) -> serialized blob, hard-capped by
        # arg_dedupe_cache_entries (evicted oldest-first on insert).
        self._arg_blob_cache: "OrderedDict" = OrderedDict()
        self._free_buffer: List[ObjectID] = []
        self._free_timer: Optional[threading.Timer] = None
        self._bg_executor = None  # lazy ThreadPoolExecutor for resubmits
        from ray_tpu_torch.core.direct_task import DirectTaskTransport

        self._direct = DirectTaskTransport(self)
        # Actor-call inline results ride the direct push channel and are
        # NOT in the cluster object directory; when such a ref is passed as
        # a task argument it must be published first (lazily — most actor
        # results never leave the caller). Keys are published-or-pending.
        self._published_deps: set = set()
        self._publish_when_done: set = set()
        # Owner-side reference counting (reference `reference_count.h`):
        # local ObjectRef count per object + pins while submitted tasks
        # depend on the object; frees are deferred until both drop to zero.
        self._ref_counts: Dict[bytes, int] = defaultdict(int)
        self._dep_pins: Dict[bytes, int] = defaultdict(int)
        self._deferred_free: set = set()
        # Borrower protocol (reference reference_count.h:61,494-500):
        # objects this process OWNS (it may free them on last drop) vs
        # objects it merely BORROWS (deserialized refs — last drop removes
        # this process from the GCS borrower set instead of freeing).
        self._owned_puts: set = set()
        self._borrowed: set = set()
        # Event-driven object availability: the raylet pushes
        # object_ready/object_unavailable instead of this process polling.
        # oid -> [Event, refcount]; refcounted so concurrent getters of the
        # same object share wakeups and the entry outlives the first getter.
        self._object_events: Dict[bytes, list] = {}
        # Event-driven wait(): each active wait() registers a
        # (deque, Event) watcher; completions append the finished task key
        # (None = non-task object progress) and set the event, so waiters
        # re-check only the refs that just completed instead of rescanning
        # every pending ref per wake (which made wait on 1k refs O(n^2)).
        self._wait_watchers: List[tuple] = []
        # get_future(): task key -> [resolve callbacks]; drained on task
        # completion into the lazily-created resolver pool (async callers
        # — the Serve proxy — await values without parking a thread per
        # in-flight request).
        self._future_waiters: Dict[bytes, List[Any]] = {}
        self._future_pool = None
        self._closed = False
        # Worker-side execution context (set by worker loop while running)
        self.executing_task: Optional[TaskSpec] = None
        # Span propagation (reference tracing_helper.py:35-81) lives in
        # the process-global tracing module (ray_tpu_torch.observability): the
        # context of the currently-executing task flows into child
        # submissions, RPC framing, and spans. Re-read the tracing flags
        # here so workers pick them up from the propagated env.
        from ray_tpu_torch.observability import tracing as _tracing_mod

        _tracing_mod.refresh_from_config()
        # Metrics flush: user Counters/Gauges/Histograms in this process
        # surface at the GCS (rendered by /metrics on the dashboard);
        # trace spans from the flight recorder piggyback on the same
        # cadence. `node` lets the GCS expire this reporter when the
        # owning node dies.
        from ray_tpu_torch.util.metrics import MetricsPusher

        self._metrics_pusher = MetricsPusher(
            self.gcs, reporter_id=("driver-" if is_driver else "worker-")
            + self.worker_id.hex()[:12],
            node=node_id.hex() if node_id is not None else None)
        self._metrics_pusher.start()
        # Drivers receive worker stdout/stderr over the LOG channel
        # (reference log_to_driver).
        if is_driver and GLOBAL_CONFIG.log_to_driver:
            try:
                self.gcs.call("subscribe", {"channel": "LOG", "key": b"*"},
                              timeout=5)
            except Exception:  # noqa: BLE001
                pass

    # ----------------------------------------------------------- push events

    def _on_raylet_push(self, method: str, data: Any):
        if method == "task_dep_lost":
            # A raylet found every copy of a dependency gone while one of
            # our tasks was parked on it. We own the creating task, so
            # re-execute it (idempotent: an in-flight reconstruction is
            # reused); the raylet's lost-dep ladder re-pulls as soon as
            # the re-executed object registers. Off the push thread: the
            # reconstruction may recursively rebuild deps.
            oid: ObjectID = data["object_id"]
            threading.Thread(target=self._try_reconstruct, args=(oid,),
                             name="dep-reconstruct", daemon=True).start()
            return
        if method == "task_result_batch":
            # Coalesced lease-worker completions (normally unrolled by the
            # direct transport's push handler; kept here so ANY connection
            # delivering a batch resolves correctly).
            for item in data["batch"]:
                self._on_raylet_push("task_result", item)
            return
        if method == "task_result":
            task_id: TaskID = data["task_id"]
            with self._lock:
                rec = self._tasks.get(task_id.binary())
            if rec is None:
                return
            if rec.event.is_set():
                # Already terminally resolved (e.g. failed by the actor-death
                # path): a late raylet notification must not unpin deps a
                # second time or resubmit the failed task.
                return
            if data.get("crashed") and rec.spec is not None and \
                    rec.attempts < rec.spec.max_retries:
                rec.attempts += 1
                logger.warning("retrying task %s (attempt %d/%d)", rec.spec.name,
                               rec.attempts, rec.spec.max_retries)
                threading.Thread(target=self._submit_spec, args=(rec.spec,),
                                 daemon=True).start()
                return
            rec.results = data.get("results") or []
            rec.error = data.get("error")
            rec.crashed = bool(data.get("crashed"))
            if rec.spec is not None:
                self._unpin_deps(rec.spec)
            for r in rec.results:
                if r["kind"] == "inline":
                    rkey = r["object_id"].binary()
                    if rkey not in self._object_to_task:
                        continue  # all refs already dropped; don't cache
                    try:
                        self._object_cache[rkey] = \
                            serialization.deserialize(r["data"])
                    except Exception as e:
                        rec.error = serialization.serialize_exception(
                            RaySystemError(f"result deserialization failed: {e}"))
            if rec.error is not None and rec.spec is not None:
                # Materialize the error as the task's return objects so tasks
                # elsewhere that depend on them get scheduled and re-raise
                # (reference: error objects stored in the object store).
                for oid in rec.spec.return_ids():
                    try:
                        self.gcs.call("object_location_add",
                                      {"object_id": oid, "inline": rec.error,
                                       "size": len(rec.error)}, timeout=10)
                    except Exception:  # noqa: BLE001 — rec.event below still
                        # unblocks local waiters with the error
                        logger.debug("error publication for %s failed", oid,
                                     exc_info=True)
            rec.event.set()
            # Deferred publication: a ref of this (actor) task was passed
            # as a task dependency before the result arrived. Runs after
            # event.set() so _ensure_dep_visible's is_set() check plus the
            # locked set-pop below give exactly-once publication.
            if rec.spec is not None and rec.results and \
                    (rec.spec.actor_id is not None or rec.spec.direct):
                with self._lock:
                    pending = [r for r in rec.results
                               if r["object_id"].binary()
                               in self._publish_when_done]
                    for r in pending:
                        self._publish_when_done.discard(
                            r["object_id"].binary())
                if pending:
                    self._publish_inline_results(pending)
            self._notify_waiters(task_id.binary())
        elif method == "task_respill":
            # A raylet returned a queued task it can never run (the cluster
            # grew): resubmit through the normal routing path.
            spec = data["spec"]
            from ray_tpu_torch.core.direct_task import LEASE_SPEC_NAME

            if spec.name == LEASE_SPEC_NAME:
                self._direct.on_lease_respill(spec)
            else:
                threading.Thread(target=self._resubmit_respilled,
                                 args=(spec,), daemon=True).start()
        elif method == "lease_granted":
            self._direct.on_lease_granted(data)
        elif method in ("object_ready", "object_unavailable"):
            entry = self._object_events.get(data["object_id"].binary())
            if entry is not None:
                entry[0].set()
            self._notify_waiters(None)
        elif method == "cancel_exec":
            self.on_cancel_exec(data["task_id"])
        elif method == "execute_task":
            # Only workers receive this; WorkerLoop overrides via subclassing hook.
            self.on_execute_task(data["spec"])

    def on_execute_task(self, spec: TaskSpec):  # overridden in worker.py
        raise RaySystemError("driver runtime received execute_task")

    def on_cancel_exec(self, task_id):  # overridden in worker.py
        pass

    def _resubscribe_gcs(self, client: RpcClient):
        # Re-bind this driver's job to the fresh connection so driver-exit
        # cleanup still fires after a GCS failover.
        if self.is_driver and getattr(self, "job_id", None) is not None:
            try:
                client.call("reattach_job", {"job_id": self.job_id}, timeout=5)
            except Exception:  # noqa: BLE001 — older GCS or racing restart
                pass
        if self.is_driver and GLOBAL_CONFIG.log_to_driver:
            try:
                client.call("subscribe", {"channel": "LOG", "key": b"*"},
                            timeout=5)
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            actor_keys = [k for k in self._actor_clients] + \
                [k for k in self._actor_states]
        for key in set(actor_keys):
            client.call("subscribe", {"channel": "ACTOR", "key": key}, timeout=5)

    def _on_gcs_push(self, method: str, data: Any):
        if method == "pubsub_batch":
            # Delta-batched pubsub frame (GCS coalesces per subscriber):
            # unroll in arrival order — within a batch the GCS preserved
            # publish order per key.
            for ev in data.get("events", ()):
                self._on_gcs_push("pubsub", ev)
            return
        if method != "pubsub":
            return
        if data["channel"] == "LOG":
            from ray_tpu_torch.core.log_streaming import print_log_batch

            msg = data["message"]
            # Only this driver's job (untagged output — actor background
            # threads between tasks — still prints).
            if msg.get("job") in (None, self.job_id.hex()):
                print_log_batch(msg)
            return
        if data["channel"] == "ACTOR":
            actor_key = data["key"]
            with self._lock:
                self._actor_states[actor_key] = data["message"]
                self._created_pending.discard(actor_key)
                self._actor_events[actor_key].set()
                client = self._actor_clients.get(actor_key)
                if client is not None and data["message"].get("state") != "ALIVE":
                    self._actor_clients.pop(actor_key, None)
                    client.client.close()

    # ------------------------------------------------------------------- put

    def put(self, value: Any, _owner: Optional[str] = None) -> ObjectID:
        with self._lock:
            self._put_counter += 1
            oid = ObjectID.for_put(self.current_task_id, self._put_counter)
        self.put_with_id(oid, value)
        return oid

    def put_with_id(self, oid: ObjectID, value: Any):
        from ray_tpu_torch.object_ref import _NestedRefCapture

        with self._lock:
            self._owned_puts.add(oid.binary())
        with _NestedRefCapture() as captured:
            parts = serialization.serialize(value)
        if captured:
            self._register_container_refs(oid, captured)
        size = serialization.serialized_size(parts)
        if size <= GLOBAL_CONFIG.object_inline_max_bytes:
            blob = b"".join(bytes(p) if isinstance(p, memoryview) else p for p in parts)
            self.gcs.call("object_location_add",
                          {"object_id": oid, "inline": blob, "size": size,
                           "owner": self.worker_id.hex()})
            self._object_cache[oid.binary()] = value
        else:
            self._write_segment(oid, parts, size, reusable=True)
            self.raylet.call("object_sealed",
                             {"object_id": oid, "size": size,
                              "owner": self.worker_id.hex()})

    # ------------------------------------------- raw objects (collective)

    def put_raw(self, parts) -> ObjectID:
        """Seal raw bytes as an object with NO serialization framing.

        The segment content is exactly the caller's bytes, so peers pull
        it over the chunked transfer plane and land it with zero
        encode/decode cost — the host-collective plane's data path. Only
        readable back via :meth:`get_raw` (a normal ``get`` would try to
        unpickle the payload)."""
        if not isinstance(parts, (list, tuple)):
            parts = [parts]
        views = [p if isinstance(p, memoryview) else memoryview(p)
                 for p in parts]
        size = sum(v.nbytes for v in views)
        with self._lock:
            self._put_counter += 1
            oid = ObjectID.for_put(self.current_task_id, self._put_counter)
            self._owned_puts.add(oid.binary())
        self._write_segment(oid, views, size, reusable=True)
        self.raylet.call("object_sealed",
                         {"object_id": oid, "size": size,
                          "owner": self.worker_id.hex()})
        return oid

    def get_raw(self, oid: ObjectID,
                timeout: Optional[float] = None) -> memoryview:
        """Raw segment view of a :meth:`put_raw` object, pulled to this
        node via the transfer plane when remote. The view aliases the
        shared segment — consume it before the object is freed."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        buf = self.store.get_buffer(oid)
        if buf is not None:
            return buf
        status, data = self._fetch_via_raylet(oid, deadline)
        if status == "local":
            buf = self.store.get_buffer(oid)
            if buf is not None:
                return buf
        elif status == "inline":
            return memoryview(data)
        if deadline is not None and time.monotonic() >= deadline:
            raise GetTimeoutError(f"Timed out getting raw object {oid}")
        raise ObjectLostError(oid)

    def free_raw(self, oids: Sequence[ObjectID]) -> None:
        """Owner-side free of put_raw objects (no ObjectRef is ever minted
        for them, so the refcount path doesn't apply); batched through the
        normal directory free."""
        with self._lock:
            for oid in oids:
                self._owned_puts.discard(oid.binary())
        for oid in oids:
            self.free_ref(oid)

    def _register_container_refs(self, container: ObjectID, captured):
        """A put/return value embeds ObjectRefs: register the inner ids as
        borrows held by the CONTAINER itself (synthetic borrower
        ``obj:<hex>``, released by the GCS when the container's entry is
        freed — see GcsServer._cascade_container_borrows_locked), so the
        inner objects survive the producer dropping its own refs before any
        consumer deserializes the container. Registered synchronously while
        the producer's refs are still live, so the handoff cannot race the
        inner objects' free (reference: contained-object-id capture in
        `_private/serialization.py` / `reference_count.h`)."""
        seen, inner = set(), []
        for n in captured:
            if n.binary() in seen or n == container:
                continue
            seen.add(n.binary())
            inner.append(n)
            self._ensure_dep_visible(n)
        if not inner:
            return
        try:
            self.gcs.call("borrow_add",
                          {"object_ids": inner,
                           "borrower_id": "obj:" + container.hex()},
                          timeout=10)
        except Exception:  # noqa: BLE001 — worst case: inner objects leak
            pass           # until job end, never a premature free

    def _write_segment(self, oid: ObjectID, parts, size: int,
                       reusable: bool = False):
        """reusable: this process owns the object (a put, not a task
        return written on the owner's behalf) and may recycle the warm
        segment through its SegmentPool when the last reference drops."""
        from multiprocessing import shared_memory

        from ray_tpu_torch._native import gather_copy

        from ray_tpu_torch.core.object_store import _promote_segment, _writer_name

        final = _segment_name(self.session_suffix, oid)
        shm = None
        if reusable:
            shm = self._segment_pool.acquire(oid, size)
        if shm is not None:
            # Warm pooled segment: pages pre-faulted at reclaim time, the
            # copy runs at memcpy speed (cold tmpfs writes fault+zero
            # every page and run 3-5x slower). Acquired under the STAGING
            # name (it holds the previous object's bytes until the copy
            # lands); promoted to the final name only once complete.
            ok = False
            try:
                gather_copy(shm.buf[:size], parts)
                _promote_segment(shm, final)
                ok = True
            finally:
                shm.close()
                if not ok:
                    # Same cleanup as the cold path: a failed copy must
                    # not leak the staged file (a later create of this
                    # object would FileExistsError on the staging name).
                    try:
                        shm.unlink()
                    except OSError:
                        pass
            self._segment_pool.track(oid, size)
            return
        shm = shared_memory.SharedMemory(
            name=_writer_name(self.session_suffix, oid), create=True,
            size=max(size, 1))
        ok = False
        try:
            gather_copy(shm.buf[:size], parts)
            # Atomic publish: same-node readers attach by the final name,
            # which must never exist with incomplete bytes behind it.
            _promote_segment(shm, final)
            ok = True
        finally:
            shm.close()
            from ray_tpu_torch.core.object_store import _untrack
            _untrack(shm)
            if not ok:
                try:
                    shm.unlink()  # drop the staged partial, never leak it
                except OSError:
                    pass
        if reusable:
            self._segment_pool.track(oid, size)

    # ------------------------------------------------------ task submission

    def export_function(self, blob: bytes) -> str:
        fn_id = hashlib.sha1(blob).hexdigest()
        if fn_id not in self._exported_functions:
            self.gcs.call("kv_put", {"namespace": "fn", "key": fn_id.encode(),
                                     "value": blob, "overwrite": False})
            self._exported_functions.add(fn_id)
        return fn_id

    # Immutable leaf types whose serialized form may be deduped across
    # submissions (they cannot embed ObjectRefs, so skipping the
    # nested-ref capture for them is sound). bool before int matters not:
    # the cache key carries the exact type.
    _ARG_CACHE_TYPES = (str, bytes, int, float, bool, type(None))

    def serialize_args(self, args: Sequence[Any], kwargs: Dict[str, Any]
                       ) -> Tuple[List[Tuple[str, Any]], List[str],
                                  List[ObjectID]]:
        """Inline small args; promote large ones to the store; pass refs
        through. Refs nested inside argument values are captured during
        pickling: the spec carries them (`nested_refs`) so the owner pins
        them until the executing worker has registered its borrow.

        Shared by-value args serialize ONCE per owner: small immutable
        leaves hit an LRU blob cache keyed by (type, value), so a loop
        submitting the same literals 10k times pays 10k dict hits, not
        10k pickles (the per-spec arg re-serialization that made
        many-arg tasks lag plain ones)."""
        from ray_tpu_torch.object_ref import ObjectRef, _NestedRefCapture

        out: List[Tuple[str, Any]] = []
        nested: List[ObjectID] = []
        flat = list(args) + list(kwargs.values())
        cache = self._arg_blob_cache
        cache_cap = GLOBAL_CONFIG.arg_dedupe_cache_entries
        for a in flat:
            if isinstance(a, ObjectRef):
                self._ensure_dep_visible(a.object_id)
                out.append(("r", a.object_id))
                continue
            cache_key = None
            if cache_cap > 0 and type(a) in self._ARG_CACHE_TYPES:
                if type(a) is float:
                    # Floats key by bit pattern: -0.0 == 0.0 (a sign-of-
                    # zero task would get the wrong cached value) and
                    # NaN != NaN (every NaN would miss and pile up).
                    cache_key = (float, struct.pack("<d", a))
                else:
                    cache_key = (type(a), a)
                blob = cache.get(cache_key)
                if blob is not None:
                    cache.move_to_end(cache_key)
                    # "c": dedupe-eligible immutable leaf — the worker may
                    # share ONE deserialized value across tasks.
                    out.append(("c", blob))
                    continue
                # Primitive leaves cannot carry refs: serialize without
                # the capture scope.
                blob = serialization.serialize_to_bytes(a)
            else:
                with _NestedRefCapture() as captured:
                    blob = serialization.serialize_to_bytes(a)
                nested.extend(captured)
            if len(blob) > GLOBAL_CONFIG.object_inline_max_bytes:
                out.append(("r", self.put(a)))
            elif cache_key is not None:
                out.append(("c", blob))
                cache[cache_key] = blob
                while len(cache) > cache_cap:
                    cache.popitem(last=False)
            else:
                out.append(("v", blob))
        for oid in nested:
            self._ensure_dep_visible(oid)
        return out, list(kwargs.keys()), nested

    def _ensure_dep_visible(self, oid: ObjectID):
        """Make an actor-call result usable as a task dependency: publish
        its inline payload to the object directory (once). Normal task
        results are registered by the executing raylet; actor store
        results by the actor's raylet — only actor INLINE results are
        invisible cluster-wide."""
        key = oid.binary()
        with self._lock:
            if key in self._published_deps:
                return
            self._published_deps.add(key)
            task_key = self._object_to_task.get(key)
            rec = self._tasks.get(task_key) if task_key is not None else None
            if rec is None or rec.spec is None or \
                    (rec.spec.actor_id is None and not rec.spec.direct):
                return  # puts/raylet task returns: already directory-visible
            self._publish_when_done.add(key)
        # Race arbitration with the result handler (which publishes pending
        # keys AFTER rec.event.set()): if the event is set here, the
        # handler's scan may have run before our add — whoever pops the key
        # from the set (under the lock) publishes; the other side skips.
        if rec.event.is_set():
            with self._lock:
                claimed = key in self._publish_when_done
                self._publish_when_done.discard(key)
                results = [r for r in (rec.results or [])
                           if r["object_id"].binary() == key]
            if claimed:
                self._publish_inline_results(results)

    def _publish_inline_results(self, results: List[Dict[str, Any]]):
        for r in results:
            if r.get("kind") != "inline":
                continue
            try:
                self.gcs.call("object_location_add",
                              {"object_id": r["object_id"],
                               "inline": r["data"], "size": len(r["data"]),
                               "owner": self.worker_id.hex()}, timeout=10)
            except Exception:  # noqa: BLE001
                logger.warning("failed to publish actor result %s",
                               r["object_id"])

    def child_trace_ctx(self) -> Dict[str, str]:
        """A fresh span context for a task being submitted from this
        context: same trace as the currently-executing task (or a new
        root, head-sampled), with the current span as parent."""
        from ray_tpu_torch.observability import tracing

        return tracing.child_spec_ctx()

    def set_trace_ctx(self, ctx: Optional[Dict[str, str]]):
        from ray_tpu_torch.observability import tracing

        tracing.set_current(ctx)

    def submit_task(self, spec: TaskSpec) -> List[ObjectID]:
        if spec.trace_ctx is None:
            spec.trace_ctx = self.child_trace_ctx()
        spec.runtime_env = self._prepare_runtime_env(spec.runtime_env)
        rec = _TaskRecord(spec=spec)
        return_ids = spec.return_ids()  # minted once: hot-path ids hash
        with self._lock:
            self._tasks[spec.task_id.binary()] = rec
            for oid in return_ids:
                self._object_to_task[oid.binary()] = spec.task_id.binary()
        self._pin_deps(spec)
        if GLOBAL_CONFIG.direct_task_enabled and self._direct.eligible(spec):
            self._direct.submit(spec)
        else:
            self._submit_spec_async(spec)
        return return_ids

    def _submit_spec_async(self, spec: TaskSpec):
        """Pipelined submission: send the spec and return immediately; the
        queued/spillback response is handled on the RPC reader thread.
        Mirrors the reference's async task submission (CoreWorker submits
        without blocking the caller, `direct_task_transport.h`): N
        `.remote()` calls cost N sends, not N round trips."""
        def cb(env, payload):
            if env.get("_lost"):
                # Local raylet died with the submit in flight: the process
                # cannot make progress; fail the record so gets raise.
                self._async_submit_error(
                    spec, RaySystemError("lost connection to raylet"))
                return
            if env.get("e"):
                self._async_submit_error(spec, RaySystemError(
                    f"submit_task failed remotely: {env['e']}"))
                return
            try:
                resp = serialization.loads(payload) if payload else {}
            except Exception as e:  # noqa: BLE001
                self._async_submit_error(spec, RaySystemError(
                    f"bad submit response: {e}"))
                return
            status = resp.get("status")
            if status == "queued":
                rec = self._tasks.get(spec.task_id.binary())
                if rec is not None:
                    rec.submitted_addr = self.raylet.address
            elif status == "spillback":
                # Routing continues with blocking hops — off the reader
                # thread (dialing the spill target must not stall response
                # dispatch for every other in-flight call).
                self._bg_submit(self._continue_spillback, spec,
                                resp["address"])
            else:
                self._async_submit_error(spec, RaySystemError(
                    f"unexpected submit status {resp}"))

        try:
            self.raylet.call_async(
                "submit_task", {"spec": spec, "grant_or_reject": False}, cb)
        except ConnectionLost:
            raise RaySystemError("lost connection to raylet")

    def _bg_submit(self, fn, *args):
        """Run fn(*args) on the shared background executor (lazy)."""
        with self._lock:
            if self._bg_executor is None:
                from concurrent.futures import ThreadPoolExecutor

                self._bg_executor = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="rt-bg")
            ex = self._bg_executor
        ex.submit(fn, *args)

    def _continue_spillback(self, spec: TaskSpec, address: str):
        if self._closed:
            return
        rec = self._tasks.get(spec.task_id.binary())
        if rec is None or rec.event.is_set():
            return
        try:
            self._submit_spec(spec, start_addr=address, spilled=True)
        except Exception as e:  # noqa: BLE001
            self._async_submit_error(spec, RaySystemError(
                f"spillback resubmit failed: {e}"))

    def _async_submit_error(self, spec: TaskSpec, err: Exception):
        rec = self._tasks.get(spec.task_id.binary())
        if rec is None or rec.event.is_set():
            return
        self._unpin_deps(spec)
        self._fail_task_record(rec, spec,
                               serialization.serialize_exception(err))

    def _submit_spec(self, spec: TaskSpec, start_addr: Optional[str] = None,
                     spilled: bool = False):
        spec.direct = False  # classic path: the raylet registers results
        if start_addr is None or start_addr == self.raylet.address:
            target = self.raylet
            target_addr = self.raylet.address
            spilled = False  # first spillback hop must accept, not bounce
        else:
            target_addr = start_addr
            try:
                target = self._raylet_for(start_addr)
            except ConnectionLost:
                # Spill target already dead (stale view): start locally.
                target = self.raylet
                target_addr = self.raylet.address
                spilled = False
        for _hop in range(8):
            try:
                resp = target.call("submit_task",
                                   {"spec": spec,
                                    "grant_or_reject": spilled})
            except ConnectionLost:
                if target is self.raylet:
                    raise RaySystemError("lost connection to raylet")
                # A spillback target died mid-submit: route through the
                # local raylet again, which may spill to another live node
                # (so grant_or_reject resets — queueing an infeasible task
                # locally would wedge it forever).
                target = self.raylet
                target_addr = self.raylet.address
                spilled = False
                continue
            if resp["status"] == "queued":
                rec = self._tasks.get(spec.task_id.binary())
                if rec is not None:
                    rec.submitted_addr = target_addr
                return
            if resp["status"] == "spillback":
                target_addr = resp["address"]
                try:
                    target = self._raylet_for(target_addr)
                except ConnectionLost:
                    # The node the router chose died between its view
                    # refresh and our dial (a kill can land at any
                    # instant): one transparent re-route via the local
                    # raylet, never a raised submit. Brief pause first —
                    # dead dials now fail in milliseconds (negative
                    # cache), so without it the 8-hop budget can burn
                    # out before the router's node view catches up with
                    # the death we just observed.
                    time.sleep(0.1)
                    target = self.raylet
                    target_addr = self.raylet.address
                spilled = target is not self.raylet
                continue
            raise RaySystemError(f"unexpected submit status {resp}")
        raise RaySystemError("task spillback loop exceeded 8 hops")

    # A failed dial is remembered this long; within the window further
    # dials to the address fail instantly instead of re-running the
    # connect-retry loop (a raylet never restarts on an old address — a
    # new raylet gets a new port — so "recently refused" means dead).
    _DEAD_DIAL_TTL_S = 5.0

    def _raylet_for(self, address: str) -> RpcClient:
        with self._lock:
            client = self._raylet_clients.get(address)
            if client is not None and not client.is_closed:
                return client
            failed_at = self._raylet_dial_failures.get(address)
            if failed_at is not None and \
                    time.monotonic() - failed_at < self._DEAD_DIAL_TTL_S:
                raise ConnectionLost(
                    f"raylet {address} recently unreachable")
        # Dial OUTSIDE the runtime lock: a dead node refuses connects
        # until the dial deadline, and holding the lock through that
        # stalls every other runtime operation (observed: a node kill
        # mid-shuffle wedged the whole driver while reconstruction
        # threads convoyed on one dead spillback target). The short
        # deadline is deliberate — unlike the GCS (which restarts at
        # the same address and deserves the patient retry loop), a
        # refused raylet dial will never start succeeding.
        try:
            client = RpcClient(
                address, name="runtime->raylet-remote",
                connect_timeout=2.0,
                push_handler=self._on_raylet_push,
                on_close=lambda: self._on_remote_raylet_lost(address))
        except ConnectionLost:
            with self._lock:
                now = time.monotonic()
                # Prune expired entries while here: the cache stays
                # bounded by recent churn, not lifetime churn.
                self._raylet_dial_failures = {
                    a: t for a, t in self._raylet_dial_failures.items()
                    if now - t < self._DEAD_DIAL_TTL_S}
                self._raylet_dial_failures[address] = now
            raise
        with self._lock:
            self._raylet_dial_failures.pop(address, None)
            existing = self._raylet_clients.get(address)
            if existing is not None and not existing.is_closed:
                existing_client = existing
            else:
                self._raylet_clients[address] = client
                existing_client = None
        if existing_client is not None:
            # Lost a dial race: keep the first client, drop ours.
            try:
                client.close()
            except Exception:  # noqa: BLE001 — already torn down
                pass
            return existing_client
        return client

    def _resubmit_respilled(self, spec: TaskSpec):
        if self._closed:
            return
        rec = self._tasks.get(spec.task_id.binary())
        if rec is None or rec.event.is_set():
            return  # already resolved elsewhere
        try:
            self._submit_spec(spec)
        except Exception as e:  # noqa: BLE001
            self._fail_task_record(rec, spec, serialization.serialize_exception(
                RaySystemError(f"respill resubmit failed: {e}")))

    def _on_remote_raylet_lost(self, address: str):
        """A remote raylet holding our submitted tasks died: fail over every
        pending task that was queued there by resubmitting through the
        local raylet (which routes around the dead node). Reference: the
        owner's lease tracking resubmits on node failure."""
        if self._closed:
            return
        # Purge the dead client from the address cache (raylint RL012):
        # the entry would otherwise pin a closed RpcClient forever for an
        # address that may never be dialed again — and under 100-node
        # churn those dead entries are one per killed node.
        with self._lock:
            client = self._raylet_clients.get(address)
            if client is not None and client.is_closed:
                self._raylet_clients.pop(address, None)
        # Lease requests queued at the dead raylet die with it: re-route
        # them too (tasks below; leases here).
        self._direct.on_raylet_lost(address)
        with self._lock:
            pending = [rec for rec in self._tasks.values()
                       if rec.submitted_addr == address
                       and rec.spec is not None and not rec.event.is_set()]
        if not pending:
            return
        # Resubmission off the dying client's reader thread: the cluster
        # view is stale right after a node death, so submits may need
        # several attempts while the GCS propagates the update.
        threading.Thread(target=self._failover_tasks,
                         args=(address, pending), daemon=True).start()

    def _failover_tasks(self, address: str, pending: List[_TaskRecord]):
        for rec in pending:
            rec.attempts += 1
            if rec.attempts > rec.spec.max_retries:
                # The user's retry budget (0 = never re-execute a possibly
                # non-idempotent task) governs failover too.
                self._fail_task_record(rec, rec.spec, serialization.serialize_exception(
                    RaySystemError(
                        f"node at {address} died with task {rec.spec.name} "
                        f"(max_retries={rec.spec.max_retries} exhausted)")))
                continue
            logger.warning("raylet %s died; resubmitting task %s "
                           "(attempt %d)", address, rec.spec.name,
                           rec.attempts)
            rec.submitted_addr = None
            last_err: Optional[Exception] = None
            for _try in range(5):
                if self._closed:
                    return
                try:
                    self._submit_spec(rec.spec)
                    last_err = None
                    break
                except Exception as e:  # noqa: BLE001 — stale view, retry
                    last_err = e
                    time.sleep(0.5)
            if last_err is not None:
                self._fail_task_record(rec, rec.spec, serialization.serialize_exception(
                    RaySystemError(f"failover resubmit failed: {last_err}")))

    # -------------------------------------------------------------- actors

    def create_actor(self, spec: TaskSpec) -> ActorID:
        spec.runtime_env = self._prepare_runtime_env(spec.runtime_env)
        key = spec.actor_id.binary()
        # One RPC, subscription piggybacked (the GCS subscribes this
        # connection before scheduling, so the ALIVE publish can't be
        # missed). Named actors stay synchronous: a name conflict must
        # raise HERE (reference semantics). Anonymous creates pipeline —
        # send-and-go, so a burst of N creates costs N sends instead of
        # N serialized GCS round trips; registration failures surface as
        # ActorDiedError on first use via the actor-state machinery.
        if spec.actor_name:
            self.gcs.call("register_actor", {"spec": spec, "subscribe": True})
            return spec.actor_id
        with self._lock:
            self._created_pending.add(key)

        def cb(env, _payload):
            err = env.get("e") or ("GCS connection lost during actor "
                                   "registration" if env.get("_lost") else None)
            if err is None:
                return
            with self._lock:
                self._created_pending.discard(key)
                self._actor_states[key] = {"state": "DEAD", "address": None,
                                           "reason": str(err),
                                           "error_blob": None}
                self._actor_events[key].set()

        self.gcs.call_async("register_actor", {"spec": spec,
                                               "subscribe": True}, cb)
        return spec.actor_id

    def _prepare_runtime_env(self, renv):
        """Local working_dir/py_modules paths -> content-addressed KV URIs
        through the shared memoizing cache (core/runtime_env.EnvCache).
        Tasks without their own runtime_env inherit the job-level one
        (task-level wins outright when both are set)."""
        if not renv:
            renv = self._job_runtime_env
        if not renv or not (renv.get("working_dir") or renv.get("py_modules")
                            or renv.get("pip")):
            return renv
        if self._env_cache is None:
            from ray_tpu_torch.core.runtime_env import EnvCache

            self._env_cache = EnvCache(self.gcs)
        return self._env_cache.prepare(renv)

    def wait_for_actor(self, actor_id: ActorID, timeout: float = 120.0) -> str:
        with _ParkedOp(f"wait_for_actor {actor_id.hex()[:12]}"):
            return self._wait_for_actor(actor_id, timeout)

    def _wait_for_actor(self, actor_id: ActorID, timeout: float) -> str:
        key = actor_id.binary()
        deadline = time.monotonic() + timeout
        # For actors THIS runtime just registered, the subscription rides
        # the register RPC and the ALIVE push is guaranteed to arrive —
        # querying the directory in the wait loop only adds an RPC per
        # 0.5s poll slice per pending actor (an RPC storm during create
        # bursts). Query immediately for foreign actors (named lookups,
        # deserialized handles); for locally-created ones the directory
        # query is anti-entropy after a grace period.
        with self._lock:
            locally_created = key in self._created_pending
        # Foreign actors keep the old 0.5s poll cadence — THIS runtime has
        # no pubsub subscription for them, so the directory query is the
        # only progress signal.
        requery = 5.0 if locally_created else 0.5
        next_query = time.monotonic() + (requery if locally_created else 0.0)
        while time.monotonic() < deadline:
            with self._lock:
                state = self._actor_states.get(key)
            # Anti-entropy re-query: for UNKNOWN actors and for cached
            # NON-TERMINAL states alike. A cached "RESTARTING" pushed by
            # a GCS that then died would otherwise gate the query off
            # forever — its ALIVE transition was published while this
            # process's subscription was down, and no later push corrects
            # the cache (observed: 120s stalls after GCS failover).
            stale = state is not None and \
                state.get("state") not in ("ALIVE", "DEAD")
            if (state is None or stale) and time.monotonic() >= next_query:
                next_query = time.monotonic() + requery
                info = self.gcs.call("get_actor_info", {"actor_id": actor_id})
                if info["known"]:
                    state = {"state": info["state"], "address": info["address"],
                             "reason": info.get("death_cause"),
                             "error_blob": None}
                    if info["state"] in ("ALIVE", "DEAD"):
                        with self._lock:
                            self._actor_states[key] = state
            if state is not None:
                with self._lock:
                    self._created_pending.discard(key)
                if state["state"] == "ALIVE" and state.get("address"):
                    return state["address"]
                if state["state"] == "DEAD":
                    blob = state.get("error_blob")
                    if blob:
                        err = serialization.deserialize_exception(blob)
                        if isinstance(err, RayTaskError):
                            raise err.as_instanceof_cause()
                        raise err
                    raise ActorDiedError(actor_id, f"Actor {actor_id.hex()[:12]} is dead: "
                                                   f"{state.get('reason')}")
            ev = self._actor_events[key]
            ev.wait(timeout=0.5)
            ev.clear()
        raise GetTimeoutError(f"Timed out waiting for actor {actor_id.hex()[:12]}")

    def actor_liveness(self, actor_id: ActorID) -> str:
        """Non-blocking actor state probe: "alive" | "pending" | "dead".

        Pushed-state cache first, one bounded GCS directory query as
        fallback — never submits a task and never waits on creation.
        Health/ping loops use this BEFORE submitting to an actor: a
        submission to a not-yet-ALIVE actor resolves its address through
        a blocking wait_for_actor, so one wedged __init__ would park the
        prober (observed: the serve reconcile loop hostage to a replica
        stuck in its constructor — the stuck-state enforcement it owns
        could then never run)."""
        key = actor_id.binary()
        with self._lock:
            state = self._actor_states.get(key)
        st = state.get("state") if state is not None else None
        if st not in ("ALIVE", "DEAD"):
            # Unknown OR cached non-terminal: query the directory. A
            # cached RESTARTING must not be trusted forever — its ALIVE
            # transition may have been published while this process's
            # subscription was down (GCS failover), and treating it as
            # eternally "pending" would make health checks kill a
            # healthy replica (same staleness mode _wait_for_actor's
            # anti-entropy re-query covers).
            try:
                resp = self.gcs.call("get_actor_info",
                                     {"actor_id": actor_id}, timeout=5)
            except Exception:  # noqa: BLE001 — GCS mid-failover
                return "pending"
            if not resp.get("known"):
                return "pending"
            st = resp.get("state")
        if st == "ALIVE":
            return "alive"
        if st == "DEAD":
            return "dead"
        return "pending"

    def _actor_client(self, actor_id: ActorID) -> ActorClient:
        key = actor_id.binary()
        with self._lock:
            client = self._actor_clients.get(key)
            if client is not None and not client.client.is_closed:
                return client
        address = self.wait_for_actor(actor_id)
        with self._lock:
            client = self._actor_clients.get(key)
            if client is None or client.client.is_closed:
                client = ActorClient(self, actor_id, address)
                self._actor_clients[key] = client
            return client

    def submit_actor_task(self, spec: TaskSpec, retry_on_restart: int = 1
                          ) -> List[ObjectID]:
        if spec.trace_ctx is None:
            spec.trace_ctx = self.child_trace_ctx()
        rec = _TaskRecord(spec=spec)
        with self._lock:
            self._tasks[spec.task_id.binary()] = rec
            for oid in spec.return_ids():
                self._object_to_task[oid.binary()] = spec.task_id.binary()
        self._pin_deps(spec)
        self._submit_actor_attempt(spec, rec, retry_on_restart + 1)
        return spec.return_ids()

    def _submit_actor_attempt(self, spec: TaskSpec, rec: _TaskRecord,
                              attempts_left: int, last_err=None):
        """One pipelined send attempt; transport failures retry on the
        background executor (the restarted actor publishes a new address),
        terminal failures resolve the record to the death error."""
        if rec.event.is_set():
            return  # already resolved (e.g. actor-death path failed it)
        if attempts_left <= 0:
            self._unpin_deps(spec)
            self._fail_task_record(rec, spec, serialization.serialize_exception(
                ActorDiedError(spec.actor_id,
                               f"actor call failed: {last_err}")))
            return

        def retry(err):
            with self._lock:
                self._actor_clients.pop(spec.actor_id.binary(), None)
                self._actor_states.pop(spec.actor_id.binary(), None)
            time.sleep(0.1)
            self._submit_actor_attempt(spec, rec, attempts_left - 1, err)

        def cb(env, payload):
            if env.get("_lost") or env.get("e"):
                # Off the reader thread: the retry re-resolves the actor
                # address (blocking) and may sleep.
                self._bg_submit(retry, env.get("e") or "connection lost")

        try:
            client = self._actor_client(spec.actor_id)
            with client.lock:
                spec.seq_no = client.seq
                client.seq += 1
                client.client.call_async("actor_call", {"spec": spec}, cb)
        except (ConnectionLost, TimeoutError, RaySystemError) as e:
            retry(e)
        except Exception as e:  # noqa: BLE001 — actor terminally DEAD
            # (or its creation failed). Submitting to a dead actor must
            # not raise at the call site: the reference returns refs
            # that resolve to the death error on get.
            self._unpin_deps(spec)
            self._fail_task_record(
                rec, spec, serialization.serialize_exception(e))

    def _on_actor_conn_lost(self, actor_id: ActorID):
        """Direct connection to the actor's worker dropped: fail every
        in-flight task on that actor (the reference resolves them to
        RayActorError; restarted actors require fresh submissions unless
        max_task_retries is set)."""
        key = actor_id.binary()
        with self._lock:
            self._actor_clients.pop(key, None)
            # Force re-resolution of the address on the next call.
            state = self._actor_states.get(key)
            if state is not None and state.get("state") == "ALIVE":
                self._actor_states.pop(key, None)
            pending = [rec for rec in self._tasks.values()
                       if rec.spec is not None and rec.spec.actor_id == actor_id
                       and not rec.event.is_set()]
        err = serialization.serialize_exception(
            ActorDiedError(actor_id,
                           f"The actor {actor_id.hex()[:12]} died while this "
                           "task was in flight."))
        for rec in pending:
            self._unpin_deps(rec.spec)
            self._fail_task_record(rec, rec.spec, err)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.gcs.call("kill_actor", {"actor_id": actor_id, "no_restart": no_restart})
        if no_restart:
            # The GCS has marked the actor dead. Its worker may still be
            # running its exit, so calls from this process must not reach
            # it over a cached connection: they fail from now on.
            key = actor_id.binary()
            with self._lock:
                self._actor_clients.pop(key, None)
                self._actor_states[key] = {
                    "state": "DEAD", "address": None, "error_blob": None,
                    "reason": "killed by ray_tpu_torch.kill"}

    def get_named_actor(self, name: str, namespace: Optional[str] = None):
        resp = self.gcs.call("get_named_actor",
                             {"name": name, "namespace": namespace or self.namespace})
        if not resp["found"]:
            raise ValueError(f"Failed to look up actor '{name}'. "
                             "It was either not created or died.")
        return resp["actor_id"], resp["creation_spec"]

    # ---------------------------------------------------------- job-scoped KV

    def _kv_namespace(self, namespace: Optional[str]) -> str:
        """GCS KV keys written through the public kv_* API live under a
        `job:<hex>:<ns>` namespace: the GCS purges the whole prefix when
        the job finishes (_finish_job), so no job can leak KV state or
        read/clobber another job's keys by accident. Detached actors
        wanting to outlive their job must use named actors or storage,
        never the owning job's KV."""
        return f"job:{self.job_id.hex()}:{namespace or 'default'}"

    def kv_put(self, key: str, value: bytes,
               namespace: Optional[str] = None) -> None:
        self.gcs.call("kv_put", {"namespace": self._kv_namespace(namespace),
                                 "key": key.encode(), "value": bytes(value)})

    def kv_get(self, key: str,
               namespace: Optional[str] = None) -> Optional[bytes]:
        resp = self.gcs.call("kv_get",
                             {"namespace": self._kv_namespace(namespace),
                              "key": key.encode()})
        return resp.get("value")

    def kv_del(self, key: str, namespace: Optional[str] = None) -> None:
        self.gcs.call("kv_del", {"namespace": self._kv_namespace(namespace),
                                 "key": key.encode()})

    # ----------------------------------------------------------------- get

    def get(self, object_ids: List[ObjectID], timeout: Optional[float] = None) -> List[Any]:
        deadline = time.monotonic() + timeout if timeout is not None else None
        state = {"blocked": False}

        def on_block():
            if not state["blocked"] and self.executing_task is not None:
                state["blocked"] = True
                self._notify_blocked(True)

        try:
            with _ParkedOp(f"get[{len(object_ids)}]"
                           + (f" {object_ids[0].hex()[:12]}" if object_ids
                              else "")):
                return [self._get_one(oid, deadline, on_block)
                        for oid in object_ids]
        finally:
            if state["blocked"]:
                self._notify_blocked(False)

    def _notify_blocked(self, blocked: bool):
        if self.executing_task is None:
            return
        try:
            self.raylet.call("worker_blocked" if blocked else "worker_unblocked", {},
                             timeout=5)
        except Exception:  # noqa: BLE001 — CPU-oversubscription hint only
            logger.debug("worker_(un)blocked notify failed", exc_info=True)

    @staticmethod
    def _maybe_raise(value: Any) -> Any:
        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        return value

    def _get_one(self, oid: ObjectID, deadline: Optional[float], on_block=None) -> Any:
        key = oid.binary()
        while True:
            cached = self._object_cache.get(key, _PENDING)
            if cached is not _PENDING:
                return self._maybe_raise(cached)
            task_key = self._object_to_task.get(key)
            rec = self._tasks.get(task_key) if task_key is not None else None
            if rec is not None:
                if not rec.event.is_set():
                    if on_block:
                        on_block()
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise GetTimeoutError("Get timed out")
                    if not rec.event.wait(remaining):
                        raise GetTimeoutError("Get timed out")
                if rec.error is not None:
                    err = serialization.deserialize_exception(rec.error)
                    if isinstance(err, RayTaskError):
                        raise err.as_instanceof_cause()
                    raise err
                cached = self._object_cache.get(key, _PENDING)
                if cached is not _PENDING:
                    return self._maybe_raise(cached)
                # Large result: fall through to store fetch.
            value = self.store.get_value(oid) if self.store.contains(oid) else _PENDING
            if value is not _PENDING:
                self._object_cache[key] = value
                return self._maybe_raise(value)
            if on_block:
                on_block()
            status, data = self._fetch_via_raylet(oid, deadline)
            if status == "local":
                value = self.store.get_value(oid)
            elif status == "inline":
                value = serialization.deserialize(data)
            elif status == "lost" and self._try_reconstruct(oid):
                # Creating task resubmitted: loop back and wait on it.
                continue
            else:
                if deadline is not None and time.monotonic() >= deadline:
                    raise GetTimeoutError(f"Timed out getting {oid}")
                raise ObjectLostError(oid)
            self._object_cache[key] = value
            return self._maybe_raise(value)

    def _fetch_via_raylet(self, oid: ObjectID, deadline: Optional[float]
                          ) -> Tuple[str, Any]:
        """Make the object available via the local raylet, event-driven.

        get_or_pull answers local/inline immediately or registers this
        process as a waiter and returns "pending"; the raylet then pushes
        object_ready / object_unavailable (no 5 ms poll loops on either
        side — reference pull manager behavior, `pull_manager.h:52`).
        Returns (status, inline_data|None); status in
        {local, inline, lost, error, timeout}.
        """
        key = oid.binary()
        with self._lock:
            entry = self._object_events.get(key)
            if entry is None:
                entry = self._object_events[key] = [threading.Event(), 0]
            entry[1] += 1
        ev = entry[0]
        status = "timeout"
        try:
            while True:
                ev.clear()
                resp = self.raylet.call("get_or_pull", {"object_id": oid},
                                        timeout=30)
                status = resp["status"]
                if status in ("local", "inline"):
                    return status, resp.get("data")
                if status == "error":
                    # Non-retryable local failure (e.g. object larger than
                    # the node store) — raise, don't loop.
                    raise RaySystemError(
                        f"cannot materialize {oid}: {resp.get('error')}")
                # "pending": a known entry with zero copies means every
                # holder died — the owner should reconstruct, not wait.
                if resp.get("known") and not resp.get("has_copies"):
                    return "lost", None
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return "timeout", None
                # Wake instantly on the raylet's push; the 1 s cap is a
                # safety net for transitions with no push (e.g. the holding
                # node died while we waited).
                wait_t = 1.0 if remaining is None else min(1.0, remaining)
                ev.wait(wait_t)
        finally:
            with self._lock:
                entry[1] -= 1
                if entry[1] <= 0:
                    self._object_events.pop(key, None)
            if status in ("timeout", "lost"):
                # Deregister from the raylet so it stops pulling for nobody.
                try:
                    self.raylet.call("cancel_object_wait",
                                     {"object_id": oid}, timeout=5)
                except Exception:  # noqa: BLE001
                    pass

    def local_result_size(self, oid: ObjectID) -> Optional[int]:
        """Sealed byte size of a task-output object we own, read from the
        completion record the worker already pushed — no directory round
        trip. None when unknown (inline result, put, not ours)."""
        key = oid.binary()
        with self._lock:
            task_key = self._object_to_task.get(key)
            rec = self._tasks.get(task_key) if task_key is not None else None
            if rec is None or not rec.results:
                return None
            for r in rec.results:
                roid = r.get("object_id")
                if roid is not None and roid.binary() == key:
                    size = r.get("size")
                    return int(size) if size else None
        return None

    def reexecute_task_for(self, oid: ObjectID) -> bool:
        """Re-run the task that created `oid` (owner-side), even when the
        task 'completed' — with a loss-shaped ERROR result because a
        dependency died under it (the raylet fails parked tasks on lost
        deps instead of hanging them). Callers must have seen loss-shaped
        evidence for the object; bounded by the same per-task budget as
        reconstruction. Returns True when a re-execution is in flight."""
        return self._try_reconstruct(oid)

    def _try_reconstruct(self, oid: ObjectID, depth: int = 0) -> bool:
        """Owner-side lineage reconstruction: re-execute the creating task
        when every copy of one of its returns is gone (reference
        `object_recovery_manager.h:106`; bounded like `task_manager.h:97`).

        Only the owner holds the spec, so only the owner can recover; puts
        and actor-task results are not replayable. Missing dependencies are
        rebuilt first, bottom-up, capped by depth and per-task attempt
        budget. Returns True if a re-execution is (already) in flight.
        """
        if depth > GLOBAL_CONFIG.max_reconstruction_depth:
            return False
        key = oid.binary()
        with self._lock:
            task_key = self._object_to_task.get(key)
            rec = self._tasks.get(task_key) if task_key is not None else None
            if rec is None or rec.spec is None:
                return False  # not ours, or a put: unrecoverable
            spec = rec.spec
            if spec.actor_id is not None or spec.actor_creation:
                return False  # actor state is not replayable
            if not rec.event.is_set():
                return True  # concurrent getter already resubmitted
            if rec.reconstructions >= GLOBAL_CONFIG.max_object_reconstructions:
                return False
            rec.reconstructions += 1
            self.reconstructions_total += 1
            rec.event.clear()
            rec.results = None
            rec.error = None
            for r in spec.return_ids():
                self._object_cache.pop(r.binary(), None)
        logger.warning("object %s lost: re-executing task %s (attempt %d)",
                       oid.hex()[:12], spec.name, rec.reconstructions)
        for dep in spec.dependencies():
            if not self._dep_alive(dep) and not self._try_reconstruct(dep, depth + 1):
                self._fail_task_record(rec, spec, serialization.serialize_exception(
                    ObjectLostError(dep)))
                return True  # the error record is the answer
        self._pin_deps(spec)
        try:
            self._submit_spec(spec)
        except Exception as e:  # noqa: BLE001
            self._unpin_deps(spec)
            self._fail_task_record(rec, spec, serialization.serialize_exception(
                RaySystemError(f"reconstruction submit failed: {e}")))
        return True

    def _fail_task_record(self, rec: _TaskRecord, spec: TaskSpec, blob: bytes):
        """Record a terminal error AND materialize it as the task's return
        objects in the directory, so tasks elsewhere that depend on them
        get scheduled and re-raise instead of waiting forever (same
        contract as the normal completion path in _on_raylet_push)."""
        with self._lock:
            rec.error = blob
            rec.event.set()
        for oid in spec.return_ids():
            try:
                self.gcs.call("object_location_add",
                              {"object_id": oid, "inline": blob,
                               "size": len(blob)}, timeout=10)
            except Exception:  # noqa: BLE001
                pass
        self._notify_waiters(spec.task_id.binary())

    def _notify_waiters(self, task_key: Optional[bytes]):
        """Wake active wait() calls with the completed task's key (None:
        non-task object progress — waiters rescan their store/GCS-backed
        refs)."""
        with self._lock:
            watchers = list(self._wait_watchers)
            resolvers = (self._future_waiters.pop(task_key, ())
                         if task_key is not None else ())
        for dq, ev in watchers:
            dq.append(task_key)
            ev.set()
        for resolve in resolvers:
            self._resolver_pool().submit(resolve)

    def _resolver_pool(self):
        if self._future_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._lock:
                if self._future_pool is None:
                    self._future_pool = ThreadPoolExecutor(
                        2, thread_name_prefix="ref-future")
        return self._future_pool

    def get_future(self, oid: ObjectID):
        """concurrent.futures.Future resolving to the object's value.

        Async servers (`asyncio.wrap_future`) await completions without a
        blocked thread per request: the future's resolve (a local fetch +
        deserialize — the object is ready by then) runs on a small shared
        pool fed by task-completion events. Refs with no local task record
        fall back to a pooled blocking get.
        """
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def resolve():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(self._get_one(oid, None))
            except BaseException as e:  # noqa: BLE001 — delivered to awaiter
                fut.set_exception(e)

        task_key = self._object_to_task.get(oid.binary())
        rec = self._tasks.get(task_key) if task_key is not None else None
        if rec is None or rec.event.is_set():
            self._resolver_pool().submit(resolve)
            return fut
        with self._lock:
            self._future_waiters.setdefault(task_key, []).append(resolve)
        if rec.event.is_set():
            # Completion landed between the check and the registration;
            # the notifier may have already drained — drain idempotently.
            with self._lock:
                resolvers = self._future_waiters.pop(task_key, ())
            for r in resolvers:
                self._resolver_pool().submit(r)
        return fut

    def cancel(self, oid: ObjectID, force: bool = False):
        """Cancel the task producing `oid` (reference ray.cancel): queued
        tasks are dropped, running tasks interrupted (force kills the
        worker). No-op for unknown/finished tasks; actor tasks refuse."""
        rec = self._tasks.get(self._object_to_task.get(oid.binary(), b""))
        if rec is None or rec.spec is None:
            return
        if rec.spec.actor_id is not None:
            # Actor tasks: queued calls drop; running async calls get
            # CancelledError at the next await; running sync calls are
            # uninterruptible (reference actor-cancel semantics —
            # force-kill would destroy actor state).
            if force:
                raise ValueError(
                    "force=True cannot cancel actor tasks (it would kill "
                    "the actor); use ray_tpu_torch.kill for that")
            try:
                client = self._actor_client(rec.spec.actor_id)
                client.client.call_async("cancel_actor_task",
                                         {"task_id": rec.spec.task_id})
            except Exception:  # noqa: BLE001 — actor dead: ref resolves
                pass           # to ActorDiedError anyway
            return
        if rec.spec.direct and self._direct.cancel(rec.spec.task_id, force):
            return
        addr = rec.submitted_addr
        client = self.raylet if addr in (None, self.raylet.address) \
            else self._raylet_for(addr)
        client.call("cancel_task",
                    {"task_id": rec.spec.task_id, "force": force},
                    timeout=30)

    def _dep_alive(self, oid: ObjectID) -> bool:
        """Cluster-visible existence: inline in the directory or at least
        one live node holds a copy."""
        try:
            e = self.gcs.call("object_locations_get", {"object_id": oid},
                              timeout=5)
        except Exception:  # noqa: BLE001
            return False
        return bool(e.get("known")
                    and (e.get("inline") is not None or e.get("nodes")))

    # ---------------------------------------------------------------- wait

    def wait(self, object_ids: List[ObjectID], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[List[ObjectID], List[ObjectID]]:
        from collections import deque as _deque

        deadline = None if timeout is None else time.monotonic() + timeout
        # Register the watcher BEFORE the initial scan so a completion
        # landing mid-scan is never missed (it lands in the deque and is
        # drained on the first wake).
        notif = (_deque(), threading.Event())
        dq, ev = notif
        with self._lock:
            self._wait_watchers.append(notif)
        ready_keys: set = set()
        n_ready = 0
        parked = _ParkedOp(f"wait[{len(object_ids)}/{num_returns}]")
        try:
            # One full scan, then purely event-driven: completed task keys
            # map back to their pending refs, so each completion costs O(1)
            # instead of a rescan of every pending ref.
            by_task: Dict[bytes, List[ObjectID]] = {}
            others: List[ObjectID] = []
            for oid in object_ids:
                if self._is_ready(oid):
                    ready_keys.add(oid.binary())
                    n_ready += 1
                    continue
                tk = self._object_to_task.get(oid.binary())
                if tk is not None:
                    by_task.setdefault(tk, []).append(oid)
                else:
                    others.append(oid)
            last_others_scan = time.monotonic()
            while n_ready < num_returns and (by_task or others):
                if deadline is not None and time.monotonic() >= deadline:
                    break
                wait_t = 0.1 if deadline is None \
                    else min(0.1, max(0.0, deadline - time.monotonic()))
                ev.wait(wait_t)
                ev.clear()
                rescan_others = False
                while dq:
                    tk = dq.popleft()
                    if tk is None:
                        rescan_others = True
                        continue
                    for oid in by_task.pop(tk, ()):
                        if self._is_ready(oid):
                            ready_keys.add(oid.binary())
                            n_ready += 1
                        else:  # record pruned mid-wait: fall back to polling
                            others.append(oid)
                # Store/GCS-backed refs (no local task record) have no push
                # channel here: poll at 100 ms, same as the old scan cadence.
                if others and (rescan_others or
                               time.monotonic() - last_others_scan >= 0.1):
                    last_others_scan = time.monotonic()
                    still = []
                    for oid in others:
                        if self._is_ready(oid):
                            ready_keys.add(oid.binary())
                            n_ready += 1
                        else:
                            still.append(oid)
                    others = still
        finally:
            parked.__exit__()
            with self._lock:
                try:
                    self._wait_watchers.remove(notif)
                except ValueError:
                    pass
        # Preserve input order; cap ready at num_returns (overflow stays
        # in the pending list, matching the reference wait() contract).
        ordered_ready = [o for o in object_ids if o.binary() in ready_keys]
        capped = ordered_ready[:num_returns]
        capped_set = {o.binary() for o in capped}
        return capped, [o for o in object_ids if o.binary() not in capped_set]

    def _is_ready(self, oid: ObjectID) -> bool:
        key = oid.binary()
        if key in self._object_cache:
            return True
        task_key = self._object_to_task.get(key)
        if task_key is not None:
            rec = self._tasks.get(task_key)
            if rec is not None:
                return rec.event.is_set()
        if self.store.contains(oid):
            return True
        try:
            entry = self.gcs.call("object_locations_get", {"object_id": oid}, timeout=5)
            return bool(entry.get("known") and
                        (entry.get("inline") is not None or entry.get("nodes")))
        except Exception:  # noqa: BLE001 — unreachable GCS == not available
            logger.debug("object_locations_get for %s failed", oid,
                         exc_info=True)
            return False

    # ------------------------------------------------------------- cleanup

    def register_ref(self, oid: ObjectID):
        with self._lock:
            self._ref_counts[oid.binary()] += 1

    def is_owner(self, oid: ObjectID) -> bool:
        key = oid.binary()
        return key in self._owned_puts or key in self._object_to_task

    def on_refs_deserialized(self, oids: List[ObjectID]):
        """This process deserialized refs it does not own: register as a
        borrower with the directory, SYNCHRONOUSLY and in one batch — the
        owner's submit-time pin (nested_refs) holds only until the task
        completes, so the borrows must be on record before user code
        runs."""
        if self._closed:
            return
        fresh: List[ObjectID] = []
        with self._lock:
            for oid in oids:
                key = oid.binary()
                if self.is_owner(oid) or key in self._borrowed:
                    continue
                self._borrowed.add(key)
                fresh.append(oid)
        if not fresh:
            return
        try:
            self.gcs.call("borrow_add",
                          {"object_ids": fresh,
                           "borrower_id": self.worker_id.hex()}, timeout=10)
        except Exception:  # noqa: BLE001 — GCS hiccup: refs still usable,
            pass           # at worst the objects outlive this borrower

    @staticmethod
    def _lineage_bytes(spec: TaskSpec) -> int:
        """Rough retained-lineage cost of one spec: inline arg payloads
        plus a per-record overhead charge (spec + record objects are a
        few KiB of real memory even with pure-ref args — the base keeps
        the retained-record COUNT honest, not just the blob bytes)."""
        try:
            return 4096 + sum(
                len(p) for _k, p in spec.args
                if isinstance(p, (bytes, bytearray, memoryview)))
        except Exception:  # noqa: BLE001 — cost estimate only
            return 8192

    def _retire_lineage(self, task_key: bytes, rec: _TaskRecord):
        """Last reference to a completed task's outputs dropped: keep the
        record re-executable (lineage) in a byte-bounded retirement
        queue instead of dropping it. Eviction (oldest first, skipping
        records that went back in flight or in scope) drops the record
        AND its object->task mappings — past the bound, a lost object is
        unrecoverable, exactly the `lineage_max_bytes` contract. Caller
        holds self._lock."""
        if task_key in self._retired_lineage:
            return
        cost = self._lineage_bytes(rec.spec)
        self._retired_lineage[task_key] = cost
        self._retired_lineage_bytes += cost
        cap = max(0, GLOBAL_CONFIG.lineage_max_bytes)
        for _ in range(len(self._retired_lineage)):
            if self._retired_lineage_bytes <= cap:
                break
            old_key, old_cost = self._retired_lineage.popitem(last=False)
            old_rec = self._tasks.get(old_key)
            busy = old_rec is not None and (
                not old_rec.event.is_set()
                or any(self._ref_counts.get(r.binary(), 0) > 0
                       for r in (old_rec.spec.return_ids()
                                 if old_rec.spec is not None else [])))
            if busy:  # re-executing or back in scope: keep, re-queue
                self._retired_lineage[old_key] = old_cost
                continue
            self._retired_lineage_bytes -= old_cost
            self._drop_lineage(old_key, old_rec)

    def _drop_lineage(self, task_key: bytes, rec: Optional[_TaskRecord]):
        self._tasks.pop(task_key, None)
        if rec is not None and rec.spec is not None:
            for r in rec.spec.return_ids():
                if self._object_to_task.get(r.binary()) == task_key:
                    self._object_to_task.pop(r.binary(), None)

    def deregister_ref(self, oid: ObjectID):
        if self._closed:
            return
        key = oid.binary()
        with self._lock:
            self._ref_counts[key] -= 1
            if self._ref_counts[key] > 0:
                return
            self._ref_counts.pop(key, None)
            # Prune driver-side caches so long-running drivers don't leak
            # one record per completed task (see reference TaskManager's
            # completed-task eviction).
            self._object_cache.pop(key, None)
            if key in self._borrowed:
                # Borrowers never free: they only remove themselves from
                # the borrower set (the owner's pending-free fires when
                # the set empties).
                self._borrowed.discard(key)
                borrow = True
            else:
                borrow = False
                owned = key in self._owned_puts or key in self._object_to_task
                self._owned_puts.discard(key)
                # LINEAGE RETENTION: keep the record (and the
                # object->task mapping) so the creating task stays
                # re-executable after the object is freed — a downstream
                # task may still need this block rebuilt when a node
                # dies (Exoshuffle's contract: shuffle intermediates are
                # recomputable from retained lineage, not re-read from a
                # bespoke service). The retirement queue bounds retained
                # lineage by `lineage_max_bytes`.
                task_key = self._object_to_task.get(key)
                if task_key is not None:
                    rec = self._tasks.get(task_key)
                    replayable = (rec is not None and rec.spec is not None
                                  and rec.spec.actor_id is None
                                  and not rec.spec.actor_creation)
                    if not replayable:
                        # Pre-retention behavior for records lineage can
                        # never replay (actor results, dangling maps).
                        self._object_to_task.pop(key, None)
                        if rec is not None and rec.event.is_set():
                            returns = rec.spec.return_ids() \
                                if rec.spec is not None else []
                            if not any(r.binary() in self._object_to_task
                                       for r in returns):
                                self._tasks.pop(task_key, None)
                    elif rec.event.is_set():
                        returns = rec.spec.return_ids()
                        if not any(self._ref_counts.get(r.binary(), 0) > 0
                                   for r in returns):
                            self._retire_lineage(task_key, rec)
                if not owned:
                    # Not ours and not registered as a borrow (e.g. created
                    # before tracking): never free somebody else's object.
                    return
                if self._dep_pins.get(key, 0) > 0:
                    self._deferred_free.add(key)
                    return
        if borrow:
            try:
                self.gcs.call_async("borrow_remove",
                                    {"object_id": oid,
                                     "borrower_id": self.worker_id.hex()})
            except Exception:  # noqa: BLE001
                pass
            return
        self.free_ref(oid)

    def _pin_deps(self, spec: TaskSpec):
        with self._lock:
            for dep in spec.dependencies() + list(spec.nested_refs):
                self._dep_pins[dep.binary()] += 1

    def _unpin_deps(self, spec: TaskSpec):
        to_free = []
        with self._lock:
            for dep in spec.dependencies() + list(spec.nested_refs):
                key = dep.binary()
                self._dep_pins[key] -= 1
                if self._dep_pins[key] <= 0:
                    self._dep_pins.pop(key, None)
                    if key in self._deferred_free:
                        self._deferred_free.discard(key)
                        to_free.append(dep)
        for dep in to_free:
            self.free_ref(dep)

    def free_ref(self, oid: ObjectID):
        """Owner dropped its last reference; batch-free in the directory.

        Flushes at 100 ids or after 1s (timer), so drivers freeing fewer
        than 100 objects still release GCS directory entries promptly.
        """
        if self._closed:
            return
        with self._lock:
            self._free_buffer.append(oid)
            # Pool-tracked puts flush now: their segments only become
            # reusable once the directory confirms the free, and a warm
            # segment idling in the batch buffer is a wasted recycle.
            flush = (len(self._free_buffer) >= 100
                     or self._segment_pool.is_tracked(oid))
            if not flush and self._free_timer is None:
                self._free_timer = threading.Timer(1.0, self._flush_free_buffer)
                self._free_timer.daemon = True
                self._free_timer.start()
        if flush:
            self._flush_free_buffer()

    def _flush_free_buffer(self):
        with self._lock:
            if self._free_timer is not None:
                self._free_timer.cancel()
                self._free_timer = None
            if not self._free_buffer:
                return
            batch, self._free_buffer = self._free_buffer, []
        pool = self._segment_pool
        msg: Dict[str, Any] = {"object_ids": batch}
        tracked = [o for o in batch if pool.is_tracked(o)]
        if tracked:
            msg["defer_unlink"] = tracked
            msg["defer_node"] = self.node_id
        try:
            resp = self.gcs.call("free_objects", msg, timeout=5)
        except Exception:  # noqa: BLE001 — fall back to direct unlink
            logger.debug("free_objects RPC failed; forgetting %d tracked "
                         "segments", len(tracked), exc_info=True)
            for oid in tracked:
                pool.forget(oid)
            return
        if not tracked:
            return
        freed = {o.binary() for o in (resp or {}).get("freed", ())}
        for oid in tracked:
            if oid.binary() in freed:
                ok = pool.reclaim(
                    oid,
                    can_reuse=lambda o=oid: self.store.release_if_unused(o))
                if not ok:
                    # The raylet skipped the unlink on our behalf; if the
                    # segment didn't make it into the pool (exports still
                    # live, pool full), remove the orphaned file now.
                    try:
                        os.unlink("/dev/shm/" + _segment_name(
                            self.session_suffix, oid))
                    except OSError:
                        pass
            else:
                # Deferred (still borrowed): the eventual free unlinks it
                # on the raylet as usual; nothing to recycle.
                pool.forget(oid)

    def shutdown(self):
        self._flush_free_buffer()
        self._segment_pool.close()
        if self._future_pool is not None:
            self._future_pool.shutdown(wait=False)
        if self._borrowed:
            # Graceful exit drops every borrow in one call so pending
            # frees fire now instead of leaking until worker-death cleanup.
            try:
                self.gcs.call("borrower_gone",
                              {"borrower_id": self.worker_id.hex()},
                              timeout=5)
            except Exception:  # noqa: BLE001
                pass
        try:
            self._metrics_pusher.stop()
        except Exception:  # noqa: BLE001
            pass
        self._closed = True
        try:
            self._direct.shutdown()
        except Exception:  # noqa: BLE001
            pass
        if self._bg_executor is not None:
            self._bg_executor.shutdown(wait=False)
        for c in self._actor_clients.values():
            c.client.close()
        for c in self._raylet_clients.values():
            c.close()
        self.gcs.close()
        self.store.close()
