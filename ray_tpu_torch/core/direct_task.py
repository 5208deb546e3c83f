"""Owner-side worker-lease transport: the fast path for normal tasks.

Equivalent of the reference's direct task transport
(`src/ray/core_worker/transport/direct_task_transport.h:75,151`): instead of
paying a raylet round trip per task, the owner requests a *worker lease*
from the raylet once per scheduling key, then pushes task specs straight to
the leased worker over a direct connection while demand lasts — the raylet
stays in the loop only at lease grant/return granularity, where resource
accounting lives. `OnWorkerIdle` semantics: a drained queue returns the
lease after a short idle window so the worker goes back to the node pool.

Eligibility: plain tasks (no actor, no placement group, no scheduling
strategy) whose ref dependencies are already resolved at the owner.
Everything else — and every retry/failover — takes the classic
submit-to-raylet path, which remains fully capable.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import TaskSpec
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import TaskID
from ray_tpu_torch.core.rpc import ConnectionLost, RpcClient

logger = logging.getLogger(__name__)

LEASE_SPEC_NAME = "__lease__"


def _env_signature(runtime_env: Optional[Dict[str, Any]]) -> str:
    # One hash end to end: lease keys here, the raylet's granted-env
    # marker, and per-env forge templates all agree on what "same
    # runtime environment" means.
    from ray_tpu_torch.core.runtime_env import env_hash
    return env_hash(runtime_env)


class _Lease:
    __slots__ = ("lease_id", "key", "address", "raylet_address", "client",
                 "inflight", "last_used", "closed", "worker_id",
                 "resources", "env_sig")

    def __init__(self, lease_id: bytes, key, address: str,
                 raylet_address: str, worker_id=None,
                 resources: Optional[Dict[str, float]] = None,
                 env_sig: str = ""):
        self.lease_id = lease_id
        self.key = key
        self.address = address
        self.raylet_address = raylet_address
        self.worker_id = worker_id
        # What the raylet actually reserved for this lease — the adoption
        # contract for cross-key reuse (a lease may serve any key whose
        # demand it covers; it never serves one that needs more).
        self.resources: Dict[str, float] = dict(resources or {})
        self.env_sig = env_sig
        self.client: Optional[RpcClient] = None
        self.inflight: set = set()      # task_id bytes pushed, not yet done
        self.last_used = time.monotonic()
        self.closed = False

    def covers(self, resources: Dict[str, float], env_sig: str) -> bool:
        """Can this lease legally run tasks of that shape? The runtime-env
        signature must match exactly (the leased worker was built for it);
        the granted resources must dominate pointwise (over-reservation is
        safe — the raylet accounted for MORE than the task uses)."""
        if env_sig != self.env_sig:
            return False
        return all(self.resources.get(r, 0.0) >= amt
                   for r, amt in resources.items())


class DirectTaskTransport:
    """Per-owner lease cache + pipelined, flush-tick-batched submission."""

    def __init__(self, runtime):
        self._rt = runtime
        self._lock = threading.RLock()
        self._pending: Dict[Tuple, deque] = defaultdict(deque)
        # (resources, runtime_env) of the most recent spec per key: the
        # lease-request template when the local queue is empty but deep
        # pipelines still warrant scale-out. Deliberately NOT the full
        # spec — that would pin function blobs + inline args forever.
        self._last_template: Dict[Tuple, Tuple] = {}
        self._leases: Dict[Tuple, List[_Lease]] = defaultdict(list)
        self._inflight_reqs: Dict[bytes, Tuple] = {}  # req_id -> key
        self._req_spec: Dict[bytes, TaskSpec] = {}    # req_id -> pseudo spec
        self._req_addr: Dict[bytes, str] = {}         # req_id -> raylet addr
        self._task_lease: Dict[bytes, _Lease] = {}    # task_id -> lease
        self._closed = False
        self._reaper: Optional[threading.Thread] = None
        # Flush-tick submission pipeline: submit() enqueues and marks the
        # key dirty; one flusher thread coalesces everything that landed
        # since its last pass into multi-spec frames. Off-path (tick=0):
        # submit() pumps inline on the caller thread, exactly as before.
        self._dirty: set = set()
        self._flush_event = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        # Observability counters (tests + bench assertions).
        self.stats: Dict[str, int] = {
            "lease_requests": 0,   # raylet round trips for new leases
            "lease_steals": 0,     # cross-key warm-lease adoptions
            "batch_frames": 0,     # multi-spec frames sent
            "batched_specs": 0,    # specs that rode a multi-spec frame
            "single_frames": 0,    # one-spec frames sent
            "leases_lost": 0,      # leases invalidated by worker death
            "leases_swept": 0,     # leases dropped by the liveness sweep
        }

    # ------------------------------------------------------------ submission

    def eligible(self, spec: TaskSpec) -> bool:
        if spec.actor_creation or spec.actor_id is not None:
            return False
        if spec.placement_group_id is not None:
            return False
        if spec.scheduling_strategy is not None:
            return False
        for dep in spec.dependencies():
            if not self._dep_ready_local(dep):
                return False
        return True

    def _dep_ready_local(self, dep) -> bool:
        """Cheap owner-local readiness — no GCS round trip. Unresolved or
        remote-unknown deps push the task onto the classic path, where the
        raylet's dependency manager waits for them (and the scheduler's
        data-locality scoring places the task next to large args)."""
        rt = self._rt
        key = dep.binary()
        if key in rt._object_cache:
            return True
        task_key = rt._object_to_task.get(key)
        if task_key is not None:
            rec = rt._tasks.get(task_key)
            if rec is not None:
                if not rec.event.is_set() or rec.error is not None:
                    return False
                for r in rec.results or []:
                    if r["object_id"].binary() == key:
                        # Large store-path results may live on another
                        # node: only bypass the scheduler when the bytes
                        # are inline or already local.
                        return r["kind"] == "inline" \
                            or rt.store.contains(dep)
                return rt.store.contains(dep)
        return rt.store.contains(dep)

    def submit(self, spec: TaskSpec):
        spec.direct = True
        key = (tuple(sorted(spec.resources.items())),
               _env_signature(spec.runtime_env))
        batched = GLOBAL_CONFIG.direct_flush_tick_ms > 0
        with self._lock:
            if self._closed:
                raise ConnectionLost("direct transport closed")
            self._pending[key].append(spec)
            # Keyed by (resources, env-signature) shape — bounded by
            # the workload's distinct task shapes; an entry is two small
            # dicts kept so the pump can keep leases warm post-drain.
            # raylint: disable=RL011 — bounded by distinct task shapes
            self._last_template[key] = (dict(spec.resources),
                                        spec.runtime_env)
            self._ensure_reaper()
            if batched:
                self._dirty.add(key)
                self._ensure_flusher()
        if batched:
            self._flush_event.set()
        else:
            self._pump(key)

    def _schedule_pump(self, key):
        """Request a pump for `key`: via the flusher when the flush-tick
        pipeline is on (completion events mark-dirty instead of scanning
        the lease table inline on the push thread), inline otherwise."""
        if GLOBAL_CONFIG.direct_flush_tick_ms > 0 and not self._closed:
            with self._lock:
                self._dirty.add(key)
                self._ensure_flusher()
            self._flush_event.set()
        else:
            self._pump(key)

    def _ensure_flusher(self):
        # Caller holds self._lock.
        if self._flusher is None and not self._closed:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="direct-submit-flush",
                daemon=True)
            self._flusher.start()

    def _flush_loop(self):
        """One pass = everything that accumulated since the last pass,
        coalesced into one multi-spec frame per lease. The tick is a
        COALESCING window, not a polling period: the loop sleeps on the
        event and wakes on the first enqueue, so an isolated submit pays
        one thread handoff; only bursts wait out the (sub-ms) tick — and
        buy frame density for it."""
        while not self._closed:
            if not self._flush_event.wait(timeout=0.5):
                continue
            self._flush_event.clear()
            tick = GLOBAL_CONFIG.direct_flush_tick_ms / 1000.0
            if tick > 0:
                time.sleep(tick)  # let the burst land behind one pump
                self._flush_event.clear()
            while not self._closed:
                with self._lock:
                    keys = list(self._dirty)
                    self._dirty.clear()
                if not keys:
                    break
                for key in keys:
                    try:
                        self._pump(key)
                    except Exception:  # noqa: BLE001 — one key's failure
                        logger.exception("direct flush pump failed")

    def _pump(self, key):
        """Push pending specs onto idle lease capacity; request more leases
        for the remainder; cancel queued requests demand no longer needs
        (a stale aged request would otherwise reserve the remote node's
        resources for a worker that will sit idle — reference
        `CancelWorkerLease`)."""
        pipeline = GLOBAL_CONFIG.direct_pipeline_depth
        to_send: List[Tuple[_Lease, TaskSpec]] = []
        want_requests = 0
        template: Optional[TaskSpec] = None
        cancel_reqs: List[bytes] = []
        with self._lock:
            pending = self._pending.get(key)
            backlog = len(pending) if pending else 0
            key_reqs = [r for r, k in self._inflight_reqs.items()
                        if k == key]
            if pending:
                leases = [l for l in self._leases.get(key, ())
                          if not l.closed and l.client is not None]
                cap = GLOBAL_CONFIG.direct_max_leases
                # Cross-key warm reuse: a backlogged key adopts another
                # key's IDLE cached lease when the grant covers its shape
                # — the whole GCS/raylet round trip skipped (leases are
                # stolen/rebalanced across keys instead of idling back).
                if GLOBAL_CONFIG.direct_lease_steal:
                    desired_now = min(cap, -(-backlog // max(1, pipeline)))
                    if len(leases) < desired_now:
                        adopted = self._adopt_leases_locked(
                            key, desired_now - len(leases))
                        leases.extend(adopted)
                n_leases = len(leases)
                # Phase 1 — steady state: fill each lease to the base
                # pipeline depth (latency + cross-lease balance).
                for lease in leases:
                    while pending and len(lease.inflight) < pipeline:
                        spec = pending.popleft()
                        lease.inflight.add(spec.task_id.binary())
                        self._task_lease[spec.task_id.binary()] = lease
                        lease.last_used = time.monotonic()
                        to_send.append((lease, spec))
                # Phase 2 — burst deepening, with a RESERVE: keep enough
                # specs pending to seed the leases still obtainable
                # (outstanding requests + headroom to the cap). Absorbed
                # specs can't migrate off a worker's queue, so
                # absorbing everything would both serialize the burst
                # and let the next pump read "demand drained" and
                # cancel the very scale-out requests fanning it out.
                if pending:
                    obtainable = max(0, cap - n_leases)
                    reserve = min(len(pending), obtainable * pipeline)
                    absorb = len(pending) - reserve
                    if absorb > 0 and n_leases:
                        depth = min(
                            GLOBAL_CONFIG.direct_burst_depth_max,
                            max(pipeline,
                                pipeline + (absorb + n_leases - 1)
                                // n_leases))
                        for lease in leases:
                            while pending and absorb > 0 \
                                    and len(lease.inflight) < depth:
                                spec = pending.popleft()
                                absorb -= 1
                                lease.inflight.add(spec.task_id.binary())
                                self._task_lease[spec.task_id.binary()] = \
                                    lease
                                lease.last_used = time.monotonic()
                                to_send.append((lease, spec))
            if backlog:
                # Scale-out sizes from the ORIGINAL backlog at the
                # steady-state pipeline depth.
                n_leases = len(self._leases.get(key, ()))
                cap = GLOBAL_CONFIG.direct_max_leases
                desired = -(-backlog // max(1, pipeline))  # ceil
                want_requests = min(
                    max(len(pending) if pending else 0,
                        desired - n_leases - len(key_reqs)),
                    cap - len(key_reqs) - n_leases)
                if pending:
                    template = (dict(pending[0].resources),
                                pending[0].runtime_env)
                else:
                    template = self._last_template.get(key)
                if template is None:
                    want_requests = 0
            elif key_reqs:
                # Demand drained: withdraw every outstanding request.
                cancel_reqs = key_reqs
                for r in key_reqs:
                    self._inflight_reqs.pop(r, None)
                    self._req_spec.pop(r, None)
        # One framed message per lease per pump: submission bursts would
        # otherwise pay per-task framing + a syscall pair per spec.
        grouped: List[Tuple[_Lease, List[TaskSpec]]] = []
        for lease, spec in to_send:
            if grouped and grouped[-1][0] is lease:
                grouped[-1][1].append(spec)
            else:
                grouped.append((lease, [spec]))
        for lease, specs in grouped:
            self._send_batch(lease, specs)
        for _ in range(max(0, want_requests)):
            self._request_lease(key, *template)
        if cancel_reqs:
            by_addr: Dict[str, List[bytes]] = defaultdict(list)
            with self._lock:
                for r in cancel_reqs:
                    addr = self._req_addr.pop(r, None)
                    by_addr[addr or self._rt.raylet.address].append(r)
            for addr, reqs in by_addr.items():
                try:
                    client = self._rt.raylet \
                        if addr == self._rt.raylet.address \
                        else self._rt._raylet_for(addr)
                    client.call_async("cancel_lease_request",
                                      {"req_ids": reqs})
                except Exception:  # noqa: BLE001 — raylet gone: queue died
                    pass

    def _adopt_leases_locked(self, key, max_n: int) -> List[_Lease]:
        """Steal up to `max_n` idle leases from OTHER keys whose grant
        covers this key's shape (caller holds the lock). The lease is
        re-keyed in place: its worker connection, raylet accounting and
        idle clock all carry over — the new key's first task is one
        framed write away instead of a lease round trip."""
        resources = dict(key[0])
        env_sig = key[1]
        out: List[_Lease] = []
        for other_key, leases in list(self._leases.items()):
            if other_key == key:
                continue
            # Never strip a key that still has queued work of its own.
            if self._pending.get(other_key):
                continue
            for lease in list(leases):
                if len(out) >= max_n:
                    return out
                if lease.closed or lease.client is None or lease.inflight:
                    continue
                if not lease.covers(resources, env_sig):
                    continue
                leases.remove(lease)
                lease.key = key
                lease.last_used = time.monotonic()
                self._leases[key].append(lease)
                self.stats["lease_steals"] += 1
                out.append(lease)
            if not leases:
                self._leases.pop(other_key, None)
        return out

    def _send_batch(self, lease: _Lease, specs: List[TaskSpec]):
        def cb(env, _payload, specs=specs, lease=lease):
            if env.get("_lost") or env.get("e"):
                # Connection-level failures funnel through _on_worker_lost;
                # a remote handler error (shouldn't happen — the handler
                # only enqueues) fails the task(s).
                if env.get("e"):
                    for spec in specs:
                        self._fail_inflight(lease, spec, env["e"])

        try:
            if len(specs) == 1:
                self.stats["single_frames"] += 1
                lease.client.call_async("direct_call", {"spec": specs[0]},
                                        cb)
            else:
                self.stats["batch_frames"] += 1
                self.stats["batched_specs"] += len(specs)
                lease.client.call_async("direct_call_batch",
                                        {"specs": specs}, cb)
        except ConnectionLost:
            self._on_worker_lost(lease)

    def _fail_inflight(self, lease: _Lease, spec: TaskSpec, err: str):
        with self._lock:
            lease.inflight.discard(spec.task_id.binary())
            self._task_lease.pop(spec.task_id.binary(), None)
        self._rt._bg_submit(self._retry_classic, [spec])

    # ---------------------------------------------------------------- leases

    def _request_lease(self, key, resources: Dict[str, float],
                       runtime_env: Optional[Dict[str, Any]]):
        pseudo = TaskSpec(
            task_id=TaskID.for_task(self._rt.job_id),
            job_id=self._rt.job_id,
            name=LEASE_SPEC_NAME,
            function_id=None,
            function_blob=None,
            resources=dict(resources),
            runtime_env=runtime_env,
        )
        req_id = pseudo.task_id.binary()
        with self._lock:
            self._inflight_reqs[req_id] = key
            self._req_spec[req_id] = pseudo
            self.stats["lease_requests"] += 1

        def cb(env, payload, req_id=req_id):
            if env.get("_lost") or env.get("e"):
                self._drop_request(req_id)
                return
            try:
                resp = serialization.loads(payload) if payload else {}
            except Exception:  # noqa: BLE001
                self._drop_request(req_id)
                return
            if resp.get("status") == "spillback":
                self._rt._bg_submit(self._request_remote, req_id,
                                    resp["address"])
            # "pending": the grant arrives as a lease_granted push.

        try:
            self._rt.raylet.call_async(
                "request_worker_lease",
                {"spec": pseudo, "req_id": req_id, "grant_or_reject": False},
                cb)
        except ConnectionLost:
            # Local raylet is gone: no re-pump (it would re-request and
            # recurse forever) — resolve this key's pending tasks to the
            # terminal error instead.
            self._drop_request(req_id, pump=False)
            self._fail_pending(key, "lost connection to raylet")

    def _request_remote(self, req_id: bytes, address: str):
        """Spillback hop: request the lease at the raylet that has room."""
        with self._lock:
            pseudo = self._req_spec.get(req_id)
        if pseudo is None or self._closed:
            return
        for _hop in range(8):
            try:
                client = self._rt._raylet_for(address)
                resp = client.call("request_worker_lease",
                                   {"spec": pseudo, "req_id": req_id,
                                    "grant_or_reject": True}, timeout=30)
            except Exception:  # noqa: BLE001 — target died: retry locally
                self._drop_request(req_id)
                return
            if resp.get("status") == "pending":
                with self._lock:
                    self._req_addr[req_id] = address
                return
            if resp.get("status") == "spillback":
                address = resp["address"]
                continue
            break
        self._drop_request(req_id)

    def _drop_request(self, req_id: bytes, pump: bool = True):
        with self._lock:
            key = self._inflight_reqs.pop(req_id, None)
            self._req_spec.pop(req_id, None)
            self._req_addr.pop(req_id, None)
        if pump and key is not None:
            # Pending work may still need capacity: re-pump (which may
            # re-request) unless leases already cover it.
            self._schedule_pump(key)

    def _fail_pending(self, key, reason: str):
        from ray_tpu_torch.exceptions import RaySystemError

        with self._lock:
            specs = list(self._pending.pop(key, ()))
        blob = None
        for spec in specs:
            rec = self._rt._tasks.get(spec.task_id.binary())
            if rec is None or rec.event.is_set():
                continue
            if blob is None:
                blob = serialization.serialize_exception(
                    RaySystemError(reason))
            self._rt._unpin_deps(spec)
            self._rt._fail_task_record(rec, spec, blob)

    def on_lease_respill(self, spec: TaskSpec):
        """The raylet returned a queued lease request it can't serve."""
        self._drop_request(spec.task_id.binary())

    def on_raylet_lost(self, address: str):
        """A remote raylet died: lease requests queued there are gone —
        drop them so _pump re-requests through live nodes (the task
        failover path covers tasks; this covers the lease half)."""
        with self._lock:
            doomed = [r for r, a in self._req_addr.items() if a == address]
        for req_id in doomed:
            self._drop_request(req_id)

    def on_lease_granted(self, data: Dict[str, Any]):
        """lease_granted push (any raylet's channel). Connecting to the
        worker blocks, so finish on the background executor."""
        self._rt._bg_submit(self._connect_lease, data)

    def _connect_lease(self, data: Dict[str, Any]):
        req_id = data["req_id"]
        with self._lock:
            key = self._inflight_reqs.pop(req_id, None)
            self._req_spec.pop(req_id, None)
            self._req_addr.pop(req_id, None)
            # No point dialing a worker for a drained queue: bounce the
            # grant straight back instead of holding it through the idle
            # window.
            unwanted = self._closed or key is None or \
                (not self._pending.get(key)
                 and not any(len(l.inflight) >= GLOBAL_CONFIG.
                             direct_pipeline_depth
                             for l in self._leases.get(key, ())))
        if unwanted:
            self._return_lease_rpc(data["raylet_address"], data["lease_id"])
            return
        lease = _Lease(data["lease_id"], key, data["address"],
                       data["raylet_address"], data.get("worker_id"),
                       resources=dict(key[0]), env_sig=key[1])
        try:
            lease.client = RpcClient(
                data["address"], name=f"lease-{data['lease_id'].hex()[:8]}",
                push_handler=lambda m, d: self._on_worker_push(lease, m, d),
                on_close=lambda: self._on_worker_lost(lease))
        except Exception:  # noqa: BLE001 — worker died before we dialed
            self._return_lease_rpc(data["raylet_address"], data["lease_id"])
            self._pump(key)
            return
        with self._lock:
            if self._closed:
                lease.closed = True
        if lease.closed:
            lease.client.close()
            self._return_lease_rpc(data["raylet_address"], data["lease_id"])
            return
        with self._lock:
            self._leases[key].append(lease)
        self._pump(key)

    def _on_worker_push(self, lease: _Lease, method: str, data: Any):
        if method == "task_result":
            tid = data["task_id"].binary()
            with self._lock:
                lease.inflight.discard(tid)
                self._task_lease.pop(tid, None)
                lease.last_used = time.monotonic()
            self._rt._on_raylet_push(method, data)
            self._schedule_pump(lease.key)
            return
        if method == "task_result_batch":
            # Coalesced completions: the worker buffered results while
            # more of our tasks sat queued behind them — one frame, one
            # wakeup, one pump for the whole batch.
            batch = data["batch"]
            with self._lock:
                for item in batch:
                    tid = item["task_id"].binary()
                    lease.inflight.discard(tid)
                    self._task_lease.pop(tid, None)
                lease.last_used = time.monotonic()
            for item in batch:
                self._rt._on_raylet_push("task_result", item)
            self._schedule_pump(lease.key)
            return
        self._rt._on_raylet_push(method, data)

    def _on_worker_lost(self, lease: _Lease, swept: bool = False):
        """Leased worker connection dropped (crash or kill): invalidate
        the cached lease and re-route its in-flight tasks through the
        classic path, honoring retry budgets. This is the lease-cache
        invalidation death hook (raylint RL012): every structure caching
        this worker's address is purged here. `swept` marks a death the
        anti-entropy sweep caught rather than the on-close hook — the
        two stats stay disjoint so their sum counts invalidations."""
        with self._lock:
            if lease.closed:
                return
            lease.closed = True
            self.stats["leases_swept" if swept else "leases_lost"] += 1
            leases = self._leases.get(lease.key)
            if leases and lease in leases:
                leases.remove(lease)
            inflight = list(lease.inflight)
            lease.inflight.clear()
            specs = []
            for tid in inflight:
                self._task_lease.pop(tid, None)
                rec = self._rt._tasks.get(tid)
                if rec is not None and rec.spec is not None \
                        and not rec.event.is_set():
                    specs.append(rec.spec)
        if specs:
            self._rt._bg_submit(self._retry_classic, specs)
        self._schedule_pump(lease.key)

    def _retry_classic(self, specs: List[TaskSpec]):
        """Failover: resubmit via the raylet, counting the attempt against
        the task's retry budget (mirrors runtime._failover_tasks)."""
        from ray_tpu_torch.exceptions import WorkerCrashedError

        for spec in specs:
            rec = self._rt._tasks.get(spec.task_id.binary())
            if rec is None or rec.event.is_set():
                continue
            rec.attempts += 1
            if rec.attempts > spec.max_retries:
                self._rt._fail_task_record(
                    rec, spec, serialization.serialize_exception(
                        WorkerCrashedError(
                            f"Worker died while running {spec.name} "
                            f"(max_retries={spec.max_retries} exhausted)"),
                        spec.name))
                continue
            try:
                self._rt._submit_spec(spec)
            except Exception as e:  # noqa: BLE001
                self._rt._fail_task_record(
                    rec, spec, serialization.serialize_exception(
                        WorkerCrashedError(
                            f"failover resubmit failed: {e}"), spec.name))

    def _return_lease_rpc(self, raylet_address: str, lease_id: bytes):
        try:
            self._rt._raylet_for(raylet_address).call_async(
                "return_worker_lease", {"lease_id": lease_id})
        except Exception:  # noqa: BLE001 — raylet gone: lease dies with it
            pass

    # ---------------------------------------------------------------- cancel

    def cancel(self, task_id, force: bool = False) -> bool:
        """True if the task was under this transport's control (pending or
        in flight on a lease) and a cancel was initiated."""
        tid = task_id.binary()
        with self._lock:
            for key, pending in self._pending.items():
                for spec in pending:
                    if spec.task_id.binary() == tid:
                        pending.remove(spec)
                        self._cancel_pending(spec)
                        return True
            lease = self._task_lease.get(tid)
        if lease is None:
            return False
        if force and lease.worker_id is not None:
            # force=True must actually stop an uninterruptible task: kill
            # the leased worker (classic-path parity — the raylet's force
            # cancel kills too). Resolve the record FIRST so the lease-loss
            # failover doesn't resubmit the task we're killing.
            rec = self._rt._tasks.get(tid)
            if rec is not None and rec.spec is not None:
                self._cancel_pending(rec.spec)
            try:
                self._rt._raylet_for(lease.raylet_address).call_async(
                    "kill_worker", {"worker_id": lease.worker_id})
            except Exception:  # noqa: BLE001 — raylet gone: worker is too
                pass
            return True
        if lease.client is not None:
            try:
                lease.client.call_async("cancel_direct", {"task_id": task_id})
            except ConnectionLost:
                pass
            return True
        return False

    def _cancel_pending(self, spec: TaskSpec):
        from ray_tpu_torch.exceptions import TaskCancelledError

        rec = self._rt._tasks.get(spec.task_id.binary())
        if rec is not None and not rec.event.is_set():
            self._rt._unpin_deps(spec)
            self._rt._fail_task_record(
                rec, spec, serialization.serialize_exception(
                    TaskCancelledError(spec.task_id), spec.name))

    # ------------------------------------------------------------- lifecycle

    def _ensure_reaper(self):
        if self._reaper is None and not self._closed:
            self._reaper = threading.Thread(target=self._reaper_loop,
                                            name="lease-reaper", daemon=True)
            self._reaper.start()

    def _reaper_loop(self):
        """Return leases that sat idle past the timeout (reference:
        worker lease released on idle, direct_task_transport.h:151) —
        after offering each to a backlogged compatible key (rebalance
        beats a return-then-re-request round trip). Also the anti-entropy
        liveness sweep for the lease cache: a cached lease whose worker
        connection is dead gets the full invalidation path even if the
        on_close hook was somehow missed (raylint RL012 sweep evidence)."""
        idle_s = GLOBAL_CONFIG.direct_lease_idle_s
        while not self._closed:
            time.sleep(min(0.5, idle_s / 2))
            now = time.monotonic()
            to_return: List[_Lease] = []
            dead: List[_Lease] = []
            rebalanced: set = set()
            with self._lock:
                for key, leases in list(self._leases.items()):
                    for lease in list(leases):
                        if not lease.closed and lease.client is not None \
                                and lease.client.is_closed:
                            dead.append(lease)
                    if self._pending.get(key):
                        continue
                    for lease in list(leases):
                        if lease.inflight or lease.closed \
                                or now - lease.last_used <= idle_s:
                            continue
                        if GLOBAL_CONFIG.direct_lease_steal:
                            # Idle-return vs steal: a starving key takes
                            # the lease instead of the raylet.
                            target = next(
                                (k for k, pend in self._pending.items()
                                 if pend and k != key
                                 and lease.covers(dict(k[0]), k[1])), None)
                            if target is not None:
                                leases.remove(lease)
                                lease.key = target
                                lease.last_used = now
                                self._leases[target].append(lease)
                                self.stats["lease_steals"] += 1
                                rebalanced.add(target)
                                continue
                        lease.closed = True
                        leases.remove(lease)
                        to_return.append(lease)
            for lease in dead:
                self._on_worker_lost(lease, swept=True)
            for key in rebalanced:
                self._schedule_pump(key)
            for lease in to_return:
                if lease.client is not None:
                    lease.client.close()
                self._return_lease_rpc(lease.raylet_address, lease.lease_id)

    def shutdown(self):
        with self._lock:
            self._closed = True
            leases = [l for ls in self._leases.values() for l in ls]
            self._leases.clear()
            self._pending.clear()
            self._dirty.clear()
        self._flush_event.set()  # unpark the flusher so it observes closed
        for lease in leases:
            lease.closed = True
            if lease.client is not None:
                lease.client.close()
            # Synchronous return: an async send racing the runtime's
            # connection teardown looks like a dead lease holder to the
            # raylet, which would kill the (reusable) worker.
            try:
                self._rt._raylet_for(lease.raylet_address).call(
                    "return_worker_lease", {"lease_id": lease.lease_id},
                    timeout=2)
            except Exception:  # noqa: BLE001
                pass
