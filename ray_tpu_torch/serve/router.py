"""Client-side router: replica choice + per-replica admission control.

Equivalent of the reference's `Router`/`ReplicaSet.assign_replica`
(`serve/_private/router.py:274,227`): keeps a local snapshot of the
controller's routing table (pushed via a background long-poll thread —
never polled per-request; the controller piggybacks replica placement
and queue depths on the same push), prefers a co-located replica with
headroom and otherwise picks by power-of-two-choices over local
in-flight + pushed depth, and blocks when all replicas are saturated.
Scale-to-zero deployments appear as `parked` entries; routing to one
fires a throttled wake RPC and waits for the cold-started replica to be
pushed into the table.
In-flight counts are decremented by a reaper thread that waits on the
outstanding ObjectRefs — the framework has no future callbacks by design
(completion events ride the worker push channel), so one thread per router
amortizes completion tracking across all requests.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)


class Router:
    UNKNOWN_GRACE_S = 5.0  # deploy-in-progress grace before KeyError
    WAKE_THROTTLE_S = 0.5  # min gap between wake RPCs per deployment

    def __init__(self, controller_handle, poll_timeout_s: float = 5.0):
        self._controller = controller_handle
        self._poll_timeout_s = poll_timeout_s
        self._lock = threading.Condition()
        # Locality: this process's node (lazy — resolving it needs a live
        # runtime) so _pick can prefer co-located replicas.
        self._local_node: Optional[str] = None
        # Scale-to-zero wake throttling: deployment -> last wake monotonic.
        self._last_wake: Dict[str, float] = {}
        # Threads parked in assign()'s backpressure wait. notify_all costs
        # two context switches per call; at proxy request rates an
        # unconditional notify in release() measurably taxes the hot path,
        # so completions only notify when someone is actually waiting.
        self._waiters = 0
        self._version = -1
        self._table: Dict[str, dict] = {}
        # replica_id -> local in-flight count
        self._inflight: Dict[str, int] = {}
        # outstanding ref -> replica_id (reaped for decrements)
        self._outstanding: Dict[object, str] = {}
        self._stopped = False
        self._poller = threading.Thread(
            target=self._poll_loop, name="serve-router-poll", daemon=True)
        self._reaper = threading.Thread(
            target=self._reap_loop, name="serve-router-reap", daemon=True)
        self._started = False
        self._start_lock = threading.Lock()

    def _ensure_started(self):
        # The router is process-global (handle.py), so first use can race
        # across threads: only one may start the background threads, and
        # latecomers must wait for the synchronous first table fetch.
        with self._start_lock:
            if not self._started:
                # Synchronous first fetch so the first request sees a table.
                self._refresh_once(timeout=10.0)
                self._poller.start()
                self._reaper.start()
                self._started = True

    def stop(self):
        self._stopped = True

    # ------------------------------------------------------------- routing

    def assign(self, deployment: str, method_name: str, args, kwargs,
               timeout_s: Optional[float] = None):
        """Pick a replica and submit; returns the ObjectRef. Blocks while
        every replica is at max_concurrent_queries (backpressure)."""
        self._ensure_started()
        start = time.monotonic()
        deadline = None if timeout_s is None else start + timeout_s
        with self._lock:
            while True:
                entry = self._table.get(deployment)
                choice = self._reserve_locked(entry)
                if choice is not None:
                    replica_id, handle = choice[0], choice[1]
                    break
                if entry is not None and not entry["replicas"] \
                        and entry.get("parked"):
                    # Scale-to-zero: ask the controller for a replica
                    # (throttled, off-thread — never an RPC under the
                    # router lock) and keep waiting for the table push.
                    self.wake(deployment)
                # A name absent from the table is (after a short grace for
                # an in-progress deploy) an error, not backpressure — don't
                # park forever on a typo.
                if entry is None and \
                        time.monotonic() - start > self.UNKNOWN_GRACE_S:
                    raise KeyError(
                        f"no deployment named {deployment!r} "
                        f"(known: {sorted(self._table)})")
                # No replicas yet or all saturated: wait for a table change
                # or a completion (reaper notifies).
                wait_t = 1.0
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"no replica of {deployment!r} available within "
                            f"{timeout_s}s")
                    wait_t = min(wait_t, remaining)
                self._waiters += 1
                try:
                    self._lock.wait(timeout=wait_t)
                finally:
                    self._waiters -= 1
        return self._submit(handle, replica_id, method_name, args, kwargs)

    def try_assign(self, deployment: str, method_name: str, args, kwargs):
        """Non-blocking assign: submit iff a replica has headroom right
        now, else None (caller falls back to the blocking path). Lets an
        event loop dispatch without an executor hop in the common
        unsaturated case."""
        if not self._started:
            return None
        with self._lock:
            choice = self._reserve_locked(self._table.get(deployment))
        if choice is None:
            return None
        replica_id, handle = choice[0], choice[1]
        return self._submit(handle, replica_id, method_name, args, kwargs)

    def reserve(self, deployment: str) -> Optional[Tuple[str, object]]:
        """Non-blocking admission: count an in-flight slot on a replica
        with headroom and return (replica_id, handle), or None when
        saturated/unknown. The caller OWNS the slot and must call
        release() when its request completes — used by transports that
        bypass _submit/ObjectRefs (the proxy's light lane)."""
        choice = self.reserve_fast(deployment)
        if choice is None:
            return None
        return choice[0], choice[1]

    def reserve_fast(self, deployment: str, exclude: Optional[set] = None,
                     model_id: Optional[str] = None
                     ) -> Optional[Tuple[str, object, bool]]:
        """reserve() for the raw fast lane: returns (replica_id, handle,
        colocated) — `colocated` reports whether the locality-first pick
        landed on this process's node. `exclude` skips replicas the
        caller just lost a frame to (the retry-once path). `model_id`
        steers multiplexed deployments toward a replica that already
        holds that adapter (table-pushed residency)."""
        if not self._started:
            return None
        with self._lock:
            return self._reserve_locked(self._table.get(deployment),
                                        exclude or (), model_id)

    def deployment_state(self, deployment: str) -> str:
        """Coarse state for the fast lane's no-replica handling:
        "unknown" (not in the table), "parked" (scale-to-zero, waiting
        for a cold start), or "active"."""
        with self._lock:
            entry = self._table.get(deployment)
        if entry is None:
            return "unknown"
        if not entry["replicas"] and entry.get("parked"):
            return "parked"
        return "active"

    def has_replicas(self, deployment: str) -> bool:
        """Cheap routable-replica probe (the fast lane's cold-start wait
        polls this on the event loop — it must hold no thread)."""
        with self._lock:
            entry = self._table.get(deployment)
            return bool(entry and entry["replicas"])

    def live_replica_ids(self) -> set:
        with self._lock:
            return {rid for entry in self._table.values()
                    for rid, _ in entry.get("replicas", ())}

    def live_tenants(self) -> set:
        """Tenant names referenced by the current table (the proxy's
        admission registry prunes against this on version changes)."""
        with self._lock:
            return {entry["tenant"] for entry in self._table.values()
                    if entry.get("tenant")}

    def entry_snapshot(self, deployment: str) -> Optional[dict]:
        """The deployment's current table entry (immutable once pushed —
        the controller publishes fresh dicts and the router swaps whole
        tables per version, so returning the reference is safe)."""
        with self._lock:
            return self._table.get(deployment)

    def wake(self, deployment: str) -> None:
        """Nudge the controller to cold-start a parked deployment.
        Throttled per deployment and fired from a one-shot thread: the
        actor submit may block resolving the controller connection, and
        callers hold the router lock or sit on an event loop."""
        now = time.monotonic()
        last = self._last_wake.get(deployment, 0.0)
        if now - last < self.WAKE_THROTTLE_S:
            return
        self._last_wake[deployment] = now

        def fire():
            try:
                self._controller.wake_deployment.remote(deployment)
            except Exception:  # noqa: BLE001 — next throttled wake retries
                logger.debug("serve: wake of %s failed", deployment,
                             exc_info=True)

        threading.Thread(target=fire, name="serve-wake", daemon=True).start()

    def release(self, replica_id: str):
        """Return a slot taken with reserve()."""
        with self._lock:
            self._dec_inflight_locked(replica_id)
            if self._waiters:
                self._lock.notify_all()

    def _dec_inflight_locked(self, replica_id: str) -> None:
        # Entries vanish at zero instead of lingering at 0: replica ids
        # churn forever under autoscaling, and a dict keyed by every
        # replica that ever existed is exactly the unbounded-keyed-state
        # leak RL011 hunts.
        n = self._inflight.get(replica_id, 0) - 1
        if n > 0:
            self._inflight[replica_id] = n
        else:
            self._inflight.pop(replica_id, None)

    def _reserve_locked(self, entry, exclude=(), model_id=None):
        """Pick a replica with headroom and count the in-flight slot —
        the single admission-accounting point for every assign path."""
        if not entry or not entry["replicas"]:
            return None
        choice = self._pick(entry, exclude, model_id)
        if choice is None:
            return None
        replica_id = choice[0]
        self._inflight[replica_id] = self._inflight.get(replica_id, 0) + 1
        return choice

    def _submit(self, handle, replica_id: str, method_name: str, args,
                kwargs):
        if method_name == "__serve_http__":
            # Reserved sentinel for the replica-level HTTP entry point
            # (dunder so it can't shadow a user deployment method).
            ref = handle.handle_http.remote(*args)
        else:
            ref = handle.handle_request.remote(method_name, args, kwargs)
        with self._lock:
            self._outstanding[ref] = replica_id
        return ref

    def replica_for_stream(self, deployment: str, sid: str):
        """Resolve the replica actor handle a stream id points back to
        (stream ids are '<replica_id>:<seq>'); None once the replica has
        left the routing table."""
        replica_id = sid.rsplit(":", 1)[0]
        with self._lock:
            entry = self._table.get(deployment)
            for rid, handle in (entry or {}).get("replicas", ()):
                if rid == replica_id:
                    return handle
        return None

    def _local_node_hex(self) -> Optional[str]:
        if self._local_node is None:
            try:
                import ray_tpu_torch

                rt = ray_tpu_torch._global_runtime
                if rt is not None and rt.node_id is not None:
                    self._local_node = rt.node_id.hex()
            except Exception:  # noqa: BLE001 — no runtime (unit tests)
                pass
            if self._local_node is None:
                self._local_node = ""  # resolved-and-absent: don't retry
        return self._local_node or None

    def _pick(self, entry: dict, exclude=(), model_id=None
              ) -> Optional[Tuple[str, object, bool]]:
        """Replica choice: adapter affinity, then locality, then
        power-of-two-choices.

        For a multiplexed deployment with a request `model_id`, replicas
        already holding that adapter (per the table-pushed residency map)
        are preferred — routing a hot adapter's traffic to a cold replica
        costs that replica a load (and possibly an LRU eviction of
        someone else's adapter). A co-located replica (same node as this
        router, per the table's pushed placement map) with headroom wins
        within the preferred set — that request skips the network
        entirely. Otherwise two random candidates are compared by local
        in-flight + the controller-pushed queue depth (stale by at most
        the health-check cadence; the local in-flight half is exact) and
        the lighter one is picked — the classic p2c bound on max load
        without scanning every replica under the lock. Only RUNNING
        replicas ever appear in the table, so DEAD and draining replicas
        are structurally unroutable here."""
        limit = entry["max_concurrent_queries"]
        nodes = entry.get("nodes") or {}
        depths = entry.get("depths") or {}
        replicas = entry["replicas"]
        if model_id is not None:
            residency = entry.get("adapters") or {}
            holders = [(rid, h) for rid, h in replicas
                       if rid not in exclude
                       and model_id in residency.get(rid, ())
                       and self._inflight.get(rid, 0) < limit]
            if holders:
                replicas = holders
        local = self._local_node_hex() if nodes else None
        co_best, co_load = None, None
        candidates = []
        for replica_id, handle in replicas:
            if replica_id in exclude:
                continue
            load = self._inflight.get(replica_id, 0)
            if load >= limit:
                continue
            if local is not None and nodes.get(replica_id) == local:
                # Pack-first among co-located replicas: the MOST loaded
                # one that still has headroom. Requests concentrating on
                # one replica coalesce into bigger frames (and bigger
                # @serve.batch gangs); admission spills to the next
                # replica only at max_concurrent_queries, which bounds
                # the latency cost.
                if co_load is None or load > co_load:
                    co_best, co_load = (replica_id, handle), load
            else:
                candidates.append((replica_id, handle, load))
        if co_best is not None:
            return co_best[0], co_best[1], True
        if not candidates:
            return None
        if len(candidates) == 1:
            replica_id, handle, _ = candidates[0]
            return replica_id, handle, False
        i = random.randrange(len(candidates))
        j = random.randrange(len(candidates) - 1)
        if j >= i:
            j += 1
        a, b = candidates[i], candidates[j]
        pick = a if (a[2] + depths.get(a[0], 0)
                     <= b[2] + depths.get(b[0], 0)) else b
        return pick[0], pick[1], False

    # ------------------------------------------------------- background IO

    def _refresh_once(self, timeout: float):
        import ray_tpu_torch

        try:
            version, table = ray_tpu_torch.get(
                self._controller.listen_for_change.remote(
                    self._version, self._poll_timeout_s),
                timeout=timeout)
        except Exception:  # noqa: BLE001 — controller busy/briefly down
            return
        with self._lock:
            if version != self._version:
                self._version = version
                self._table = table
                # Wake-throttle entries are keyed by deployment name:
                # prune against the fresh table so deleted deployments
                # don't accumulate here forever (RL011 discipline).
                for dep in list(self._last_wake):
                    if dep not in table:
                        self._last_wake.pop(dep, None)
                self._lock.notify_all()

    def _poll_loop(self):
        while not self._stopped:
            self._refresh_once(timeout=self._poll_timeout_s + 10.0)

    def _reap_loop(self):
        import ray_tpu_torch

        while not self._stopped:
            with self._lock:
                refs = list(self._outstanding.keys())
            if not refs:
                with self._lock:
                    self._lock.wait(timeout=0.05)
                continue
            try:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=0.05)
            except Exception:  # noqa: BLE001
                continue
            if ready:
                with self._lock:
                    for ref in ready:
                        replica_id = self._outstanding.pop(ref, None)
                        if replica_id is not None:
                            self._dec_inflight_locked(replica_id)
                    if self._waiters:
                        self._lock.notify_all()
