"""Serve controller: the reconcile loop that owns deployment state.

Equivalent of the reference's `ServeController` (`serve/controller.py:75`)
+ `DeploymentState` (`_private/deployment_state.py:1037`): a named async
actor holding desired deployment specs, reconciling actual replica actors
toward them (spawn / drain+kill / replace-on-failed-health-check), applying
the queue-depth autoscaling policy, and long-poll-pushing a versioned
routing table to routers (`_private/long_poll.py` equivalent via an
asyncio.Condition — our actor RPC already multiplexes concurrent method
calls onto the replica's asyncio loop, so a parked long-poll costs one
coroutine, not a thread).

All blocking cluster calls (ray_tpu_torch.get/wait) run in the default executor
so the reconcile loop never stalls the actor's event loop.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.chaos.deadline import TransitionWatch
from ray_tpu_torch.serve.config import (
    REPLICA_RUNNING,
    REPLICA_STARTING,
    DeploymentConfig,
)
from ray_tpu_torch.tenancy.registry import TenantSpec

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"
SERVE_NAMESPACE = "serve"


def _user_config_changed(old: Any, new: Any) -> bool:
    """Equality with array-friendly semantics: identical object or a
    cleanly-True comparison means unchanged; anything ambiguous (numpy
    arrays raise on bool()) counts as changed."""
    if old is new:
        return False
    try:
        return not bool(old == new)
    except Exception:  # noqa: BLE001 — ambiguous equality: assume changed
        return True


class _ReplicaInfo:
    def __init__(self, handle, replica_id: str):
        self.handle = handle
        self.replica_id = replica_id
        self.state = REPLICA_STARTING
        self.last_ongoing = 0
        self.started_at = time.time()
        # Last user_config version pushed to this replica (0 = never).
        self.user_config_version = 0
        # Placement, reported by the replica's ping: published in the
        # routing table so routers can prefer co-located replicas.
        self.node_hex = ""
        # Sharded replica groups: the gang behind this logical replica
        # (None for plain single-actor replicas). `handle` is rank 0 —
        # the only endpoint routers ever see; lifecycle ops (ping
        # promotion, health check, stop) treat the gang as one unit.
        self.group = None
        # Model-multiplexed replicas: resident adapter ids, reported by
        # the replica's health stats and pushed in the routing table so
        # routers can prefer replicas that already hold an adapter.
        self.adapters: List[str] = []


class _DeploymentInfo:
    def __init__(self, user_cls, init_args, init_kwargs,
                 config: DeploymentConfig):
        self.user_cls = user_cls
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.config = config
        self.replicas: List[_ReplicaInfo] = []
        self.target = config.initial_replicas()
        self.next_replica_seq = 0
        # Checkpoint blob cache: cloudpickle of (cls, args, kwargs, cfg)
        # is invariant between deploys, and re-pickling it for every one
        # of a model zoo's deployments on every replica-set change made
        # checkpointing O(deployments^2) across a zoo bring-up.
        # Invalidated by deploy().
        self.ckpt_blob: Optional[bytes] = None
        # Weight/config broadcast plane: the user_config payload is put in
        # the object store ONCE per version; replicas receive the REF, so
        # N replicas pulling a big payload concurrently form a transfer
        # tree instead of N pickled copies through this actor.
        self.user_config_version = 1 if config.user_config is not None else 0
        self.user_config_ref = None
        # Autoscaling bookkeeping: when pressure/idleness began.
        self.pressure_since: Optional[float] = None
        self.idle_since: Optional[float] = None
        self.last_health_check = 0.0
        # Scale-to-zero: when the last router wake arrived (downscale
        # hysteresis), when the in-flight cold start began, and the last
        # measured cold-start latency (wake -> first RUNNING replica).
        self.last_wake_at = 0.0
        self.cold_start_t0: Optional[float] = None
        self.last_cold_start_ms: Optional[float] = None


class ServeController:
    """Async actor; create with max_concurrency >> 1 (long-polls park)."""

    CKPT_KEY = b"serve:controller_ckpt"

    # Anti-entropy sweep width: each tick additionally scans ~1/N of the
    # parked (inactive) deployments, so a lost dirty mark heals within N
    # ticks while a 200-deployment zoo still costs ~nothing per tick.
    ANTI_ENTROPY_SHARDS = 16

    def __init__(self):
        self._deployments: Dict[str, _DeploymentInfo] = {}
        self._version = 0
        self._routing_table: Dict[str, Any] = {}
        self._shutdown = False
        self._change: Optional[asyncio.Condition] = None
        # Multi-tenant QoS registry (docs/MULTITENANCY.md): named tenants
        # with tier/weight/quotas. Checkpointed with the controller;
        # pushed to proxies inside each owned deployment's routing-table
        # entry. qos_version is PER TENANT (stamped from one monotonic
        # counter): proxies rebuild a tenant's token bucket only when
        # THAT tenant's spec changed — a global version would hand every
        # tenant a full burst of fresh tokens each time any unrelated
        # tenant registered.
        self._tenants: Dict[str, TenantSpec] = {}
        self._tenant_versions: Dict[str, int] = {}
        self._tenant_version = 1
        # Sharded reconciler state: reconcile scans the ACTIVE set (any
        # replicas, nonzero target, or a cold start in flight) plus
        # explicitly DIRTIED names (deploy/delete/wake) plus a rotating
        # anti-entropy shard of the parked majority — tick cost scales
        # with live work, not with how many deployments exist.
        self._dirty: set = set()
        self._active: set = set()
        self._parked_cursor = 0
        self._reconcile_stats: Dict[str, Any] = {
            "ticks": 0, "last_tick_ms": 0.0, "last_scanned": 0,
            "last_parked_skipped": 0, "deployments": 0}
        # Per-node proxy management (reference http_state.py:110): set via
        # set_proxy_config; reconcile keeps one proxy per alive node.
        self._proxy_cfg: Optional[Dict[str, Any]] = None
        self._proxies: Dict[str, Any] = {}   # node hex -> proxy handle
        # Checkpoint IO: one writer thread owns every KV round trip, so no
        # lock is ever held across the RPC (raylint RL002 — the old design
        # issued kv_put under _ckpt_lock, letting a slow GCS hold the
        # teardown path, which shares the lock, hostage for the full RPC
        # timeout). Ordering is latest-wins: a monotonic sequence taken on
        # the loop thread plus a single pending slot — an older payload can
        # never overwrite a newer one because the writer only ever sees the
        # newest snapshot.
        self._ckpt_seq = 0
        self._ckpt_written = 0
        self._ckpt_attempted = 0  # last seq the writer finished (ok or not)
        self._ckpt_lock = threading.Lock()
        self._ckpt_cond = threading.Condition(self._ckpt_lock)
        self._ckpt_pending: Optional[tuple] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        # Writer liveness, flipped ONLY under _ckpt_cond: Thread.is_alive()
        # stays True while the loop is unwinding after it decided to exit,
        # so an enqueue racing that window would see a "live" writer that
        # will never drain its payload.
        self._ckpt_writer_alive = False
        # Recovery-deadline enforcement (chaos_recovery_deadline_s):
        # replica STARTING phases and deployment convergence are tracked
        # transitions — any of them stuck past the deadline fails loudly
        # (attributed critical log + forced replacement + counter in
        # status()) instead of quietly retrying forever. Driven only from
        # the reconcile loop (TransitionWatch is single-threaded).
        self._transitions = TransitionWatch("serve-controller")

    # ------------------------------------------------- checkpoint/recovery

    def _kv(self):
        import ray_tpu_torch

        return ray_tpu_torch._require_runtime().gcs

    def _checkpoint(self) -> None:
        """Durable control-plane state in the GCS KV (reference
        controller.py:75 + kv_store.py:24): enough to rebuild deployments
        and re-adopt live named replicas after a controller crash. The
        snapshot is built on the calling (loop) thread — cheap — but the
        blocking KV round trip runs off-loop so deploys and long-polls
        never stall behind a slow GCS."""
        import pickle

        import cloudpickle

        import dataclasses

        state = {}
        for name, info in self._deployments.items():
            # user_config may be a multi-GB weight pytree (that's the
            # point of the ref-broadcast path) — never re-pickle it into
            # every checkpoint. Post-crash, surviving replicas keep their
            # applied config; pushing it to NEW replicas requires a
            # redeploy (restore() zeroes the version accordingly).
            if info.ckpt_blob is None:
                cfg = info.config
                if cfg.user_config is not None:
                    cfg = dataclasses.replace(cfg, user_config=None)
                info.ckpt_blob = cloudpickle.dumps(
                    (info.user_cls, info.init_args, info.init_kwargs, cfg))
            state[name] = {
                "blob": info.ckpt_blob,
                "target": info.target,
                "next_replica_seq": info.next_replica_seq,
                # Groups are never re-adopted (a gang with a dead owner
                # restarts as a unit); their descriptions are kept so
                # restore can kill stale rank actors and release the pg.
                "replica_ids": [r.replica_id for r in info.replicas
                                if r.group is None],
                "groups": [r.group.describe() for r in info.replicas
                           if r.group is not None],
            }
        payload = pickle.dumps(
            {"deployments": state, "proxy_cfg": self._proxy_cfg,
             "tenants": {n: s.qos() for n, s in self._tenants.items()},
             "tenant_versions": dict(self._tenant_versions),
             "tenant_version": self._tenant_version})
        self._enqueue_ckpt(payload)

    def _enqueue_ckpt(self, payload: Optional[bytes]) -> int:
        """Queue one checkpoint write (None = delete) for the writer
        thread; only the newest snapshot is kept. Returns its sequence
        number so callers can wait for durability."""
        with self._ckpt_cond:
            self._ckpt_seq += 1
            seq = self._ckpt_seq
            self._ckpt_pending = (seq, payload)
            if not self._ckpt_writer_alive:
                self._ckpt_writer_alive = True
                thread = threading.Thread(
                    target=self._ckpt_writer_loop, name="serve-ckpt",
                    daemon=True)
                try:
                    thread.start()
                except BaseException:
                    # start() can fail under thread exhaustion; leaving
                    # alive=True would wedge checkpointing forever (every
                    # later enqueue would see a "live" writer that does
                    # not exist).
                    self._ckpt_writer_alive = False
                    raise
                self._ckpt_thread = thread
            self._ckpt_cond.notify_all()
        return seq

    def _ckpt_writer_loop(self) -> None:
        """Single checkpoint writer: drains the pending slot and issues
        the KV RPC with no lock held — deploys, long-polls and teardown
        never stall behind a slow GCS."""
        try:
            self._ckpt_writer_run()
        finally:
            # Normally the clean-exit path below already flipped this
            # under the cond; the finally covers anything else escaping
            # the loop (e.g. KeyboardInterrupt delivered to this thread)
            # so a dead writer can never keep alive=True and silently
            # stop all future checkpoints. Identity-guarded: after a
            # clean exit a NEW writer may already be registered, and its
            # liveness must not be clobbered by the old thread's unwind.
            with self._ckpt_cond:
                if self._ckpt_thread is threading.current_thread():
                    self._ckpt_writer_alive = False
                    self._ckpt_cond.notify_all()

    def _ckpt_writer_run(self) -> None:
        while True:
            with self._ckpt_cond:
                while self._ckpt_pending is None:
                    if self._shutdown:
                        # Exit decision and liveness flip are atomic under
                        # the cond: a concurrent enqueue either saw
                        # alive=True and its payload is in the pending slot
                        # we just checked, or sees False and starts a
                        # fresh writer.
                        self._ckpt_writer_alive = False
                        return
                    self._ckpt_cond.wait(timeout=1.0)
                seq, payload = self._ckpt_pending
                self._ckpt_pending = None
                if seq <= self._ckpt_written:
                    continue
            try:
                if payload is None:
                    self._kv().call("kv_del", {"key": self.CKPT_KEY})
                else:
                    self._kv().call("kv_put", {"key": self.CKPT_KEY,
                                               "value": payload})
            except Exception:  # noqa: BLE001 — best effort; next change retries
                logger.warning("serve: controller checkpoint failed",
                               exc_info=True)
                with self._ckpt_cond:
                    # Record the attempt and wake waiters even on failure:
                    # _drop_checkpoint's bounded wait must return as soon
                    # as the outcome is known, not burn its full timeout
                    # against a fast-failing (dead) GCS.
                    if seq > self._ckpt_attempted:
                        self._ckpt_attempted = seq
                    self._ckpt_cond.notify_all()
                continue
            with self._ckpt_cond:
                if seq > self._ckpt_written:
                    self._ckpt_written = seq
                if seq > self._ckpt_attempted:
                    self._ckpt_attempted = seq
                self._ckpt_cond.notify_all()

    async def restore(self) -> bool:
        """Rebuild state from the KV checkpoint after a controller death:
        re-adopt replicas that survived (they are detached-named actors),
        let reconcile respawn the rest. Returns True if state was found."""
        import pickle

        import ray_tpu_torch

        try:
            value = self._kv().call("kv_get",
                                    {"key": self.CKPT_KEY})["value"]
        except Exception:  # noqa: BLE001
            return False
        if not value:
            return False
        snap = pickle.loads(value)
        import cloudpickle

        self._tenants = {
            name: TenantSpec(**qos)
            for name, qos in (snap.get("tenants") or {}).items()}
        self._tenant_versions = dict(snap.get("tenant_versions") or {})
        self._tenant_version = snap.get("tenant_version", 1)
        for name, rec in snap.get("deployments", {}).items():
            user_cls, init_args, init_kwargs, config = cloudpickle.loads(
                rec["blob"])
            info = _DeploymentInfo(user_cls, init_args, init_kwargs, config)
            # Seed the blob cache with the exact bytes we just loaded:
            # the first post-restore checkpoint must not re-pickle all N
            # deployments in one tick — recovery is precisely the path
            # the cache exists to protect.
            info.ckpt_blob = rec["blob"]
            info.target = rec["target"]
            info.next_replica_seq = rec["next_replica_seq"]
            for replica_id in rec["replica_ids"]:
                try:
                    handle = ray_tpu_torch.get_actor(
                        f"SERVE_REPLICA::{replica_id}",
                        namespace=SERVE_NAMESPACE)
                except Exception:  # noqa: BLE001 — died with controller
                    continue
                rep = _ReplicaInfo(handle, replica_id)
                rep.state = REPLICA_STARTING  # re-proven by reconcile ping
                info.replicas.append(rep)
            # Stale gangs from the dead controller's tenure: kill every
            # rank and release the placement group — reconcile spawns
            # fresh groups (a gang only ever restarts as a unit, and its
            # group_id/rendezvous must be fresh per incarnation).
            for desc in rec.get("groups", ()):
                _cleanup_stale_group(desc)
            self._deployments[name] = info
            # One post-restore sweep per deployment (classification +
            # re-proving re-adopted replicas); parked deployments then
            # leave the scan set until woken. Restore itself stays
            # bounded: no pings, no spawns — reconcile owns both.
            self._dirty.add(name)
            if rec["replica_ids"] or rec.get("groups") or info.target:
                logger.info("serve: restored deployment %s (re-adopted "
                            "%d/%d replicas)", name, len(info.replicas),
                            len(rec["replica_ids"]))
        self._proxy_cfg = snap.get("proxy_cfg")
        self._rebuild_routing_table()
        return True

    def _drop_checkpoint(self) -> None:
        # The delete takes a sequence number past every queued write, so a
        # stale snapshot landing after it can never resurrect torn-down
        # deployments on the next controller restart. Best-effort bounded
        # wait for durability: teardown should not return with the delete
        # still queued, but a dead GCS must not hang it either.
        seq = self._enqueue_ckpt(None)
        with self._ckpt_cond:
            self._ckpt_cond.wait_for(lambda: self._ckpt_attempted >= seq,
                                     timeout=5.0)

    # ---------------------------------------------------------------- API
    # All public methods are async so every mutation runs on the actor's
    # single event loop — no cross-thread races with the reconcile task.

    async def deploy(self, name: str, user_cls, init_args, init_kwargs,
                     config: DeploymentConfig) -> None:
        if config.tenant and config.tenant not in self._tenants:
            raise ValueError(
                f"deployment {name!r} names unregistered tenant "
                f"{config.tenant!r} — serve.register_tenant() it first")
        info = self._deployments.get(name)
        if info is None:
            self._deployments[name] = _DeploymentInfo(
                user_cls, init_args, init_kwargs, config)
        else:
            # Config-only update (replica count, concurrency); new code or
            # args means new replicas — drain all and let reconcile respawn.
            changed_code = (user_cls is not info.user_cls
                            or init_args != info.init_args
                            or init_kwargs != info.init_kwargs)
            old_user_config = info.config.user_config
            info.user_cls = user_cls
            info.init_args = init_args
            info.init_kwargs = init_kwargs
            info.config = config
            info.target = config.initial_replicas()
            if config.user_config is not None and _user_config_changed(
                    old_user_config, config.user_config):
                # New payload version: re-put lazily and re-push to every
                # replica (running ones via reconfigure, new ones on
                # promotion) — live weight updates without a restart. An
                # unchanged payload (a redeploy that only moved replica
                # counts) is NOT re-pushed.
                info.user_config_version += 1
                info.user_config_ref = None
            if changed_code:
                for rep in info.replicas:
                    self._stop_replica(rep)
                info.replicas = []
            info.ckpt_blob = None   # cls/args/config may all have moved
        # Config-only updates (route_prefix, max_concurrent_queries) must
        # reach routers even when the replica set doesn't change.
        self._dirty.add(name)
        self._publish_entry(name)
        self._bump()
        self._checkpoint()
        logger.info("serve: deployed %s (target=%d)", name,
                    self._deployments[name].target)

    async def delete(self, name: str) -> None:
        info = self._deployments.pop(name, None)
        if info is not None:
            for rep in info.replicas:
                self._stop_replica(rep)
            self._dirty.discard(name)
            self._active.discard(name)
            self._routing_table.pop(name, None)
            self._bump()
            self._checkpoint()

    # ---------------------------------------------------------- tenants

    async def register_tenant(self, qos: Dict[str, Any]) -> None:
        """Create or update a tenant (serve.register_tenant). Updates
        re-push every owned deployment's entry with a bumped qos_version
        so proxies rebuild their local buckets."""
        spec = TenantSpec(**qos)
        self._tenants[spec.name] = spec
        self._tenant_version += 1
        self._tenant_versions[spec.name] = self._tenant_version
        republished = False
        for name, info in self._deployments.items():
            if info.config.tenant == spec.name:
                self._publish_entry(name)
                republished = True
        if republished:
            self._bump()
        self._checkpoint()
        logger.info("serve: tenant %s registered (tier=%s weight=%d "
                    "rps=%g inflight=%d)", spec.name, spec.tier,
                    spec.weight, spec.rps_limit, spec.max_inflight)

    async def unregister_tenant(self, name: str) -> None:
        owned = [d for d, info in self._deployments.items()
                 if info.config.tenant == name]
        if owned:
            raise ValueError(
                f"tenant {name!r} still owns deployments {sorted(owned)} "
                "— delete them first")
        if self._tenants.pop(name, None) is not None:
            self._tenant_versions.pop(name, None)
            self._checkpoint()

    async def tenants(self) -> Dict[str, Dict[str, Any]]:
        return {name: spec.qos() for name, spec in self._tenants.items()}

    async def reconcile_stats(self) -> Dict[str, Any]:
        """Reconciler introspection (bench_zoo's sublinearity proof):
        last tick wall time, how many deployments it actually scanned,
        and how many parked ones it skipped."""
        return dict(self._reconcile_stats,
                    active=len(self._active),
                    deployments=len(self._deployments))

    async def wait_ready(self, name: str, timeout_s: float = 60.0) -> bool:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            info = self._deployments.get(name)
            if info is not None:
                running = sum(1 for r in info.replicas
                              if r.state == REPLICA_RUNNING)
                # Autoscaled deployments are ready at one replica; fixed
                # deployments wait for the full target; scale-to-zero
                # (min_replicas=0) deployments deploy parked — ready with
                # zero replicas, the first request cold-starts one.
                auto = info.config.autoscaling
                if auto is not None:
                    need = 0 if auto.min_replicas == 0 else 1
                else:
                    need = info.target
                if running >= need:
                    return True
            await asyncio.sleep(0.05)
        return False

    async def wake_deployment(self, name: str) -> bool:
        """Scale-to-zero wake: a router saw a request for a parked
        deployment. Spawns the first replica IMMEDIATELY (not on the next
        reconcile tick — every tick is ~100ms of cold-start budget) and
        arms the downscale hysteresis so the autoscaler cannot re-park
        the deployment before the buffered request lands."""
        info = self._deployments.get(name)
        if info is None:
            return False
        info.last_wake_at = time.time()
        info.idle_since = None
        if info.target < 1:
            info.target = 1
        # A woken deployment re-enters the reconcile scan set NOW — the
        # sharded reconciler skips parked deployments, and the cold
        # start's STARTING->RUNNING promotion must not wait for the
        # anti-entropy sweep to rediscover it.
        self._dirty.add(name)
        self._active.add(name)
        if not info.replicas:
            if info.cold_start_t0 is None:
                info.cold_start_t0 = time.time()
            logger.info("serve: waking %s (scale-to-zero cold start)", name)
            info.replicas.append(self._start_replica(name, info))
            self._checkpoint()
        return True

    async def get_routing_table(self) -> tuple:
        return self._version, self._routing_table

    async def listen_for_change(self, known_version: int,
                                timeout_s: float = 30.0) -> tuple:
        """Long-poll: parks until the routing table moves past
        known_version (or times out, returning the current view)."""
        if self._change is None:
            self._change = asyncio.Condition()
        deadline = time.time() + timeout_s
        async with self._change:
            while self._version <= known_version and not self._shutdown:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(self._change.wait(),
                                           timeout=remaining)
                except asyncio.TimeoutError:
                    break
        return self._version, self._routing_table

    async def status(self) -> Dict[str, Any]:
        out = {}
        for name, info in self._deployments.items():
            out[name] = {
                "target": info.target,
                "replicas": {
                    r.replica_id: r.state for r in info.replicas},
                "ongoing": sum(r.last_ongoing for r in info.replicas),
                "cold_start_ms": info.last_cold_start_ms,
                "stuck_transitions": self._transitions.stuck_total,
            }
            if info.config.tenant:
                out[name]["tenant"] = info.config.tenant
            if info.config.shard_spec is not None:
                spec = info.config.shard_spec
                out[name]["shard"] = {"world_size": spec.world_size,
                                      "tp": spec.tp}
        return out

    async def graceful_shutdown(self) -> None:
        self._shutdown = True
        import ray_tpu_torch

        for info in self._deployments.values():
            for rep in info.replicas:
                self._stop_replica(rep)
        self._deployments.clear()
        self._dirty.clear()
        self._active.clear()
        self._tenants.clear()
        self._tenant_versions.clear()
        self._routing_table = {}
        for handle in self._proxies.values():
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass
        self._proxies.clear()
        self._drop_checkpoint()
        self._bump()
        del ray_tpu_torch

    # ----------------------------------------------------------- reconcile

    async def reconcile_forever(self, period_s: float = 0.1) -> None:
        proxy_tick = 0.0
        while not self._shutdown:
            try:
                await self._reconcile_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("serve reconcile error")
            if self._proxy_cfg is not None and \
                    time.time() - proxy_tick >= 1.0:
                proxy_tick = time.time()
                try:
                    await self._reconcile_proxies()
                except Exception:  # noqa: BLE001
                    logger.exception("serve proxy reconcile error")
            await asyncio.sleep(period_s)

    # ------------------------------------------------------ proxy management

    async def set_proxy_config(self, host: str, port: int,
                               every_node: bool) -> None:
        """Controller-managed HTTP proxies (reference http_state.py:110
        HTTPProxyStateManager): one per alive node (every_node) or head
        only, health-checked and replaced on death."""
        self._proxy_cfg = {"host": host, "port": port,
                           "every_node": every_node}
        self._checkpoint()
        await self._reconcile_proxies()

    async def proxy_status(self) -> Dict[str, Any]:
        import ray_tpu_torch

        loop = asyncio.get_running_loop()
        out = {}
        for node_hex, handle in list(self._proxies.items()):
            port = await loop.run_in_executor(
                None, functools.partial(_try_proxy_port, handle))
            out[node_hex] = {"alive": port is not None, "port": port}
        del ray_tpu_torch
        return out

    async def _reconcile_proxies(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.serve.proxy import HTTPProxy
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        cfg = self._proxy_cfg
        nodes = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
        node_ip = {n["NodeID"]: n.get("NodeManagerAddress", "")
                   for n in nodes}
        if cfg["every_node"]:
            want = {n["NodeID"] for n in nodes}
        else:
            want = {n["NodeID"] for n in nodes if n.get("IsHead")} or \
                {nodes[0]["NodeID"]} if nodes else set()
        loop = asyncio.get_running_loop()
        # Health-check managed proxies; drop the dead and the unwanted.
        for node_hex, handle in list(self._proxies.items()):
            if node_hex not in want:
                try:
                    ray_tpu_torch.kill(handle)
                except Exception:  # noqa: BLE001
                    pass
                self._proxies.pop(node_hex, None)
                continue
            port = await loop.run_in_executor(
                None, functools.partial(_try_proxy_port, handle))
            if port is None:
                logger.warning("serve: proxy on node %s died — replacing",
                               node_hex[:12])
                self._proxies.pop(node_hex, None)
        # The configured port binds once PER HOST: on a real multi-host
        # cluster every node's proxy listens on cfg["port"]; in the
        # in-process sim (all "nodes" share one IP) only the first proxy
        # on that IP gets it and the rest fall back to ephemeral ports.
        ips_with_cfg_port = {node_ip.get(nh) for nh in self._proxies}
        for node_hex in sorted(want - set(self._proxies),
                               key=lambda nh: (node_ip.get(nh, ""), nh)):
            try:
                existing = ray_tpu_torch.get_actor(
                    f"SERVE_PROXY::{node_hex[:16]}",
                    namespace=SERVE_NAMESPACE)
                self._proxies[node_hex] = existing
                ips_with_cfg_port.add(node_ip.get(node_hex))
                continue
            except Exception:  # noqa: BLE001 — create fresh
                pass
            ip = node_ip.get(node_hex)
            port = cfg["port"] if ip not in ips_with_cfg_port else 0
            ips_with_cfg_port.add(ip)
            handle = ray_tpu_torch.remote(HTTPProxy).options(
                name=f"SERVE_PROXY::{node_hex[:16]}",
                namespace=SERVE_NAMESPACE,
                lifetime="detached", max_concurrency=256, num_cpus=0.01,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node_hex),
            ).remote(cfg["host"], port)
            self._proxies[node_hex] = handle
            logger.info("serve: started proxy on node %s (port %s)",
                        node_hex[:12], port or "ephemeral")

    @staticmethod
    def _is_active(info: _DeploymentInfo) -> bool:
        """Whether a deployment needs per-tick reconcile work. Parked
        (scale-to-zero at zero replicas, target 0, no cold start in
        flight) deployments have nothing time-driven to do — wake/deploy
        /delete all dirty them explicitly."""
        return bool(info.replicas or info.target > 0
                    or info.cold_start_t0 is not None)

    def _scan_set(self) -> Tuple[list, int]:
        """Names to reconcile this tick: every active deployment, every
        dirtied one, plus a rotating anti-entropy shard of the parked
        majority (a lost dirty mark heals within ANTI_ENTROPY_SHARDS
        ticks instead of never). Returns (names, parked_skipped)."""
        dirty, self._dirty = self._dirty, set()
        scan = [n for n in self._deployments
                if n in self._active or n in dirty]
        parked = [n for n in self._deployments
                  if n not in self._active and n not in dirty]
        take = -(-len(parked) // self.ANTI_ENTROPY_SHARDS) if parked else 0
        for i in range(take):
            scan.append(parked[(self._parked_cursor + i) % len(parked)])
        self._parked_cursor += take
        return scan, len(parked) - take

    async def _reconcile_once(self) -> None:
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        tracked_keys = set()
        publish: set = set()
        any_changed = False
        scan, parked_skipped = self._scan_set()
        for name in scan:
            info = self._deployments.get(name)
            if info is None:
                continue  # deleted between dirtying and this tick
            changed, depths_moved = await self._reconcile_deployment(
                loop, name, info, tracked_keys)
            if changed:
                any_changed = True
            if changed or depths_moved:
                publish.add(name)
            # Re-classify for the next tick's scan set.
            if self._is_active(info):
                self._active.add(name)
            else:
                self._active.discard(name)

        # Prune transitions whose subject completed or vanished this tick,
        # then enforce the deadline: a stuck replica is force-replaced
        # (reconcile respawns it), a stuck deployment is counted and
        # re-armed — both land in status()["stuck_transitions"] and a
        # CRITICAL log with the stuck state attributed. Transitions only
        # ever belong to ACTIVE deployments, which every tick scans, so
        # the sharded scan cannot mis-prune a parked deployment's state.
        self._transitions.prune(tracked_keys)
        for key, state, elapsed in self._transitions.fail_stuck():
            for name in list(self._active):
                info = self._deployments.get(name)
                if info is None:
                    continue
                for rep in list(info.replicas):
                    if rep.replica_id == key:
                        self._stop_replica(rep, graceful=False)
                        info.replicas.remove(rep)
                        any_changed = True
                        publish.add(name)

        if publish:
            for name in publish:
                self._publish_entry(name)
            # Depth-only changes bump the version without a checkpoint
            # (routers never poll per-request); membership moves below
            # also checkpoint so recovery stays current.
            self._bump()
        if any_changed:
            self._checkpoint()
        stats = self._reconcile_stats
        stats["ticks"] += 1
        stats["last_tick_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        stats["last_scanned"] = len(scan)
        stats["last_parked_skipped"] = parked_skipped
        stats["deployments"] = len(self._deployments)

    async def _reconcile_deployment(self, loop, name: str,
                                    info: _DeploymentInfo,
                                    tracked_keys: set) -> Tuple[bool, bool]:
        """One deployment's reconcile step (the body of the old
        monolithic loop): promote/cull STARTING replicas, push
        user_config, health-check, autoscale, converge toward target.
        Returns (membership_changed, depths_moved)."""
        changed = False
        depths_moved = False
        # 1. Promote STARTING replicas that answer ping; cull ones that
        # died in __init__ (ping resolves to an actor error) or never
        # came up within the startup timeout.
        for rep in [r for r in info.replicas
                    if r.state == REPLICA_STARTING]:
            state, node = await loop.run_in_executor(
                None, functools.partial(_try_ping_replica, rep, 0.05))
            if state == "ok":
                if node:
                    rep.node_hex = node
                # Deliver the current user_config BEFORE the replica
                # becomes routable: a request must never reach user
                # code whose reconfigure(weights) hasn't run. A failed
                # push leaves it STARTING (retried next tick until the
                # startup timeout below replaces it).
                needs_cfg = (info.user_config_version
                             and info.config.user_config is not None
                             and rep.user_config_version
                             < info.user_config_version)
                if not needs_cfg or await self._push_user_config(
                        loop, info, rep):
                    rep.state = REPLICA_RUNNING
                    changed = True
                    if info.cold_start_t0 is not None:
                        info.last_cold_start_ms = round(
                            (time.time() - info.cold_start_t0) * 1e3, 1)
                        info.cold_start_t0 = None
                        logger.info(
                            "serve: %s cold start served in %.0fms",
                            name, info.last_cold_start_ms)
            if rep.state == REPLICA_STARTING and (
                    state == "dead"
                    or time.time() - rep.started_at
                    > info.config.replica_startup_timeout_s):
                logger.warning(
                    "serve: replica %s of %s failed to start — "
                    "replacing", rep.replica_id, name)
                self._stop_replica(rep, graceful=False)
                info.replicas.remove(rep)
                changed = True

        # 1.5 Weight/config broadcast: push the current user_config to
        # RUNNING replicas behind on it (a live update bumped the
        # version). The payload lives in the object store once per
        # version; each replica receives the REF as its reconfigure
        # argument and pulls the bytes over the transfer plane
        # (concurrent replicas self-organize into a tree there — the
        # controller never re-pickles the payload per replica).
        if info.user_config_version and info.config.user_config is not None:
            behind = [r for r in info.replicas
                      if r.state == REPLICA_RUNNING
                      and r.user_config_version < info.user_config_version]
            if behind:
                # Materialize the ref BEFORE fanning out: concurrent
                # pushes racing the first put would each serialize
                # their own copy of the payload.
                await self._ensure_user_config_ref(loop, info)
                await asyncio.gather(
                    *(self._push_user_config(loop, info, rep)
                      for rep in behind))

        # 2. Health-check RUNNING replicas; replace the dead.
        if (time.time() - info.last_health_check
                >= info.config.health_check_period_s):
            info.last_health_check = time.time()
            stats = await loop.run_in_executor(
                None, functools.partial(_gather_stats, info.replicas))
            dead = []
            for rep, st in zip(list(info.replicas), stats):
                if rep.state != REPLICA_RUNNING:
                    continue
                if st is None:
                    dead.append(rep)
                else:
                    # Deployment-exported backlog (__serve_metrics__,
                    # e.g. the inference engine's queued + running
                    # sequences) counts as pressure: streamed
                    # generations leave `ongoing` as soon as the
                    # stream marker returns, so the engine's own
                    # counts are the only saturation signal for them.
                    # max() against ongoing, not sum — a unary
                    # generate() is BOTH an ongoing RPC and an engine
                    # request, and adding them would double-count it.
                    user = st.get("user") or {}

                    def _n(key):
                        try:
                            return int(user.get(key, 0) or 0)
                        except (TypeError, ValueError):
                            return 0

                    new_load = max(
                        st.get("ongoing", 0),
                        _n("queue_depth") + _n("running"))
                    if new_load != rep.last_ongoing:
                        depths_moved = True
                    rep.last_ongoing = new_load
                    if st.get("node"):
                        rep.node_hex = st["node"]
                    # Model-multiplexed replicas report resident
                    # adapters; pushed in the table so routers can
                    # prefer a replica that already holds one.
                    adapters = user.get("adapters")
                    if adapters is not None:
                        adapters = [str(a) for a in adapters]
                        if adapters != rep.adapters:
                            rep.adapters = adapters
                            depths_moved = True
            for rep in dead:
                logger.warning("serve: replica %s of %s failed health "
                               "check — replacing", rep.replica_id, name)
                self._stop_replica(rep, graceful=False)
                info.replicas.remove(rep)
                changed = True

        # 3. Autoscaling decision.
        if info.config.autoscaling is not None:
            new_target = self._autoscale_decision(info)
            if new_target != info.target:
                logger.info("serve: autoscaling %s %d -> %d",
                            name, info.target, new_target)
                info.target = new_target

        # 4. Converge replica count toward target.
        live = [r for r in info.replicas]
        if len(live) < info.target:
            for _ in range(info.target - len(live)):
                info.replicas.append(self._start_replica(name, info))
            changed = True
        elif len(live) > info.target:
            # Drain the newest first (stable prefix keeps warm caches).
            excess = live[info.target:]
            for rep in excess:
                self._stop_replica(rep)
                info.replicas.remove(rep)
            changed = True

        # 5. Recovery-deadline tracking: every STARTING replica and
        # the deployment's convergence toward target are in-flight
        # transitions; anything stuck past chaos_recovery_deadline_s
        # is failed loudly below (attributed), never left to spin.
        running_n = sum(1 for r in info.replicas
                        if r.state == REPLICA_RUNNING)
        for rep in info.replicas:
            if rep.state == REPLICA_STARTING:
                self._transitions.enter(rep.replica_id, "STARTING")
                tracked_keys.add(rep.replica_id)
        if running_n < info.target:
            key = f"deployment:{name}"
            self._transitions.enter(
                key, f"converging({running_n}/{info.target})")
            tracked_keys.add(key)
        return changed, depths_moved

    async def _ensure_user_config_ref(self, loop, info: _DeploymentInfo):
        """Put the payload ONCE per version, serially — concurrent
        _push_user_config coroutines must never each put their own copy."""
        import ray_tpu_torch

        if info.user_config_ref is None:
            info.user_config_ref = await loop.run_in_executor(
                None, ray_tpu_torch.put, info.config.user_config)

    async def _push_user_config(self, loop, info: _DeploymentInfo,
                                rep: _ReplicaInfo) -> bool:
        """Deliver the current user_config version to one replica and
        AWAIT its reconfigure hook: the version is only marked applied on
        success, so failures are retried next tick instead of silently
        leaving the replica on stale config."""
        import ray_tpu_torch

        await self._ensure_user_config_ref(loop, info)
        version = info.user_config_version
        try:
            ref = rep.handle.reconfigure.remote(info.user_config_ref)
            await loop.run_in_executor(
                None, functools.partial(ray_tpu_torch.get, ref, timeout=60.0))
        except Exception:  # noqa: BLE001 — user hook raised or replica died
            logger.warning("serve: reconfigure of replica %s failed",
                           rep.replica_id, exc_info=True)
            return False
        rep.user_config_version = version
        return True

    def _autoscale_decision(self, info: _DeploymentInfo) -> int:
        cfg = info.config.autoscaling
        running = [r for r in info.replicas if r.state == REPLICA_RUNNING]
        if not running:
            # Parked (scale-to-zero) or mid cold start: wake_deployment
            # owns upscale from zero; there is no load signal to act on.
            return info.target
        total_ongoing = sum(r.last_ongoing for r in running)
        desired = math.ceil(total_ongoing / cfg.target_ongoing_requests) \
            if total_ongoing else cfg.min_replicas
        desired = min(max(desired, cfg.min_replicas), cfg.max_replicas)
        now = time.time()
        if desired > info.target:
            info.idle_since = None
            if info.pressure_since is None:
                info.pressure_since = now
            if now - info.pressure_since >= cfg.upscale_delay_s:
                info.pressure_since = None
                return desired
        elif desired < info.target:
            info.pressure_since = None
            if info.idle_since is None:
                info.idle_since = now
            if now - info.idle_since >= cfg.downscale_delay_s:
                if desired == 0 and now - info.last_wake_at < max(
                        cfg.downscale_delay_s, 1.0):
                    # Wake hysteresis: a cold start is (or just was) in
                    # flight — parking now would strand the request that
                    # triggered it in a wake/park livelock.
                    return info.target
                info.idle_since = None
                return desired
        else:
            info.pressure_since = None
            info.idle_since = None
        return info.target

    # ------------------------------------------------------------- helpers

    def _start_replica(self, name: str, info: _DeploymentInfo):
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import Replica

        if info.config.shard_spec is not None:
            return self._start_replica_group(name, info)
        replica_id = f"{name}#{info.next_replica_seq}"
        info.next_replica_seq += 1
        opts = dict(info.config.ray_actor_options)
        opts.setdefault("num_cpus", 0.1)
        opts["max_concurrency"] = info.config.max_concurrent_queries + 8
        opts["name"] = f"SERVE_REPLICA::{replica_id}"
        opts["namespace"] = SERVE_NAMESPACE
        actor_cls = ray_tpu_torch.remote(Replica)
        handle = actor_cls.options(**opts).remote(
            name, info.user_cls, info.init_args, info.init_kwargs,
            replica_id)
        logger.info("serve: starting replica %s", replica_id)
        return _ReplicaInfo(handle, replica_id)

    def _start_replica_group(self, name: str, info: _DeploymentInfo):
        """One logical replica = one gang: shard_spec.world_size rank
        actors on a fresh placement group. Rank 0 keeps the plain
        replica's name (SERVE_REPLICA::<id>) so routing, the dataplane
        and by-name test hooks are oblivious; ranks > 0 are
        SERVE_RANK::<id>#r<k>. Creation is non-blocking (wait_ready=
        False): the STARTING->RUNNING ping loop owns promotion, and a
        rank that never comes up trips the startup timeout, which stops
        the whole gang (all-or-nothing by way of the lifecycle)."""
        from ray_tpu_torch.serve.replica import Replica
        from ray_tpu_torch.shardgroup import create_gang

        spec = info.config.shard_spec
        replica_id = f"{name}#{info.next_replica_seq}"
        info.next_replica_seq += 1
        base_opts = dict(info.config.ray_actor_options)
        base_opts.setdefault("num_cpus", 0.05)
        base_opts["max_concurrency"] = info.config.max_concurrent_queries + 8
        base_opts["namespace"] = SERVE_NAMESPACE

        def rank_options(rank: int):
            opts = dict(base_opts)
            opts["name"] = (f"SERVE_REPLICA::{replica_id}" if rank == 0
                            else f"SERVE_RANK::{replica_id}#r{rank}")
            return opts

        def rank_args(rank: int):
            ctx = {"group_id": replica_id, "rank": rank,
                   "world_size": spec.world_size, "tp": spec.tp,
                   "spmd": spec.world_size > 1}
            return ((name, info.user_cls, info.init_args,
                     info.init_kwargs, replica_id), {"shard_ctx": ctx})

        group = create_gang(
            Replica, spec, group_id=replica_id,
            bundle=spec.rank_bundle(base_opts),
            rank_options=rank_options, rank_args=rank_args,
            wait_ready=False)
        logger.info("serve: starting replica group %s (world=%d, tp=%d)",
                    replica_id, spec.world_size, spec.tp)
        rep = _ReplicaInfo(group.handle, replica_id)
        rep.group = group
        return rep

    def _stop_replica(self, rep: _ReplicaInfo, graceful: bool = True):
        import ray_tpu_torch

        rep.state = "STOPPING"
        if rep.group is not None:
            # Gangs die as a unit: every rank AND the placement group
            # (bundle release) — a half-alive gang is never left behind.
            rep.group.kill(graceful_timeout_s=1.0 if graceful else 0.0)
            return
        try:
            if graceful:
                rep.handle.prepare_shutdown.remote(1.0)
            ray_tpu_torch.kill(rep.handle)
        except Exception:  # noqa: BLE001 — already dead is fine
            pass

    def _publish_entry(self, name: str) -> None:
        """(Re)build ONE deployment's routing-table entry in place —
        with a zoo of mostly-parked deployments, rebuilding all N
        entries because one replica's depth moved made every push
        O(deployments). The caller owns the version bump."""
        info = self._deployments.get(name)
        if info is None:
            self._routing_table.pop(name, None)
            return
        running = [r for r in info.replicas
                   if r.state == REPLICA_RUNNING]
        prefix = info.config.route_prefix or f"/{name}"
        auto = info.config.autoscaling
        entry = {
            "replicas": [(r.replica_id, r.handle) for r in running],
            "max_concurrent_queries":
                info.config.max_concurrent_queries,
            "route_prefix": prefix,
            # Placement + depth piggyback for the routers' locality /
            # power-of-two-choices pick (pushed, never polled).
            "nodes": {r.replica_id: r.node_hex for r in running
                      if r.node_hex},
            "depths": {r.replica_id: r.last_ongoing for r in running},
            # Scale-to-zero marker: an empty replica list means "wake
            # me", not "unknown deployment".
            "parked": bool(auto is not None and auto.min_replicas == 0
                           and not running),
        }
        # Tenant QoS piggyback: proxies enforce quotas/WFQ off the
        # pushed entry (tenancy/admission.py), never a per-request RPC.
        tenant = info.config.tenant
        if tenant and tenant in self._tenants:
            entry["tenant"] = tenant
            entry["qos"] = self._tenants[tenant].qos()
            entry["qos_version"] = self._tenant_versions.get(tenant, 1)
        # Adapter residency (model-multiplexed replicas): lets the
        # router prefer a replica that already holds the request's
        # model_id (avoids a load+evict on every dispatch).
        adapters = {r.replica_id: r.adapters for r in running
                    if r.adapters}
        if adapters:
            entry["adapters"] = adapters
            entry["mux"] = True
        self._routing_table[name] = entry

    def _rebuild_routing_table(self) -> None:
        """Full rebuild + bump (restore / teardown); steady-state paths
        publish single entries and bump once per batch."""
        for name in list(self._routing_table):
            if name not in self._deployments:
                self._routing_table.pop(name, None)
        for name in self._deployments:
            self._publish_entry(name)
        self._bump()

    def _bump(self) -> None:
        self._version += 1
        if self._change is not None:
            async def notify():
                async with self._change:
                    self._change.notify_all()
            try:
                asyncio.get_running_loop().create_task(notify())
            except RuntimeError:
                pass  # called outside the loop (sync method): next bump


def _try_proxy_port(handle) -> Optional[int]:
    """The proxy's bound port, or None when it is dead/unreachable."""
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get(handle.ready.remote(), timeout=5.0)
    except Exception:  # noqa: BLE001
        return None


def _cleanup_stale_group(desc: Dict[str, Any]) -> None:
    """Tear down a gang recorded in a dead controller's checkpoint:
    best-effort kill of every rank actor by name, then release the
    placement group's bundles."""
    import ray_tpu_torch
    from ray_tpu_torch.core.ids import PlacementGroupID
    from ray_tpu_torch.util.placement_group import (
        PlacementGroup,
        remove_placement_group,
    )

    for rank_name in desc.get("rank_names", ()):
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(rank_name,
                                           namespace=SERVE_NAMESPACE))
        except Exception:  # noqa: BLE001 — died with the controller
            pass
    if desc.get("pg_id"):
        try:
            remove_placement_group(PlacementGroup(
                PlacementGroupID.from_hex(desc["pg_id"]),
                desc.get("bundles") or [], desc.get("strategy") or "PACK"))
        except Exception:  # noqa: BLE001 — already removed
            logger.debug("serve: stale group pg removal failed",
                         exc_info=True)


def _try_ping_replica(rep: _ReplicaInfo, timeout_s: float) -> tuple:
    """Group-aware STARTING probe: a plain replica is its own ping; a
    gang is "ok" only when EVERY rank answers (coordinated process-group
    bring-up finished everywhere), "dead" as soon as ANY rank died — the
    startup path then stops the whole gang (all-or-nothing), releasing its
    placement group."""
    if rep.group is None:
        return _try_ping(rep.handle, timeout_s)
    state, node = _try_ping(rep.handle, timeout_s)
    if state == "dead":
        return "dead", ""
    # Rank 0 was just probed (it carries the node id); sweep only the
    # other ranks so each STARTING tick costs world_size pings, not
    # world_size + 1.
    statuses = rep.group.ping_all(
        timeout_s=timeout_s, indices=range(1, rep.group.world_size))
    if any(s == "dead" for s in statuses):
        return "dead", ""
    if state == "ok" and all(s == "ok" for s in statuses):
        return "ok", node
    return "pending", node


def _try_ping(handle, timeout_s: float) -> tuple:
    """Returns ("ok" | "pending" | "dead", node_hex) — a resolved-but-
    errored ping is a dead replica, not a slow one. The node id rides the
    ping so placement reaches the routing table with no extra RPC."""
    import ray_tpu_torch

    # Never SUBMIT to a not-yet-ALIVE actor: submission resolves the
    # address via a blocking wait_for_actor, so one replica wedged in its
    # __init__ would park the whole reconcile loop — and the stuck-state
    # enforcement that exists to catch exactly that could never run.
    liveness = ray_tpu_torch._require_runtime().actor_liveness(handle._actor_id)
    if liveness != "alive":
        return ("dead" if liveness == "dead" else "pending"), ""
    try:
        ref = handle.ping.remote()
        ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout_s)
        if not ready:
            return "pending", ""
        out = ray_tpu_torch.get(ready[0])
        node = out.get("node", "") if isinstance(out, dict) else ""
        return "ok", node
    except Exception:  # noqa: BLE001
        return "dead", ""


def _gather_stats(replicas) -> list:
    import ray_tpu_torch

    runtime = ray_tpu_torch._require_runtime()
    refs, out = [], []
    for rep in replicas:
        # Only RUNNING replicas are probed, and only via a non-blocking
        # liveness check first: submitting to a not-ALIVE actor blocks on
        # address resolution, and one wedged replica would park the whole
        # reconcile loop (non-RUNNING entries get a None placeholder the
        # consumer's state check skips).
        if rep.state != REPLICA_RUNNING or \
                runtime.actor_liveness(rep.handle._actor_id) != "alive":
            refs.append(None)
            continue
        try:
            refs.append(rep.handle.stats.remote())
        except Exception:  # noqa: BLE001
            refs.append(None)
    for ref in refs:
        if ref is None:
            out.append(None)
            continue
        try:
            out.append(ray_tpu_torch.get(ref, timeout=1.0))
        except Exception:  # noqa: BLE001
            out.append(None)
    # Gang liveness rides the same health check: a group whose rank 0
    # still answers but whose rank k died reports as DEAD — the
    # controller then kills and restarts the gang as one unit (any rank
    # death is a group death; docs/SHARDED.md failure semantics).
    for i, rep in enumerate(replicas):
        if out[i] is not None and rep.group is not None:
            # Rank 0 already answered stats above — sweep only ranks > 0.
            if rep.group.dead_ranks(timeout_s=1.0,
                                    indices=range(1, rep.group.world_size)):
                out[i] = None
    return out
