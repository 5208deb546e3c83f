"""GCS: the cluster-global control plane.

Equivalent of the reference's GCS server (`src/ray/gcs/gcs_server/`): node
membership + health checks (`gcs_health_check_manager.h`), the actor directory
and lifecycle state machine (`gcs_actor_manager.h:240-281`), jobs, an internal
KV store (function table, library state), pubsub (`pubsub_handler.h`), the
global object directory (the reference spreads this across owners +
`ownership_based_object_directory.h`; we centralize it — the owner metadata is
still recorded so fate-sharing semantics hold), placement groups with the
prepare/commit 2PC (`gcs_placement_group_scheduler.h:104-106`), and bounded
task-event storage (`gcs_task_manager.h:61`).

Runs as a thread inside the head process (default) or standalone via
`python -m ray_tpu_torch.core.gcs`.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import (
    ActorInfo,
    ActorState,
    JobInfo,
    NodeInfo,
    PlacementGroupInfo,
    PlacementStrategy,
)
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID
from ray_tpu_torch.core.rpc import (
    DEFERRED,
    Connection,
    ConnectionLost,
    RpcClient,
    RpcServer,
)
from ray_tpu_torch.exceptions import RaySystemError
from ray_tpu_torch.jobs import state as _jobstate

logger = logging.getLogger(__name__)

# Pubsub channels
CH_ACTOR = "ACTOR"
CH_NODE = "NODE"
CH_OBJECT = "OBJECT"
CH_RESOURCES = "RESOURCES"
CH_ERROR = "ERROR"
CH_LOG = "LOG"
CH_PG = "PG"
# Job lifecycle events for raylets (per-event push, never delta-batched:
# a "finished" must reclaim workers NOW, not a flush tick later).
CH_JOB = "JOB"


class Pubsub:
    """Connection-push based pub/sub (reference: `src/ray/pubsub/publisher.h`).

    Subscribers register (channel, key) on their GCS connection; publishes are
    pushed down those connections as `pubsub` messages. key=b"*" subscribes to
    the whole channel.

    Delta-batching (`pubsub_delta_flush_ms` > 0): OBJECT and RESOURCES
    publishes — the high-rate, snapshot-semantics channels — accumulate
    per subscriber instead of pushing one frame (and paying one pickle)
    per event per connection. A flusher drains the buffers every tick as
    `pubsub_batch` frames carrying a strictly-increasing `seq` (monotonic
    per connection; batches are never reordered or replayed). Coalescing
    is delta-correct, not just latest-wins: OBJECT entries are full
    snapshots so the newest replaces; RESOURCES deltas MERGE per node and
    a full view supersedes everything queued before it. The buffer is
    therefore bounded by (live objects-with-subscribers + 1 resource
    slot) per connection, not by the event rate. Latency-sensitive
    channels (ACTOR, NODE, LOG, PG) keep per-event pushes.
    """

    BATCHED_CHANNELS = (CH_OBJECT, CH_RESOURCES)

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: Dict[Tuple[str, bytes], Set[Connection]] = defaultdict(set)
        # conn -> OrderedDict[(channel, key)] -> slot. A slot is
        # [message, private] where `private` marks a per-conn merged copy
        # (shared publish objects are never mutated). Entries vanish on
        # every flush and on drop_connection.
        self._pending: Dict[Connection, Dict[Tuple[str, bytes], list]] = {}
        self._batch_seq = 0
        self.stats = {"batch_frames": 0, "batched_events": 0,
                      "coalesced_events": 0, "immediate_pushes": 0}

    def subscribe(self, conn: Connection, channel: str, key: bytes):
        with self._lock:
            self._subs[(channel, key)].add(conn)

    def drop_connection(self, conn: Connection):
        with self._lock:
            for subs in self._subs.values():
                subs.discard(conn)
            self._pending.pop(conn, None)

    def publish(self, channel: str, key: bytes, message: Any):
        batch = (channel in self.BATCHED_CHANNELS
                 and GLOBAL_CONFIG.pubsub_delta_flush_ms > 0)
        with self._lock:
            exact = self._subs.get((channel, key), ())
            targets = list(exact)
            if key != b"*":
                targets += [c for c in self._subs.get((channel, b"*"), ())
                            if c not in exact]
            if batch:
                for conn in targets:
                    self._enqueue_locked(conn, channel, key, message)
                return
        dead = []
        for conn in targets:
            try:
                conn.push("pubsub", {"channel": channel, "key": key, "message": message})
                self.stats["immediate_pushes"] += 1
            except (ConnectionLost, OSError):
                dead.append(conn)
        for conn in dead:
            self.drop_connection(conn)

    # ------------------------------------------------------ delta batching

    def _enqueue_locked(self, conn: Connection, channel: str, key: bytes,
                        message: Any):
        pend = self._pending.setdefault(conn, {})
        slot = pend.get((channel, key))
        if slot is None:
            pend[(channel, key)] = [message, False]
            return
        self.stats["coalesced_events"] += 1
        if channel == CH_RESOURCES and isinstance(message, dict) \
                and "delta" in message and isinstance(slot[0], dict):
            # Merge the per-node delta into whatever is queued: into a
            # queued full view's entries, or into a queued delta's map.
            # Never in place on a shared publish object — copy on first
            # merge.
            cur = slot[0]
            if "delta" in cur:
                merged = dict(cur["delta"]) if not slot[1] else cur["delta"]
                merged.update(message["delta"])
                pend[(channel, key)] = [{"delta": merged}, True]
            else:
                view = dict(cur) if not slot[1] else cur
                view.update(message["delta"])
                pend[(channel, key)] = [view, True]
            return
        # Snapshot semantics (OBJECT entries, RESOURCES full views): the
        # newest message supersedes everything queued under the key.
        pend[(channel, key)] = [message, False]

    def flush_batches(self):
        """Drain every connection's pending buffer as pubsub_batch frames
        (called by the owner's flusher thread each tick, and once at
        shutdown). Identical frame content is serialized once and pushed
        raw to every subscriber that accumulated it."""
        with self._lock:
            if not self._pending:
                return
            drained = self._pending
            self._pending = {}
        cap = max(1, GLOBAL_CONFIG.pubsub_batch_max_events)
        # (content -> (seq, payload)): identical frames (the common case —
        # every raylet subscribed b"*" accumulates the same snapshot
        # objects) serialize once. A cached frame is only reused for a
        # connection whose last delivered seq is below the cached seq, so
        # per-connection seqs stay strictly increasing.
        payload_cache: Dict[tuple, Tuple[int, bytes]] = {}
        sent_last: Dict[Connection, int] = {}
        dead = []
        for conn, pend in drained.items():
            events = [{"channel": ch, "key": k, "message": slot[0]}
                      for (ch, k), slot in pend.items()]
            for start in range(0, len(events), cap):
                frame = events[start:start + cap]
                content_key = tuple((e["channel"], e["key"],
                                     id(e["message"])) for e in frame)
                cached = payload_cache.get(content_key)
                last = sent_last.get(conn, 0)
                if cached is not None and cached[0] > last:
                    seq, payload = cached
                else:
                    with self._lock:
                        self._batch_seq += 1
                        seq = self._batch_seq
                    payload = serialization.dumps_ctrl(
                        {"seq": seq, "events": frame})
                    payload_cache[content_key] = (seq, payload)
                try:
                    conn.push_raw("pubsub_batch", payload)
                    sent_last[conn] = seq
                    self.stats["batch_frames"] += 1
                    self.stats["batched_events"] += len(frame)
                except (ConnectionLost, OSError):
                    dead.append(conn)
                    break
        for conn in dead:
            self.drop_connection(conn)


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 storage_path: Optional[str] = None):
        # reuse_port so a failover GCS can rebind the previous address.
        self.server = RpcServer(host=host, port=port, name="gcs",
                                reuse_port=True)
        self.server.register_instance(self)
        self.server.on_disconnect = self._on_disconnect
        self.pubsub = Pubsub()
        self._lock = threading.RLock()
        # Sized for actor-create bursts: each in-flight create parks one
        # thread for the whole worker spawn + __init__ (see
        # _schedule_actor), and with forge forks a node absorbs dozens of
        # creates concurrently — 8 threads re-serialized what the raylet
        # had just pipelined.
        self._exec = ThreadPoolExecutor(max_workers=32,
                                        thread_name_prefix="gcs-bg")

        # Tables
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        # node -> actor creations currently in flight (hybrid scheduling
        # counts them toward utilization; heartbeat load reports lag).
        self._inflight_creates: Dict[NodeID, int] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}  # (namespace, name)
        self.jobs: Dict[JobID, JobInfo] = {}
        # Submitted-job table (jobs/state.py records, keyed by submission
        # id): checkpointed with the other tables so a restarted GCS
        # still knows every job; terminal records leave via delete_job.
        self.submitted_jobs: Dict[str, Dict[str, Any]] = {}
        # Per-job driver-log tail (bounded by job_log_tail_bytes each);
        # entries die with their job record (delete_job / _finish_job has
        # no claim here — logs outlive the driver so clients can read a
        # FAILED job's output).
        self.submitted_job_logs: Dict[str, deque] = {}
        self.kv: Dict[Tuple[str, bytes], bytes] = {}
        self._kv_access_order: Dict[Tuple[str, bytes], int] = {}
        self._kv_access_ts: Dict[Tuple[str, bytes], float] = {}
        self._kv_access_tick = 0
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        # Object directory: object_id -> {nodes: set[NodeID], size, inline: bytes|None, owner}
        self.objects: Dict[ObjectID, Dict[str, Any]] = {}
        # borrower worker hex -> objects it borrows (cleanup on death)
        self.borrower_index: Dict[str, set] = {}
        # Task events ring buffer for the state API / timeline
        self.task_events: deque = deque(maxlen=GLOBAL_CONFIG.task_events_max_buffer)
        # Metric snapshots per reporting process (expired when the
        # reporter stops flushing or its node dies)
        self.metrics: Dict[str, Dict[str, Any]] = {}
        self._stale_reporters_total = 0
        # Trace store: spans flushed by every process's MetricsPusher
        # (piggybacked on metrics_report). Bounded drop-oldest; serves
        # /api/traces/<id>, /api/timeline and the observability CLI.
        self.trace_spans: deque = deque()
        self.trace_dropped = 0
        # Per-node queued-but-unsatisfiable resource shapes (autoscaler feed)
        self.node_demand: Dict[NodeID, List[Dict[str, float]]] = {}
        # Last streamed resource-delta version per node (stale-drop).
        self._node_resource_versions: Dict[NodeID, int] = {}
        # Explicit autoscaler.request_resources() bundles
        self.resource_requests: List[Dict[str, float]] = []
        # Host-collective groups (reference `util/collective` GroupManager,
        # centralized): name -> membership + refcounted mailbox + barriers.
        # Ephemeral by design — never persisted (members fate-share with
        # their GCS connection, so a restarted GCS means dead groups).
        self.collectives: Dict[str, Dict[str, Any]] = {}
        self._collective_epoch = 0

        # Raylet clients for GCS-initiated RPCs (actor creation, 2PC, deletes)
        self._raylet_clients: Dict[NodeID, RpcClient] = {}
        # Connection -> metadata for cleanup (drivers register jobs; raylets nodes)
        self._job_counter = 1
        self._stopped = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        # Rate-limited full resource-view broadcast (see
        # _broadcast_resource_view) + the delta-batch flusher.
        self._last_view_broadcast = 0.0
        self._view_broadcast_dirty = False
        self._pubsub_flush_thread: Optional[threading.Thread] = None
        # Table persistence (reference GCS fault tolerance keeps its tables
        # in an external store, `redis_store_client.h:28`; here: periodic
        # atomic snapshots to disk, reloaded by a restarted GCS at the same
        # address). Enabled by an explicit path or the file storage flag.
        if storage_path is None and GLOBAL_CONFIG.gcs_storage == "file":
            storage_path = GLOBAL_CONFIG.gcs_storage_path or None
        self._storage_path = storage_path
        self._persist_thread: Optional[threading.Thread] = None
        self._persist_lock = threading.Lock()  # one snapshot writer at a time
        if self._storage_path:
            self._load_tables()

    # ------------------------------------------------------------------ util

    @property
    def address(self) -> str:
        return self.server.address

    def start(self):
        self.server.start()
        self._health_thread = threading.Thread(
            target=self._health_check_loop, name="gcs-health", daemon=True
        )
        self._health_thread.start()
        self._pubsub_flush_thread = threading.Thread(
            target=self._pubsub_flush_loop, name="gcs-pubsub-flush",
            daemon=True)
        self._pubsub_flush_thread.start()
        if self._storage_path:
            self._persist_thread = threading.Thread(
                target=self._persist_loop, name="gcs-persist", daemon=True)
            self._persist_thread.start()
            self._reschedule_unresolved_actors()
            self._reschedule_submitted_jobs()

    def _reschedule_submitted_jobs(self):
        """GCS failover: jobs restored as SUBMITTED had their dispatch in
        flight (or parked) when the previous incarnation died — re-kick
        each; dispatch parks again if no node is alive yet (raylets are
        still reconnecting) and register_node re-kicks on arrival.
        RUNNING jobs need no kick: their agent keeps supervising through
        the outage and the reconnecting raylet's register_node carries
        the reconcile list."""
        with self._lock:
            pending = [sid for sid, rec in self.submitted_jobs.items()
                       if rec["state"] == _jobstate.SUBMITTED]
        for sid in pending:
            logger.info("GCS failover: re-dispatching submitted job %s", sid)
            self._exec.submit(self._dispatch_submitted_job, sid)

    def _reschedule_unresolved_actors(self):
        """GCS failover: actor creations/restarts that were IN FLIGHT when
        the previous incarnation died are restored as PENDING_CREATION /
        RESTARTING, but the `_schedule_actor` work driving them died with
        the old process — without a re-kick they would sit in that state
        forever (the chaos node-kill + GCS-restart storm found exactly
        this wedge). Re-submit each; the scheduling loop parks until
        nodes re-register. If the old incarnation's create actually
        landed after the snapshot, the re-create supersedes it (the
        orphaned worker's ALIVE push died with the old GCS)."""
        with self._lock:
            pending = [info.actor_id for info in self.actors.values()
                       if info.state in (ActorState.PENDING_CREATION,
                                         ActorState.RESTARTING)]
        for actor_id in pending:
            logger.info("GCS failover: rescheduling in-flight actor %s",
                        actor_id.hex()[:12])
            self._exec.submit(self._schedule_actor, actor_id)

    def stop(self):
        self._stopped.set()
        if getattr(self, "_job_manager", None) is not None:
            try:
                self._job_manager.shutdown()
            except Exception:  # noqa: BLE001 — stop() must keep going
                logger.warning("GCS stop: job manager shutdown failed",
                               exc_info=True)
        if self._storage_path:
            try:
                self._persist_tables()
            except Exception:
                logger.exception("final GCS table persist failed")
        try:
            # Final drain so subscribers see everything published before
            # the stop (a shutdown must not eat the last delta batch).
            self.pubsub.flush_batches()
        except Exception:  # noqa: BLE001 — conns may already be gone
            logger.debug("final pubsub flush failed", exc_info=True)
        self.server.stop()
        for c in self._raylet_clients.values():
            c.close()
        self._exec.shutdown(wait=False)

    # ------------------------------------------------------ table persistence

    def _persist_loop(self):
        period = GLOBAL_CONFIG.gcs_persist_interval_s
        while not self._stopped.wait(period):
            try:
                self._persist_tables()
            except Exception:
                logger.exception("GCS table persist failed")

    def _persist_tables(self):
        import os
        import pickle

        with self._lock:
            snapshot = pickle.dumps({
                "nodes": self.nodes,
                "actors": self.actors,
                "named_actors": self.named_actors,
                "jobs": self.jobs,
                "kv": self.kv,
                "placement_groups": self.placement_groups,
                "job_counter": self._job_counter,
                "submitted_jobs": self.submitted_jobs,
                "submitted_job_logs": self.submitted_job_logs,
            })
        # Serialized writers (stop() vs the persist loop) + fsync + atomic
        # replace: a reader never sees a torn or interleaved snapshot, and
        # a crash at ANY instant leaves either the previous complete
        # snapshot or the new complete snapshot on disk — without the
        # fsync, os.replace could commit the rename before the data blocks
        # hit disk and a power-cut restart would load a torn file.
        with self._persist_lock:
            tmp = self._storage_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(snapshot)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._storage_path)
            # Durability of the rename itself (best-effort: some
            # filesystems refuse directory fds).
            try:
                dfd = os.open(os.path.dirname(self._storage_path)
                              or ".", os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                logger.debug("GCS persist: directory fsync unsupported",
                             exc_info=True)

    def _load_tables(self):
        import os
        import pickle

        # A crash mid-persist may leave a partial .tmp behind; it is never
        # the snapshot (only os.replace promotes it) — drop it so nothing
        # downstream can mistake it for one.
        try:
            os.unlink(self._storage_path + ".tmp")
        except OSError:
            pass
        if not os.path.exists(self._storage_path):
            return
        try:
            with open(self._storage_path, "rb") as f:
                state = pickle.load(f)
        except Exception as e:
            # fsync+atomic-replace means this "cannot happen"; if it does
            # (disk corruption), fail LOUDLY — silently starting an empty
            # GCS would orphan every registered actor and placement group.
            raise RuntimeError(
                f"GCS snapshot {self._storage_path} is unreadable "
                f"({type(e).__name__}: {e}); refusing to start with "
                "partial state") from e
        self.nodes = state["nodes"]
        self.actors = state["actors"]
        self.named_actors = state["named_actors"]
        self.jobs = state["jobs"]
        self.kv = state["kv"]
        self.placement_groups = state["placement_groups"]
        self._job_counter = state["job_counter"]
        # .get(): snapshots from before the job tier lack these tables.
        self.submitted_jobs = state.get("submitted_jobs", {})
        self.submitted_job_logs = state.get("submitted_job_logs", {})
        # The outage shouldn't count against liveness: give every node a
        # fresh heartbeat window before health checks may declare it dead.
        now = time.time()
        for info in self.nodes.values():
            info.last_heartbeat = now
        logger.info("GCS restored %d nodes / %d actors / %d kv entries from %s",
                    len(self.nodes), len(self.actors), len(self.kv),
                    self._storage_path)

    def _raylet(self, node_id: NodeID) -> RpcClient:
        with self._lock:
            client = self._raylet_clients.get(node_id)
            if client is not None and not client.is_closed:
                return client
            info = self.nodes.get(node_id)
            if info is None or info.state != "ALIVE":
                raise RaySystemError(f"Node {node_id} is not alive")
            client = RpcClient(info.address, name=f"gcs->raylet-{node_id.hex()[:8]}")
            self._raylet_clients[node_id] = client
            return client

    # ------------------------------------------------------- node management

    def handle_register_node(self, conn: Connection, data: Dict[str, Any]):
        info: NodeInfo = data["info"]
        with self._lock:
            self.nodes[info.node_id] = info
            conn.meta["node_id"] = info.node_id
        logger.info("Node %s registered at %s, resources=%s", info.node_id.hex()[:12],
                    info.address, info.resources_total)
        # Failover reconciliation: actors this GCS believes ALIVE on the
        # registering node but that the node does NOT actually host died
        # during an outage (their actor_died report went to the dead
        # incarnation) — drive the normal failure path instead of leaving
        # a ghost address every caller errors against. Runs ASYNC against
        # a FRESH raylet query (after a short settle), never against the
        # registration message's snapshot: a re-register racing an
        # in-flight re-create would otherwise read the pre-create worker
        # set and fail over an actor that is coming up right now.
        if data.get("reconcile_actors"):
            self._exec.submit(self._reconcile_node_actors, info.node_id)
        # Job reconcile: RUNNING submitted jobs the table places on this
        # node but that the (re)registering agent does not actually
        # supervise died with the old raylet incarnation — their terminal
        # report went nowhere. `running_jobs` is authoritative: the agent
        # fate-shares with its drivers' supervision threads.
        agent_jobs = set(data.get("running_jobs") or ())
        node_hex = info.node_id.hex()
        lost: List[str] = []
        parked: List[str] = []
        with self._lock:
            for sid, rec in self.submitted_jobs.items():
                if rec["node_id"] == node_hex and \
                        rec["state"] == _jobstate.RUNNING and \
                        sid not in agent_jobs:
                    lost.append(sid)
                elif rec["state"] == _jobstate.SUBMITTED and \
                        rec["node_id"] is None:
                    parked.append(sid)  # submit arrived before any node
        for sid in lost:
            self._job_terminal_transition(
                sid, _jobstate.FAILED,
                f"node {node_hex[:12]} restarted; driver lost")
        for sid in parked:
            self._exec.submit(self._dispatch_submitted_job, sid)
        self.pubsub.publish(CH_NODE, b"*", {"event": "alive", "node": info.to_public()})
        self._broadcast_resource_view(force=True)
        return {"node_count": len(self.nodes)}

    def _reconcile_node_actors(self, node_id: NodeID):
        """Cross-check restored ALIVE actors against what their node
        ACTUALLY hosts (fresh query — in-flight creations count as
        hosted) and fail over the ghosts. See handle_register_node."""
        time.sleep(1.0)  # let racing creations/registrations settle
        if self._stopped.is_set():
            return
        try:
            resp = self._raylet(node_id).call("list_live_actors", {},
                                              timeout=5)
        except Exception:  # noqa: BLE001 — node died again; health
            return         # checking owns that path
        live = {a.binary() for a in resp.get("actors", ())}
        with self._lock:
            ghosts = [a for a in self.actors.values()
                      if a.state == ActorState.ALIVE
                      and a.node_id == node_id
                      and a.actor_id.binary() not in live]
        for ghost in ghosts:
            logger.warning(
                "GCS failover: actor %s recorded ALIVE on %s but the node "
                "does not host it — driving the failure path",
                ghost.actor_id.hex()[:12], node_id.hex()[:12])
            self._on_actor_failure(ghost, "worker died during GCS outage")

    def handle_heartbeat(self, conn: Connection, data: Dict[str, Any]):
        node_id: NodeID = data["node_id"]
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or info.state == "DEAD":
                # Unknown (GCS restarted without state) or declared dead
                # during an outage: make the raylet re-register itself.
                return {"registered": False}
            info.last_heartbeat = time.time()
            # A heartbeat's availability snapshot races the raylet's own
            # streamed deltas: it was taken at send time, so if a fresher
            # versioned delta already landed, applying the snapshot would
            # silently revert it (and no corrective delta comes until the
            # ledger next changes). The version decides.
            version = data.get("resource_version", 0)
            if version >= self._node_resource_versions.get(node_id, 0):
                self._node_resource_versions[node_id] = version
                info.resources_available = data["resources_available"]
                info.resources_total = data.get("resources_total",
                                                info.resources_total)
            self.node_demand[node_id] = data.get("pending_demand", [])
        if data.get("broadcast", True):
            self._broadcast_resource_view()
        return {"registered": True}

    def handle_resource_delta(self, conn: Connection, data: Dict[str, Any]):
        """Streamed per-node availability update (reference Ray Syncer,
        `ray_syncer.proto`): applied immediately and re-published as a
        DELTA on the RESOURCES channel, so peers' cluster views refresh in
        ~the delta interval instead of a heartbeat period. Heartbeats
        remain the periodic full-view anti-entropy."""
        node_id: NodeID = data["node_id"]
        version = data.get("version", 0)
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or info.state == "DEAD":
                return {"registered": False}
            last = self._node_resource_versions.get(node_id, 0)
            # Strictly monotonic per node: an equal or older version is a
            # replay/reorder, and a version-0 delta (sender predating the
            # versioning, or a bug) must not RESET the guard — storing 0
            # would let the next stale delta through.
            if version <= last:
                return {"registered": True, "stale": True}
            self._node_resource_versions[node_id] = version
            info.resources_available = data["resources_available"]
            info.resources_total = data.get("resources_total",
                                            info.resources_total)
            if "pending_demand" in data:
                self.node_demand[node_id] = data["pending_demand"]
            entry = self._view_entry_locked(node_id, info)
        self.pubsub.publish(CH_RESOURCES, b"*",
                            {"delta": {node_id.hex(): entry}})
        return {"registered": True}

    def _view_entry_locked(self, node_id, info) -> Dict[str, Any]:
        """ONE builder for per-node view entries — the delta path and the
        full view must stay shape-compatible (peers' merge replaces whole
        entries, so a field present in one but not the other would vanish
        depending on which message arrived last)."""
        return {
            "address": info.address,
            "total": dict(info.resources_total),
            "available": dict(info.resources_available),
            "alive": info.state == "ALIVE",
            "labels": dict(info.labels),
            "version": self._node_resource_versions.get(node_id, 0),
        }

    def handle_drain_node(self, conn: Connection, data: Dict[str, Any]):
        self._mark_node_dead(data["node_id"], reason="drained")
        return {}

    def handle_get_nodes(self, conn: Connection, data=None):
        with self._lock:
            return [n.to_public() for n in self.nodes.values()]

    def handle_get_resource_view(self, conn: Connection, data=None):
        return self._resource_view()

    def _resource_view(self) -> Dict[str, Any]:
        with self._lock:
            return {n.node_id.hex(): self._view_entry_locked(n.node_id, n)
                    for n in self.nodes.values()}

    def _broadcast_resource_view(self, force: bool = False):
        """Publish the full resource view, rate-limited: every heartbeat
        of every node requests one, and at 100 nodes the unthrottled
        fanout (heartbeats/s x subscribers) is pure control-plane burn.
        Suppressed requests set a dirty flag; the pubsub flusher emits
        the trailing broadcast once the interval has passed, so views
        still converge to the latest state. `force` bypasses the limit:
        topology changes (node registered / node died) must reach
        schedulers NOW — a submit racing a stale empty view would queue
        on an infeasible node and drag its dependencies there with it."""
        min_s = GLOBAL_CONFIG.resource_broadcast_min_interval_ms / 1000.0
        if min_s > 0:
            now = time.monotonic()
            with self._lock:
                if not force and now - self._last_view_broadcast < min_s:
                    self._view_broadcast_dirty = True
                    return
                self._last_view_broadcast = now
                self._view_broadcast_dirty = False
        self.pubsub.publish(CH_RESOURCES, b"*", self._resource_view())
        if force:
            # Bypassing the rate limit alone isn't enough: CH_RESOURCES
            # is a batched channel, so without this the "NOW" view would
            # still sit in the delta buffer for a full flush tick.
            self.pubsub.flush_batches()

    def _pubsub_flush_loop(self):
        """Drains the pubsub delta batches every `pubsub_delta_flush_ms`
        and emits the trailing rate-limited resource-view broadcast. Runs
        even when batching is disabled (tick 0) at a coarse poll so the
        trailing broadcast path still exists."""
        while not self._stopped.is_set():
            tick = GLOBAL_CONFIG.pubsub_delta_flush_ms / 1000.0
            if self._stopped.wait(tick if tick > 0 else 0.05):
                return
            min_s = GLOBAL_CONFIG.resource_broadcast_min_interval_ms / 1e3
            if self._view_broadcast_dirty and (
                    time.monotonic() - self._last_view_broadcast >= min_s):
                try:
                    self._broadcast_resource_view()
                except Exception:  # noqa: BLE001 — retry next tick
                    logger.debug("trailing view broadcast failed",
                                 exc_info=True)
            try:
                self.pubsub.flush_batches()
            except Exception:  # noqa: BLE001 — a bad conn must not stop
                logger.exception("pubsub flush failed")

    def _health_check_loop(self):
        period = GLOBAL_CONFIG.health_check_period_ms / 1000.0
        threshold = GLOBAL_CONFIG.health_check_failure_threshold
        last_tick = time.time()
        while not self._stopped.wait(period):
            now = time.time()
            # Self-clocked grace: when THIS loop was descheduled well past
            # its period (CPU convoy during create storms, suspended VM),
            # the raylets' heartbeat threads starved with it — wall-clock
            # heartbeat age is then evidence of host-wide stall, not of
            # node death. Credit the stall to every node before judging,
            # so liveness detection measures the NODES, not the scheduler.
            stall = (now - last_tick) - period
            last_tick = now
            if stall > period:
                with self._lock:
                    for info in self.nodes.values():
                        info.last_heartbeat = min(
                            now, info.last_heartbeat + stall)
                continue
            dead = []
            with self._lock:
                for info in self.nodes.values():
                    if info.state == "ALIVE" and now - info.last_heartbeat > period * threshold:
                        dead.append(info.node_id)
            for node_id in dead:
                self._mark_node_dead(node_id, reason="missed heartbeats")

    def _mark_node_dead(self, node_id: NodeID, reason: str):
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or info.state == "DEAD":
                return
            info.state = "DEAD"
            self.node_demand.pop(node_id, None)
            self._node_resource_versions.pop(node_id, None)
            client = self._raylet_clients.pop(node_id, None)
        if client:
            client.close()
        logger.warning("Node %s marked DEAD (%s)", node_id.hex()[:12], reason)
        self.pubsub.publish(CH_NODE, b"*", {"event": "dead", "node_id": node_id.hex()})
        # Objects whose only copy was there are lost; actors there die/restart.
        with self._lock:
            for oid, entry in list(self.objects.items()):
                entry["nodes"].discard(node_id)
                entry.get("partial", set()).discard(node_id)
            affected = [a for a in self.actors.values() if a.node_id == node_id
                        and a.state in (ActorState.ALIVE, ActorState.PENDING_CREATION,
                                        ActorState.RESTARTING)]
        for actor in affected:
            self._on_actor_failure(actor, f"node {node_id.hex()[:12]} died: {reason}")
        # Collective members registered from the dead node (heartbeat
        # timeout path — their own GCS connections may still look alive).
        with self._lock:
            hits = [(rec["name"], rec["epoch"], r)
                    for rec in self.collectives.values()
                    for r, m in rec["members"].items()
                    if m.get("node") == node_id.hex() and r not in rec["dead"]]
        for name, epoch, rank in hits:
            self._collective_mark_dead(
                name, epoch, rank, f"node {node_id.hex()[:12]} died: {reason}")
        # Submitted jobs placed on the dead node fail with it (the
        # agent's terminal report fate-shared with the raylet). That
        # includes SUBMITTED-but-dispatched records: the agent may have
        # spawned the driver just before dying, and re-running the
        # entrypoint elsewhere would double-execute it — FAILED is the
        # honest answer; the client owns retry policy.
        node_hex = node_id.hex()
        with self._lock:
            lost = [sid for sid, rec in self.submitted_jobs.items()
                    if rec["node_id"] == node_hex
                    and rec["state"] in (_jobstate.SUBMITTED,
                                         _jobstate.RUNNING)]
        for sid in lost:
            self._job_terminal_transition(
                sid, _jobstate.FAILED,
                f"node {node_hex[:12]} died: {reason}")
        self._broadcast_resource_view(force=True)

    # -------------------------------------------------------- job management

    def handle_register_job(self, conn: Connection, data: Dict[str, Any]):
        sid = data.get("submission_id") or ""
        with self._lock:
            job_id = JobID.from_int(self._job_counter)
            self._job_counter += 1
            info = JobInfo(job_id=job_id, driver_pid=data.get("pid", 0),
                           entrypoint=data.get("entrypoint", ""),
                           namespace=data.get("namespace", "default"),
                           submission_id=sid)
            # Table of record (reference GCS job table): finished driver
            # jobs keep their row for get_jobs/dashboard history — the
            # job's OWNED state (workers, leases, KV, forge refs) is what
            # dies with it, via _finish_job's purge + "finished" publish.
            # raylint: disable=RL018 — retained as the cluster's job history
            self.jobs[job_id] = info
            conn.meta["job_id"] = job_id
            # Link the driver job to its submission record: job-scoped
            # cleanup, tenant QoS, and the dashboard resolve through it.
            rec = self.submitted_jobs.get(sid) if sid else None
            qos: Dict[str, Any] = {}
            renv: Dict[str, Any] = {}
            if rec is not None:
                rec["driver_job_id"] = job_id.hex()
                qos = dict(rec["tenant_qos"])
                renv = dict(rec["runtime_env"])
        # Every driver — submitted or interactive — announces itself on
        # the JOB channel: raylets seed their per-job admission entry
        # (tenant QoS) and, for runtime_env jobs, pre-warm the per-env
        # forge template before the first task needs a worker.
        self.pubsub.publish(CH_JOB, b"*", {
            "event": "running", "job_id": job_id.hex(),
            "submission_id": sid, "tenant_qos": qos,
            "runtime_env": renv})
        return {"job_id": job_id}

    def handle_reattach_job(self, conn: Connection, data: Dict[str, Any]):
        """A driver reconnecting after a GCS restart re-binds its job to the
        new connection, so driver-exit cleanup (_on_disconnect ->
        _finish_job) keeps working across failovers."""
        job_id: JobID = data["job_id"]
        with self._lock:
            if job_id in self.jobs:
                conn.meta["job_id"] = job_id
                return {"ok": True}
        return {"ok": False}

    def handle_get_jobs(self, conn: Connection, data=None):
        with self._lock:
            return [
                {"JobID": j.job_id.hex(), "State": j.state, "StartTime": j.start_time,
                 "EndTime": j.end_time, "Entrypoint": j.entrypoint}
                for j in self.jobs.values()
            ]

    def _finish_job(self, job_id: JobID, state: str = "SUCCEEDED"):
        job_hex = job_id.hex()
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None or job.state != "RUNNING":
                return
            job.state = state
            job.end_time = time.time()
            doomed = [a for a in self.actors.values()
                      if a.job_id == job_id and a.lifetime != "detached"
                      and a.state not in (ActorState.DEAD,)]
            doomed_pgs = [pg for pg in self.placement_groups.values()
                          if pg.job_id == job_id and pg.lifetime != "detached"
                          and pg.state != "REMOVED"]
            # Job-scoped KV reclamation: everything clients stored under
            # `job:<hex>:...` namespaces (ray_tpu_torch.kv_put) dies with the
            # job — detached actors persist state under their OWN names,
            # never under the defunct job's namespace.
            prefix = f"job:{job_hex}:"
            purged = [k for k in self.kv if k[0].startswith(prefix)]
            for k in purged:
                del self.kv[k]
                self._kv_access_order.pop(k, None)
                self._kv_access_ts.pop(k, None)
        if purged:
            logger.info("job %s finished: purged %d job-scoped kv keys",
                        job_hex[:12], len(purged))
        # Raylets reclaim on this push: idle workers tagged with this
        # job's id retire (their runtime_env dies with the job), per-env
        # forge refcounts drop, and the job's admission entry is removed.
        self.pubsub.publish(CH_JOB, b"*",
                            {"event": "finished", "job_id": job_hex,
                             "submission_id": job.submission_id})
        try:
            for actor in doomed:
                self._exec.submit(self._kill_actor, actor.actor_id,
                                  "owner job finished", True)
            for pg in doomed_pgs:
                self._exec.submit(self._remove_placement_group, pg.pg_id)
        except RuntimeError:
            pass  # executor already shut down

    def _on_disconnect(self, conn: Connection):
        if self._stopped.is_set():
            # GCS itself is going down (shutdown or failover): connections
            # dropping is OUR fault, not the peers' — declaring every node
            # dead here would poison the persisted tables and kill actors
            # that are still perfectly alive.
            return
        self.pubsub.drop_connection(conn)
        # Collective members fate-share with their GCS connection: a
        # killed worker/raylet process aborts its groups' in-flight ops
        # now, not at a 300s client timeout.
        for name, epoch, rank in list(conn.meta.get("collective_members", ())):
            self._collective_mark_dead(name, epoch, rank,
                                       "member connection lost")
        job_id = conn.meta.get("job_id")
        if job_id is not None:
            self._finish_job(job_id)
        node_id = conn.meta.get("node_id")
        if node_id is not None:
            self._mark_node_dead(node_id, reason="raylet disconnected")

    # ----------------------------------------------------------------- pubsub

    def handle_subscribe(self, conn: Connection, data: Dict[str, Any]):
        self.pubsub.subscribe(conn, data["channel"], data.get("key", b"*"))
        return {}

    def handle_publish(self, conn: Connection, data: Dict[str, Any]):
        self.pubsub.publish(data["channel"], data.get("key", b"*"), data["message"])
        return {}

    # ---------------------------------------------------- host collectives
    #
    # Control plane of `ray_tpu_torch.collective`: named groups (world_size
    # validated on every attach, epoch bumped per incarnation), a
    # refcounted mailbox for rank-to-rank handoff of small values and
    # object ids (the bulk bytes ride the object transfer plane, never
    # this table), and event-driven barriers. Take/barrier calls park via
    # DEFERRED until fulfilled; a member death (its GCS connection drops,
    # or its node is marked dead) immediately fails every parked call with
    # the dead-rank map, so surviving ranks abort instead of hanging.

    def _collective_rec_locked(self, name: str, epoch: int):
        rec = self.collectives.get(name)
        if rec is None or rec["epoch"] != epoch:
            return None
        return rec

    @staticmethod
    def _collective_new_slot() -> Dict[str, Any]:
        return {"value": None, "consumers": 0, "waiters": [], "posted": False}

    def _collective_reply(self, conn: Connection, msg_id: int, method: str,
                          data: Dict[str, Any]):
        try:
            conn.reply(msg_id, method, data)
        except Exception:  # noqa: BLE001 — waiter's conn died; its loss
            pass           # is handled by its own disconnect path

    def _collective_drain_waiters_locked(self, rec) -> List[tuple]:
        """Collect (conn, msg_id, method) for every parked take/barrier of
        a group and clear the parked state (caller replies outside the
        lock)."""
        out = []
        for slot in rec["mailbox"].values():
            out.extend((c, m, "collective_take") for c, m in slot["waiters"])
            slot["waiters"] = []
        for st in rec["barriers"].values():
            out.extend((c, m, "collective_barrier") for c, m in st["waiters"])
        rec["barriers"].clear()
        return out

    def handle_collective_join(self, conn: Connection, data: Dict[str, Any]):
        """Create-or-attach: the first joiner creates the group record;
        later joiners must present the SAME world_size (a stale record
        with a different world_size is a hard error, never a hang) and a
        free rank. Membership fate-shares with this connection."""
        name, world = data["name"], int(data["world_size"])
        rank = int(data["rank"])
        if world <= 0 or not 0 <= rank < world:
            return {"status": "bad_rank", "world_size": world}
        with self._lock:
            rec = self.collectives.get(name)
            if rec is None:
                self._collective_epoch += 1
                rec = self.collectives[name] = {
                    "name": name, "epoch": self._collective_epoch,
                    "world_size": world, "members": {}, "dead": {},
                    "mailbox": {}, "barriers": {},
                }
            if rec["world_size"] != world:
                return {"status": "mismatch", "expected": rec["world_size"],
                        "epoch": rec["epoch"]}
            if rec["dead"]:
                return {"status": "dead", "dead": dict(rec["dead"]),
                        "epoch": rec["epoch"]}
            member = rec["members"].get(rank)
            if member is not None and member["conn"] is not conn:
                return {"status": "rank_taken", "epoch": rec["epoch"]}
            rec["members"][rank] = {"node": data.get("node_id"), "conn": conn}
            conn.meta.setdefault("collective_members", set()).add(
                (name, rec["epoch"], rank))
            return {"status": "ok", "epoch": rec["epoch"],
                    "world_size": rec["world_size"]}

    def handle_collective_leave(self, conn: Connection, data: Dict[str, Any]):
        """Graceful departure (teardown): removes the member WITHOUT
        breaking the group — peers still draining their last op are not
        aborted the way a death would."""
        with self._lock:
            rec = self._collective_rec_locked(data["name"], data["epoch"])
            rank = int(data["rank"])
            if rec is not None:
                rec["members"].pop(rank, None)
                if not rec["members"] and not rec["dead"]:
                    # Last member left cleanly: GC the record so repeated
                    # experiments don't accumulate group shells.
                    self.collectives.pop(data["name"], None)
            meta = conn.meta.get("collective_members")
            if meta is not None:
                meta.discard((data["name"], data["epoch"], rank))
        return {"status": "ok"}

    def handle_collective_get(self, conn: Connection, data: Dict[str, Any]):
        with self._lock:
            rec = self.collectives.get(data["name"])
            if rec is None:
                return {"known": False}
            return {"known": True, "epoch": rec["epoch"],
                    "world_size": rec["world_size"],
                    "members": sorted(rec["members"]),
                    "dead": dict(rec["dead"]),
                    "mailbox_keys": len(rec["mailbox"]),
                    "mailbox": [
                        (k, s["posted"], s["consumers"], len(s["waiters"]))
                        for k, s in rec["mailbox"].items()],
                    "pending_barriers": len(rec["barriers"]),
                    "barrier_arrivals": {
                        seq: sorted(st["arrived"])
                        for seq, st in rec["barriers"].items()}}

    def handle_collective_post(self, conn: Connection, data: Dict[str, Any]):
        """Publish one mailbox value for `consumers` takers. The slot is
        refcounted: each take decrements, and the slot is deleted when
        drained — long-lived groups never accumulate consumed entries."""
        with self._lock:
            rec = self._collective_rec_locked(data["name"], data["epoch"])
            if rec is None:
                return {"status": "destroyed"}
            if rec["dead"]:
                return {"status": "dead", "dead": dict(rec["dead"])}
            key = data["key"]
            slot = rec["mailbox"].setdefault(key, self._collective_new_slot())
            if slot["posted"]:
                return {"status": "error",
                        "error": f"duplicate collective post for {key!r}"}
            slot["value"] = data["value"]
            slot["consumers"] = int(data.get("consumers", 1))
            slot["posted"] = True
            replies = []
            while slot["waiters"] and slot["consumers"] > 0:
                replies.append(slot["waiters"].pop(0))
                slot["consumers"] -= 1
            if slot["consumers"] <= 0 and not slot["waiters"]:
                del rec["mailbox"][key]
            value = slot["value"]
        for wconn, msg_id in replies:
            self._collective_reply(wconn, msg_id, "collective_take",
                                   {"status": "ok", "value": value})
        return {"status": "ok"}

    def handle_collective_take(self, conn: Connection, data: Dict[str, Any]):
        """Consume one unit of a mailbox value; parks (DEFERRED) until the
        post arrives, the group breaks, or the caller's own RPC timeout —
        the client-side stall timeout — fires."""
        with self._lock:
            rec = self._collective_rec_locked(data["name"], data["epoch"])
            if rec is None:
                return {"status": "destroyed"}
            if rec["dead"]:
                return {"status": "dead", "dead": dict(rec["dead"])}
            key = data["key"]
            slot = rec["mailbox"].get(key)
            if slot is not None and slot["posted"] and slot["consumers"] > 0:
                slot["consumers"] -= 1
                value = slot["value"]
                if slot["consumers"] <= 0 and not slot["waiters"]:
                    del rec["mailbox"][key]
                return {"status": "ok", "value": value}
            if slot is None:
                slot = rec["mailbox"][key] = self._collective_new_slot()
            slot["waiters"].append((conn, conn.current_msg_id))
        return DEFERRED

    def handle_collective_barrier(self, conn: Connection, data: Dict[str, Any]):
        """Event-driven barrier, reusable across rounds: per-seq state is
        created on first arrival and deleted when the last rank releases
        it, so repeated barriers on one group cost nothing persistent."""
        with self._lock:
            rec = self._collective_rec_locked(data["name"], data["epoch"])
            if rec is None:
                return {"status": "destroyed"}
            if rec["dead"]:
                return {"status": "dead", "dead": dict(rec["dead"])}
            seq = data["seq"]
            st = rec["barriers"].setdefault(seq, {"arrived": set(),
                                                  "waiters": []})
            st["arrived"].add(int(data["rank"]))
            if len(st["arrived"]) < rec["world_size"]:
                st["waiters"].append((conn, conn.current_msg_id))
                return DEFERRED
            waiters = st["waiters"]
            del rec["barriers"][seq]
        for wconn, msg_id in waiters:
            self._collective_reply(wconn, msg_id, "collective_barrier",
                                   {"status": "ok"})
        return {"status": "ok"}

    def handle_collective_destroy(self, conn: Connection, data: Dict[str, Any]):
        """With if_broken=True, only destroys a group that has dead
        members — the self-heal path for a name poisoned by a crashed
        previous run. With an epoch, only that incarnation is destroyed.
        Both guards make a straggling destroy race-safe against a peer
        that already recreated the name (the fresh group is left alone)."""
        with self._lock:
            rec = self.collectives.get(data["name"])
            if rec is not None and (
                    (data.get("if_broken") and not rec["dead"])
                    or (data.get("epoch") is not None
                        and rec["epoch"] != data["epoch"])):
                return {"status": "ok", "destroyed": False}
            rec = self.collectives.pop(data["name"], None)
            waiters = self._collective_drain_waiters_locked(rec) if rec else []
        for wconn, msg_id, method in waiters:
            self._collective_reply(wconn, msg_id, method,
                                   {"status": "destroyed"})
        return {"status": "ok"}

    def _collective_mark_dead(self, name: str, epoch: int, rank: int,
                              reason: str):
        """A member died: record it, fail every parked take/barrier of the
        group with the rank-attributed dead map, and drop now-unservable
        mailbox state. Subsequent calls against the group answer 'dead'
        until it is destroyed and re-created (fresh epoch)."""
        with self._lock:
            rec = self._collective_rec_locked(name, epoch)
            if rec is None or rank in rec["dead"]:
                return
            rec["dead"][rank] = reason
            dead = dict(rec["dead"])
            waiters = self._collective_drain_waiters_locked(rec)
            # No take against a broken group ever succeeds again: posted
            # slots are garbage now, not later.
            rec["mailbox"].clear()
            if len(rec["dead"]) >= rec["world_size"]:
                self.collectives.pop(name, None)
        logger.warning("collective group '%s': rank %d died (%s)",
                       name, rank, reason)
        for wconn, msg_id, method in waiters:
            self._collective_reply(wconn, msg_id, method,
                                   {"status": "dead", "dead": dead})

    # --------------------------------------------------------------- KV store

    @staticmethod
    def _kv_key(key):
        # Callers mix str and bytes keys (internal_kv uses bytes, rpdb and
        # friends use str); normalize to bytes so prefix scans never hit a
        # str/bytes startswith type mismatch.
        return key.encode() if isinstance(key, str) else key

    def handle_kv_put(self, conn: Connection, data: Dict[str, Any]):
        ns, key = data.get("namespace", ""), self._kv_key(data["key"])
        overwrite = data.get("overwrite", True)
        with self._lock:
            exists = (ns, key) in self.kv
            if exists and not overwrite:
                return {"added": False, "existed": True}
            self.kv[(ns, key)] = data["value"]
            if ns == "runtime_env":
                self._kv_touch_locked((ns, key))
                self._evict_runtime_env_locked(keep=(ns, key))
        return {"added": True, "existed": exists}

    def _kv_touch_locked(self, key):
        self._kv_access_tick += 1
        self._kv_access_order[key] = self._kv_access_tick
        self._kv_access_ts[key] = time.time()

    def _evict_runtime_env_locked(self, keep):
        """LRU-cap runtime_env package blobs: the KV is in-memory, and a
        cluster where users iterate on code would otherwise accumulate
        every historical zip until OOM (reference: URI cache with eviction,
        `runtime_env/uri_cache.py`). Caller holds self._lock."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        cap = GLOBAL_CONFIG.runtime_env_cache_bytes
        grace = GLOBAL_CONFIG.runtime_env_eviction_grace_s
        entries = [(k, len(v)) for k, v in self.kv.items()
                   if k[0] == "runtime_env"]
        total = sum(s for _, s in entries)
        if total <= cap:
            return
        order = self._kv_access_order  # key -> monotonically increasing tick
        entries.sort(key=lambda kv: order.get(kv[0], 0))
        now = time.time()
        for k, size in entries:
            if k == keep or total <= cap:
                continue
            # A blob touched recently may still be referenced by queued or
            # leased task specs whose workers haven't materialized it yet;
            # evicting it would crash-loop those workers until the driver's
            # EnvCache revalidates. Let the cap be transiently exceeded
            # instead (reference pins in-use URIs: `runtime_env/uri_cache.py`).
            if now - self._kv_access_ts.get(k, 0.0) < grace:
                continue
            del self.kv[k]
            order.pop(k, None)
            self._kv_access_ts.pop(k, None)
            total -= size

    def handle_kv_get(self, conn: Connection, data: Dict[str, Any]):
        key = (data.get("namespace", ""), self._kv_key(data["key"]))
        with self._lock:
            if key[0] == "runtime_env" and key in self.kv:
                self._kv_touch_locked(key)
            return {"value": self.kv.get(key)}

    def handle_kv_del(self, conn: Connection, data: Dict[str, Any]):
        ns, key = data.get("namespace", ""), self._kv_key(data["key"])
        with self._lock:
            if data.get("prefix"):
                doomed = [k for k in self.kv if k[0] == ns and k[1].startswith(key)]
                for k in doomed:
                    del self.kv[k]
                    self._kv_access_order.pop(k, None)
                    self._kv_access_ts.pop(k, None)
                return {"deleted": len(doomed)}
            self._kv_access_order.pop((ns, key), None)
            self._kv_access_ts.pop((ns, key), None)
            return {"deleted": int(self.kv.pop((ns, key), None) is not None)}

    def handle_kv_keys(self, conn: Connection, data: Dict[str, Any]):
        ns = data.get("namespace", "")
        prefix = self._kv_key(data.get("prefix", b""))
        with self._lock:
            return {"keys": [k[1] for k in self.kv if k[0] == ns and k[1].startswith(prefix)]}

    def handle_kv_exists(self, conn: Connection, data: Dict[str, Any]):
        key = (data.get("namespace", ""), self._kv_key(data["key"]))
        with self._lock:
            exists = key in self.kv
            if exists and key[0] == "runtime_env":
                # Liveness probes keep in-use packages warm in the LRU.
                self._kv_touch_locked(key)
            return {"exists": exists}

    # ------------------------------------------------------- object directory

    def handle_object_location_add(self, conn: Connection, data: Dict[str, Any]):
        """Register a location. With ``partial=True`` the node is mid-pull:
        it holds SOME chunks and can serve the ones it has (chunk-aware
        answers let concurrent pullers drain from each other instead of
        convoying on the seed node). A later full add promotes it."""
        oid: ObjectID = data["object_id"]
        with self._lock:
            entry = self.objects.setdefault(
                oid, {"nodes": set(), "size": 0, "inline": None, "owner": None})
            if data.get("node_id") is not None:
                if data.get("partial"):
                    entry.setdefault("partial", set()).add(data["node_id"])
                else:
                    entry["nodes"].add(data["node_id"])
                    entry.setdefault("partial", set()).discard(data["node_id"])
                    entry["located"] = True
            entry["size"] = data.get("size", entry["size"])
            if data.get("inline") is not None:
                entry["inline"] = data["inline"]
                entry["located"] = True
            if data.get("owner") is not None:
                entry["owner"] = data["owner"]
        self.pubsub.publish(CH_OBJECT, oid.binary(), self._object_entry_public(oid))
        return {}

    def handle_object_location_remove(self, conn: Connection, data: Dict[str, Any]):
        oid: ObjectID = data["object_id"]
        with self._lock:
            entry = self.objects.get(oid)
            if entry:
                entry.get("partial", set()).discard(data["node_id"])
                if not data.get("partial"):  # partial=True: abandoned pull only
                    entry["nodes"].discard(data["node_id"])
        return {}

    def handle_object_locations_get(self, conn: Connection, data: Dict[str, Any]):
        return self._object_entry_public(data["object_id"])

    def handle_object_locations_batch(self, conn: Connection, data: Dict[str, Any]):
        """Bulk location metadata for locality-aware placement: nodes and
        sizes only (inline payloads are elided — a scheduler scoring
        resident bytes must not drag the bytes over the wire)."""
        out = []
        with self._lock:
            for oid in data["object_ids"]:
                entry = self.objects.get(oid)
                if entry is None:
                    out.append({"known": False})
                else:
                    out.append({
                        "known": True,
                        "nodes": list(entry["nodes"]),
                        "size": entry["size"],
                        "has_inline": entry["inline"] is not None,
                    })
        return {"entries": out}

    def _object_entry_public(self, oid: ObjectID) -> Dict[str, Any]:
        with self._lock:
            entry = self.objects.get(oid)
            if entry is None:
                return {"known": False}
            return {
                "known": True,
                "nodes": [n for n in entry["nodes"]],
                # Mid-pull holders: they serve the chunks they already have
                # and answer "missing" for the rest — extra stripe sources
                # for concurrent pullers, never the sole trigger of a pull.
                "partial_nodes": [n for n in entry.get("partial", ())],
                "size": entry["size"],
                "inline": entry["inline"],
                "owner": entry["owner"],
                # False while only borrowers have registered: the object
                # is not created yet, which is not the same as lost.
                "located": bool(entry.get("located")),
            }

    def handle_free_objects(self, conn: Connection, data: Dict[str, Any]):
        """Owner dropped its last reference. An object still borrowed by
        another process (reference `reference_count.h:61,494-500` borrower
        bookkeeping, redesigned GCS-mediated: borrowers register against
        the directory entry instead of long-polling the owner) is only
        MARKED pending-free; the actual free runs when the last borrower
        leaves (handle_borrow_remove)."""
        oids: List[ObjectID] = data["object_ids"]
        # Owner-side segment recycling: for these ids the owner's raylet
        # keeps the shm file (close mapping only) so the owner can rename
        # it into its SegmentPool; other nodes unlink their copies.
        defer = {o.binary() for o in data.get("defer_unlink", ())}
        defer_node = data.get("defer_node")
        by_node: Dict[NodeID, List[ObjectID]] = defaultdict(list)
        with self._lock:
            freed: List[ObjectID] = []
            for oid in oids:
                entry = self.objects.get(oid)
                if entry is None:
                    # Never registered in the directory (e.g. an unpublished
                    # inline actor result) — it can still HOLD container
                    # borrows on inner objects; release them.
                    freed.append(oid)
                    continue
                if entry.get("borrowers"):
                    entry["pending_free"] = True
                    continue
                self.objects.pop(oid, None)
                for node_id in entry["nodes"]:
                    by_node[node_id].append(oid)
                freed.append(oid)
            self._cascade_container_borrows_locked(freed, by_node)
        self._delete_on_nodes(by_node, defer, defer_node)
        return {"freed": freed}

    def _delete_on_nodes(self, by_node: Dict[NodeID, List[ObjectID]],
                         defer: Optional[set] = None,
                         defer_node: Optional[NodeID] = None):
        for node_id, node_oids in by_node.items():
            msg: Dict[str, Any] = {"object_ids": node_oids}
            if defer and node_id == defer_node:
                msg["skip_unlink"] = [o for o in node_oids
                                      if o.binary() in defer]
            try:
                self._raylet(node_id).call("delete_objects", msg, timeout=5)
            except Exception:  # noqa: BLE001 — node may be dead; GC re-runs
                logger.debug("delete_objects to %s failed", node_id,
                             exc_info=True)

    def handle_set_node_resource(self, conn: Connection,
                                 data: Dict[str, Any]):
        """Route a dynamic-resource update to the owning raylet
        (reference `experimental/dynamic_resources.py` set_resource)."""
        node_id = data["node_id"]
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or info.state != "ALIVE":
                raise ValueError(f"node {node_id.hex()[:12]} is not alive")
        return self._raylet(node_id).call(
            "set_resource",
            {"resource_name": data["resource_name"],
             "capacity": data["capacity"]}, timeout=10)

    def handle_borrow_add(self, conn: Connection, data: Dict[str, Any]):
        """A non-owner process deserialized reference(s) to object(s):
        keep them alive past the owner's free until the borrower drops
        them. Registered synchronously by the borrower at ref
        deserialization, while the owner's submit-time pin still holds, so
        the handoff can't race the owner's free. `object_ids` batches one
        deserialization's worth of refs into a single round trip."""
        borrower = data["borrower_id"]
        oids = data.get("object_ids") or [data["object_id"]]
        with self._lock:
            for oid in oids:
                entry = self.objects.setdefault(
                    oid, {"nodes": set(), "size": 0, "inline": None,
                          "owner": None})
                entry.setdefault("borrowers", set()).add(borrower)
                self.borrower_index.setdefault(borrower, set()).add(oid)
        return {}

    def _remove_borrow_locked(self, oid: ObjectID, borrower: str,
                              by_node: Dict[NodeID, List[ObjectID]],
                              freed: Optional[List[ObjectID]] = None):
        entry = self.objects.get(oid)
        if entry is None:
            return
        borrowers = entry.get("borrowers")
        if borrowers is not None:
            borrowers.discard(borrower)
        if not borrowers and entry.get("pending_free"):
            self.objects.pop(oid, None)
            for node_id in entry["nodes"]:
                by_node[node_id].append(oid)
            if freed is not None:
                freed.append(oid)

    def _cascade_container_borrows_locked(self, freed: List[ObjectID],
                                          by_node: Dict[NodeID, List[ObjectID]]):
        """Containers (puts / task returns holding serialized ObjectRefs)
        register their inner ids as borrows under the synthetic borrower
        ``obj:<container-hex>`` (reference: contained-object-id tracking,
        `reference_count.h` AddNestedObjectIds). When a container's entry is
        freed, drop those borrows here — which may free inner containers in
        turn (worklist, not recursion; the store lock is held throughout)."""
        work = list(freed)
        while work:
            container = work.pop()
            borrower = "obj:" + container.hex()
            held = self.borrower_index.pop(borrower, None)
            if not held:
                continue
            inner_freed: List[ObjectID] = []
            for inner in held:
                self._remove_borrow_locked(inner, borrower, by_node, inner_freed)
            work.extend(inner_freed)

    def handle_borrow_remove(self, conn: Connection, data: Dict[str, Any]):
        oid: ObjectID = data["object_id"]
        borrower = data["borrower_id"]
        by_node: Dict[NodeID, List[ObjectID]] = defaultdict(list)
        with self._lock:
            held = self.borrower_index.get(borrower)
            if held is not None:
                held.discard(oid)
                if not held:
                    self.borrower_index.pop(borrower, None)
            freed: List[ObjectID] = []
            self._remove_borrow_locked(oid, borrower, by_node, freed)
            self._cascade_container_borrows_locked(freed, by_node)
        self._delete_on_nodes(by_node)
        return {}

    def handle_borrower_gone(self, conn: Connection, data: Dict[str, Any]):
        """A borrower process exited (graceful shutdown flush, or its
        raylet reporting the worker's death): drop every borrow it held so
        pending frees fire instead of leaking store bytes. Borrowers on a
        node that dies WITH its raylet are not reported and leak until
        owner + cluster restart (reference has the same window — borrower
        death detection rides the raylet)."""
        borrower = data["borrower_id"]
        by_node: Dict[NodeID, List[ObjectID]] = defaultdict(list)
        with self._lock:
            held = self.borrower_index.pop(borrower, set())
            freed: List[ObjectID] = []
            for oid in held:
                self._remove_borrow_locked(oid, borrower, by_node, freed)
            self._cascade_container_borrows_locked(freed, by_node)
        self._delete_on_nodes(by_node)
        return {"dropped": len(held)}

    # ------------------------------------------------------- actor management

    def handle_register_actor(self, conn: Connection, data: Dict[str, Any]):
        """Async actor creation: record, schedule in background, publish state."""
        spec = data["spec"]  # TaskSpec with actor_creation=True
        actor_id = spec.actor_id
        if data.get("subscribe"):
            # Piggybacked state subscription: one round trip instead of a
            # subscribe + register pair — during create bursts each extra
            # sync RPC serializes on the caller's GCS connection while
            # this process is GIL-saturated, and the subscription MUST be
            # in place before scheduling can publish ALIVE anyway.
            self.pubsub.subscribe(conn, CH_ACTOR, actor_id.binary())
        info = ActorInfo(
            actor_id=actor_id,
            job_id=spec.job_id,
            class_name=spec.name,
            state=ActorState.PENDING_CREATION,
            name=spec.actor_name,
            namespace=spec.actor_namespace or "default",
            max_restarts=spec.actor_max_restarts,
            lifetime=spec.actor_lifetime,
            resources=dict(spec.resources),
            creation_spec=spec,
        )
        with self._lock:
            if spec.actor_name:
                key = (info.namespace, spec.actor_name)
                if key in self.named_actors:
                    existing = self.actors.get(self.named_actors[key])
                    if existing is not None and existing.state != ActorState.DEAD:
                        raise RaySystemError(
                            f"Actor name '{spec.actor_name}' already taken in "
                            f"namespace '{info.namespace}'")
                self.named_actors[key] = actor_id
            self.actors[actor_id] = info
        self._exec.submit(self._schedule_actor, actor_id)
        return {}

    def _schedule_actor(self, actor_id: ActorID):
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None or info.state == ActorState.DEAD:
                return
            spec = info.creation_spec
            # Stamp the incarnation: the worker invokes the class's
            # __ray_restart__ state-restore hook on restarts (count > 0)
            # but never on first creation.
            spec.actor_restart_count = info.num_restarts
        deadline = time.monotonic() + GLOBAL_CONFIG.worker_lease_timeout_ms / 1000.0 * 10
        while not self._stopped.is_set():
            node_id = self._pick_node_for(spec)
            if node_id is None:
                if time.monotonic() > deadline:
                    self._actor_dead(actor_id, "no node with required resources "
                                               f"{spec.resources} became available")
                    return
                time.sleep(0.2)
                continue
            try:
                # Dedicated connection: create_actor blocks for the whole
                # worker spawn + __init__, and RPC connections process
                # requests serially — don't head-of-line-block the shared
                # GCS->raylet client (kill_worker, bundle 2PC, deletes).
                with self._lock:
                    info = self.nodes.get(node_id)
                if info is None or info.state != "ALIVE":
                    time.sleep(0.2)
                    continue
                create_client = RpcClient(
                    info.address, name=f"gcs-create-actor-{actor_id.hex()[:8]}")
                with self._lock:
                    self._inflight_creates[node_id] = \
                        self._inflight_creates.get(node_id, 0) + 1
                try:
                    resp = create_client.call(
                        "create_actor", {"spec": spec},
                        timeout=GLOBAL_CONFIG.worker_lease_timeout_ms / 1000.0 * 2)
                finally:
                    create_client.close()
                    with self._lock:
                        n = self._inflight_creates.get(node_id, 1) - 1
                        if n <= 0:
                            self._inflight_creates.pop(node_id, None)
                        else:
                            self._inflight_creates[node_id] = n
            except Exception as e:
                logger.warning("actor %s creation on %s failed: %s",
                               actor_id.hex()[:12], node_id.hex()[:12], e)
                time.sleep(0.2)
                continue
            if resp.get("status") == "ok":
                with self._lock:
                    info = self.actors[actor_id]
                    info.state = ActorState.ALIVE
                    info.node_id = node_id
                    info.worker_id = resp["worker_id"]
                    info.direct_address = resp["direct_address"]
                self.pubsub.publish(CH_ACTOR, actor_id.binary(),
                                    {"state": "ALIVE", "address": resp["direct_address"]})
                return
            elif resp.get("status") == "error":
                # Creation task itself failed (user __init__ raised): actor dead.
                self._actor_dead(actor_id, resp.get("error", "creation failed"),
                                 error_blob=resp.get("error_blob"))
                return
            # status == "retry": node couldn't take it (resources raced); loop.
            time.sleep(0.1)

    def _pick_node_for(self, spec) -> Optional[NodeID]:
        """Resource-feasibility + packing score over the cluster view."""
        from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

        strategy = spec.scheduling_strategy
        with self._lock:
            candidates = []
            for info in self.nodes.values():
                if info.state != "ALIVE":
                    continue
                # Admission control for create bursts: a node absorbing
                # more concurrent creations than it has cores just convoys
                # the worker inits (and the whole burst's latency) — park
                # the surplus in _schedule_actor's retry loop instead.
                # Worker spawns are cheap (forge forks) but worker INIT is
                # CPU-bound, so the cap tracks the node's CPU count.
                cap = max(2.0, info.resources_total.get("CPU", 0.0))
                if self._inflight_creates.get(info.node_id, 0) >= cap:
                    continue
                avail = info.resources_available
                need = getattr(spec, "placement_resources", None) or spec.resources
                if all(avail.get(r, 0.0) >= amt for r, amt in need.items()):
                    candidates.append(info)
            if isinstance(strategy, NodeAffinitySchedulingStrategy):
                target = next((c for c in candidates
                               if c.node_id.hex() == strategy.node_id), None)
                if target is None and not strategy.soft:
                    return None
                if target is not None:
                    return target.node_id
            if not candidates:
                return None

            # Hybrid (reference scheduling_policy.cc): pack onto the
            # most-utilized node while it stays under the threshold, then
            # spread to the least-utilized — tiny actors no longer all
            # funnel onto one node whose worker spawns serialize. Creates
            # in flight count toward utilization: heartbeats lag, and N
            # concurrent creations would otherwise all pick the same
            # node before its load report catches up.
            def base_utilization(n: NodeInfo) -> float:
                total = sum(n.resources_total.values()) or 1.0
                avail = sum(n.resources_available.values())
                return (total - avail) / total

            def utilization(n: NodeInfo) -> float:
                return base_utilization(n) + \
                    0.1 * self._inflight_creates.get(n.node_id, 0)

            packable = [n for n in candidates
                        if utilization(n)
                        < GLOBAL_CONFIG.scheduler_spread_threshold]
            if packable:
                # Rank by RESOURCE utilization MINUS an in-flight-create
                # penalty. Counting inflight positively (as the threshold
                # gate does) made a create burst self-attracting: every
                # create chased the node with the most creates, one
                # worker forge absorbed the whole burst's forks while the
                # other templates idled — and the winner kept winning as
                # its resident actors nudged its base utilization up. The
                # penalty spreads a burst across nodes while keeping
                # steady-state packing (idle periods have no inflight).
                return max(packable, key=lambda n: (
                    base_utilization(n)
                    - 0.1 * self._inflight_creates.get(n.node_id, 0)
                )).node_id
            return min(candidates, key=utilization).node_id

    def _on_actor_failure(self, info: ActorInfo, reason: str):
        with self._lock:
            if info.state == ActorState.DEAD:
                return
            restarts_left = (info.max_restarts == -1
                             or info.num_restarts < info.max_restarts)
            if restarts_left:
                info.num_restarts += 1
                info.state = ActorState.RESTARTING
                info.direct_address = None
                actor_id = info.actor_id
            else:
                actor_id = None
        if actor_id is not None:
            self.pubsub.publish(CH_ACTOR, info.actor_id.binary(), {"state": "RESTARTING"})
            self._exec.submit(self._schedule_actor, info.actor_id)
        else:
            self._actor_dead(info.actor_id, reason)

    def _actor_dead(self, actor_id: ActorID, reason: str, error_blob: Optional[bytes] = None):
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None:
                return
            info.state = ActorState.DEAD
            info.death_cause = reason
            info.direct_address = None
            if info.name:
                self.named_actors.pop((info.namespace, info.name), None)
        self.pubsub.publish(CH_ACTOR, actor_id.binary(),
                            {"state": "DEAD", "reason": reason, "error_blob": error_blob})

    def handle_actor_died(self, conn: Connection, data: Dict[str, Any]):
        """Raylet reports a dedicated actor worker exited."""
        actor_id: ActorID = data["actor_id"]
        with self._lock:
            info = self.actors.get(actor_id)
        if info is None:
            return {}
        if data.get("intended"):
            self._actor_dead(actor_id, data.get("reason", "killed"))
        else:
            self._on_actor_failure(info, data.get("reason", "worker died"))
        return {}

    def handle_kill_actor(self, conn: Connection, data: Dict[str, Any]):
        self._kill_actor(data["actor_id"], data.get("reason", "ray_tpu_torch.kill"),
                         data.get("no_restart", True))
        return {}

    def _kill_actor(self, actor_id: ActorID, reason: str, no_restart: bool):
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None or info.state == ActorState.DEAD:
                return
            node_id, worker_id = info.node_id, info.worker_id
            if no_restart:
                info.max_restarts = info.num_restarts  # exhaust restarts
        if node_id is not None:
            try:
                self._raylet(node_id).call(
                    "kill_worker", {"worker_id": worker_id, "actor_id": actor_id,
                                    "reason": reason, "intended": True,
                                    "suppress_report": no_restart}, timeout=10)
            except Exception:  # noqa: BLE001 — raylet may be dead already
                logger.debug("kill_worker on %s failed", node_id,
                             exc_info=True)
        if no_restart:
            self._actor_dead(actor_id, reason)

    def handle_get_actor_info(self, conn: Connection, data: Dict[str, Any]):
        with self._lock:
            info = self.actors.get(data["actor_id"])
            if info is None:
                return {"known": False}
            return {"known": True, "state": info.state.value,
                    "address": info.direct_address, "death_cause": info.death_cause,
                    "class_name": info.class_name}

    def handle_get_named_actor(self, conn: Connection, data: Dict[str, Any]):
        with self._lock:
            actor_id = self.named_actors.get((data.get("namespace", "default"), data["name"]))
            if actor_id is None:
                return {"found": False}
            info = self.actors[actor_id]
            return {"found": True, "actor_id": actor_id,
                    "creation_spec": info.creation_spec, "state": info.state.value}

    def handle_list_named_actors(self, conn: Connection, data: Dict[str, Any]):
        with self._lock:
            if data.get("all_namespaces"):
                return {"names": [{"namespace": ns, "name": n}
                                  for (ns, n) in self.named_actors]}
            ns = data.get("namespace", "default")
            return {"names": [{"namespace": k[0], "name": k[1]}
                              for k in self.named_actors if k[0] == ns]}

    def handle_get_actors(self, conn: Connection, data=None):
        with self._lock:
            return [a.to_public() for a in self.actors.values()]

    # ---------------------------------------------------- placement groups

    def handle_create_placement_group(self, conn: Connection, data: Dict[str, Any]):
        pg: PlacementGroupInfo = data["pg"]
        with self._lock:
            self.placement_groups[pg.pg_id] = pg
        self._exec.submit(self._schedule_placement_group, pg.pg_id)
        return {}

    def _schedule_placement_group(self, pg_id: PlacementGroupID):
        """Two-phase commit of bundle reservations across raylets
        (reference `gcs_placement_group_scheduler.h` Prepare/Commit)."""
        with self._lock:
            pg = self.placement_groups.get(pg_id)
            if pg is None:
                return
        deadline = time.monotonic() + 60.0
        while not self._stopped.is_set() and time.monotonic() < deadline:
            placement = self._plan_bundles(pg)
            if placement is None:
                time.sleep(0.2)
                continue
            prepared: List[Tuple[NodeID, int]] = []
            ok = True
            for bundle_index, node_id in placement.items():
                try:
                    resp = self._raylet(node_id).call(
                        "prepare_bundle",
                        {"pg": pg, "bundle_index": bundle_index}, timeout=15)
                    if not resp.get("ok"):
                        ok = False
                        break
                    prepared.append((node_id, bundle_index))
                except Exception:  # noqa: BLE001 — any failure aborts the attempt
                    logger.debug("prepare_bundle on %s failed", node_id,
                                 exc_info=True)
                    ok = False
                    break
            if not ok:
                for node_id, bundle_index in prepared:
                    try:
                        self._raylet(node_id).call(
                            "cancel_bundle", {"pg_id": pg.pg_id,
                                              "bundle_index": bundle_index}, timeout=15)
                    except Exception:  # noqa: BLE001 — rollback is best-effort
                        logger.debug("cancel_bundle on %s failed", node_id,
                                     exc_info=True)
                time.sleep(0.2)
                continue
            for node_id, bundle_index in prepared:
                self._raylet(node_id).call(
                    "commit_bundle", {"pg_id": pg.pg_id, "bundle_index": bundle_index},
                    timeout=15)
            with self._lock:
                pg.state = "CREATED"
                pg.bundle_locations = dict(placement)
            self.pubsub.publish(CH_PG, pg.pg_id.binary(), {"state": "CREATED"})
            return
        with self._lock:
            pg = self.placement_groups.get(pg_id)
            if pg is not None and pg.state == "PENDING":
                pg.state = "INFEASIBLE"
        self.pubsub.publish(CH_PG, pg_id.binary(), {"state": "INFEASIBLE"})

    def _plan_bundles(self, pg: PlacementGroupInfo) -> Optional[Dict[int, NodeID]]:
        with self._lock:
            nodes = [n for n in self.nodes.values() if n.state == "ALIVE"]
            avail = {n.node_id: dict(n.resources_available) for n in nodes}

        def fits(node_id, bundle):
            return all(avail[node_id].get(r, 0) >= amt for r, amt in bundle.items())

        def take(node_id, bundle):
            for r, amt in bundle.items():
                avail[node_id][r] = avail[node_id].get(r, 0) - amt

        placement: Dict[int, NodeID] = {}
        order = list(range(len(pg.bundles)))
        if pg.strategy in (PlacementStrategy.STRICT_PACK,):
            for n in nodes:
                trial = {r: v for r, v in avail[n.node_id].items()}
                if all(all(trial.get(r, 0) >= amt for r, amt in b.items()) or True
                       for b in pg.bundles):
                    # check cumulative fit
                    ok = True
                    for b in pg.bundles:
                        if all(trial.get(r, 0) >= amt for r, amt in b.items()):
                            for r, amt in b.items():
                                trial[r] -= amt
                        else:
                            ok = False
                            break
                    if ok:
                        return {i: n.node_id for i in order}
            return None
        if pg.strategy == PlacementStrategy.STRICT_SPREAD:
            if len(pg.bundles) > len(nodes):
                return None
            used: Set[NodeID] = set()
            for i in order:
                chosen = next((n.node_id for n in nodes
                               if n.node_id not in used and fits(n.node_id, pg.bundles[i])),
                              None)
                if chosen is None:
                    return None
                used.add(chosen)
                take(chosen, pg.bundles[i])
                placement[i] = chosen
            return placement
        # PACK / SPREAD: best effort
        prefer_spread = pg.strategy == PlacementStrategy.SPREAD
        last: Optional[NodeID] = None
        for i in order:
            cands = [n.node_id for n in nodes if fits(n.node_id, pg.bundles[i])]
            if not cands:
                return None
            if prefer_spread:
                fresh = [c for c in cands if c != last]
                chosen = (fresh or cands)[0]
            else:
                chosen = cands[0]
            take(chosen, pg.bundles[i])
            placement[i] = chosen
            last = chosen
        return placement

    def handle_remove_placement_group(self, conn: Connection, data: Dict[str, Any]):
        self._remove_placement_group(data["pg_id"])
        return {}

    def _remove_placement_group(self, pg_id: PlacementGroupID):
        with self._lock:
            pg = self.placement_groups.get(pg_id)
            if pg is None or pg.state == "REMOVED":
                return
            pg.state = "REMOVED"
            locations = dict(pg.bundle_locations)
        for bundle_index, node_id in locations.items():
            try:
                self._raylet(node_id).call(
                    "return_bundle", {"pg_id": pg_id, "bundle_index": bundle_index},
                    timeout=15)
            except Exception:  # noqa: BLE001 — node may be dead; resources die with it
                logger.debug("return_bundle on %s failed", node_id,
                             exc_info=True)
        self.pubsub.publish(CH_PG, pg_id.binary(), {"state": "REMOVED"})

    def handle_get_placement_group(self, conn: Connection, data: Dict[str, Any]):
        with self._lock:
            pg = self.placement_groups.get(data["pg_id"])
            if pg is None:
                return {"known": False}
            return {"known": True, "state": pg.state,
                    "bundle_locations": {i: n for i, n in pg.bundle_locations.items()},
                    "bundles": pg.bundles, "strategy": pg.strategy.value,
                    "name": pg.name}

    def handle_get_named_placement_group(self, conn: Connection,
                                         data: Dict[str, Any]):
        """Lookup by name (reference `ray.util.get_placement_group` ->
        GcsPlacementGroupManager name index)."""
        name = data["name"]
        with self._lock:
            for pg in self.placement_groups.values():
                if pg.name == name and pg.state != "REMOVED":
                    return {"found": True, "pg_id": pg.pg_id,
                            "bundles": pg.bundles,
                            "strategy": pg.strategy.value}
        return {"found": False}

    # --------------------------------------------------------- task events

    # ------------------------------------------------------ job submission

    @property
    def job_manager(self):
        """Lazy JobManager (spawns driver subprocesses for submitted jobs,
        reference job_manager.py:507)."""
        with self._lock:
            if getattr(self, "_job_manager", None) is None:
                import tempfile

                from ray_tpu_torch.job_submission.manager import JobManager

                self._job_manager = JobManager(
                    self.address,
                    log_dir=os.path.join(tempfile.gettempdir(),
                                         "ray_tpu_torch_jobs"))
            return self._job_manager

    def handle_submit_job(self, conn: Connection, data: Dict[str, Any]):
        if not GLOBAL_CONFIG.job_agent_enabled:
            try:
                sid = self.job_manager.submit(
                    data["entrypoint"],
                    submission_id=data.get("submission_id"),
                    runtime_env=data.get("runtime_env"),
                    metadata=data.get("metadata"))
                return {"submission_id": sid}
            except (ValueError, RuntimeError) as e:
                return {"error": str(e)}
        import uuid

        from ray_tpu_torch.core.runtime_env import env_hash
        from ray_tpu_torch.tenancy.registry import TenantSpec

        sid = data.get("submission_id") or f"raysubmit_{uuid.uuid4().hex[:16]}"
        tenant = data.get("tenant")
        try:
            if isinstance(tenant, str) and tenant:
                qos = TenantSpec(name=tenant).qos()
            elif isinstance(tenant, dict):
                qos = TenantSpec(**tenant).qos()
            else:
                qos = {}
        except (TypeError, ValueError) as e:
            return {"error": f"bad tenant spec: {e}"}
        renv = data.get("runtime_env") or {}
        rec = _jobstate.new_record(
            sid, data["entrypoint"], renv, data.get("metadata"),
            qos, env_hash(renv), time.time())
        with self._lock:
            if sid in self.submitted_jobs:
                return {"error": f"submission_id {sid!r} already exists"}
            self.submitted_jobs[sid] = rec
            self.submitted_job_logs[sid] = deque()
        # Forge pre-warm rides the submit event (not dispatch): every
        # node may host this job's WORKERS, so every raylet gets the
        # chance to stand up the per-env template before the first task.
        if renv.get("preimports"):
            self.pubsub.publish(CH_JOB, b"*", {
                "event": "submitted", "submission_id": sid,
                "runtime_env": dict(renv)})
        self._exec.submit(self._dispatch_submitted_job, sid)
        return {"submission_id": sid}

    def _dispatch_submitted_job(self, sid: str):
        """Place a SUBMITTED job on the least-loaded alive node's agent.
        No alive node -> the record parks (node_id None) and the next
        register_node re-kicks this dispatch."""
        with self._lock:
            rec = self.submitted_jobs.get(sid)
            if rec is None or rec["state"] != _jobstate.SUBMITTED \
                    or rec["node_id"] is not None:
                return
            alive = [n for n in self.nodes.values() if n.state == "ALIVE"]
            if not alive:
                return  # parked; register_node re-kicks
            load: Dict[str, int] = {}
            for r in self.submitted_jobs.values():
                if r["node_id"] and not _jobstate.is_terminal(r):
                    load[r["node_id"]] = load.get(r["node_id"], 0) + 1
            target = min(alive,
                         key=lambda n: load.get(n.node_id.hex(), 0))
            rec["node_id"] = target.node_id.hex()
            node_id = target.node_id
            entrypoint = rec["entrypoint"]
            renv = dict(rec["runtime_env"])
        try:
            self._raylet(node_id).call(
                "agent_run_job",
                {"submission_id": sid, "entrypoint": entrypoint,
                 "runtime_env": renv}, timeout=30)
        except Exception as e:  # noqa: BLE001 — node died under us
            self._job_terminal_transition(
                sid, _jobstate.FAILED,
                f"dispatch to node {node_id.hex()[:12]} failed: {e}")
            return
        # stop_job racing the dispatch: it flipped the record to STOPPED
        # before the agent knew the job — the stop RPC found nothing to
        # kill, so the kill is ours to deliver now that the agent does.
        with self._lock:
            stopped = (rec["state"] == _jobstate.STOPPED)
        if stopped:
            self._agent_stop(sid, node_id.hex())

    def _agent_stop(self, sid: str, node_hex: str):
        try:
            self._raylet(NodeID.from_hex(node_hex)).call(
                "agent_stop_job", {"submission_id": sid}, timeout=10)
        except Exception:  # noqa: BLE001 — node dead: nothing to kill
            logger.debug("agent_stop_job for %s failed", sid, exc_info=True)

    def _job_terminal_transition(self, sid: str, state: str,
                                 message: str = "") -> bool:
        """Single writer for terminal job states: first terminal wins
        (an agent's late FAILED report must not overwrite a client's
        STOPPED, and vice versa)."""
        with self._lock:
            rec = self.submitted_jobs.get(sid)
            if rec is None or _jobstate.is_terminal(rec):
                return False
            rec["state"] = state
            rec["message"] = message
            rec["end_time"] = time.time()
            driver_hex = rec.get("driver_job_id") or ""
        # A job that dies before its driver registers never reaches the
        # driver-side _finish_job publish — without this, sid-owned
        # per-env forge refs on the raylets would leak. Raylet handling
        # is idempotent, so the double publish on the normal path (this
        # + driver disconnect) is harmless.
        self.pubsub.publish(CH_JOB, b"*",
                            {"event": "finished", "job_id": driver_hex,
                             "submission_id": sid})
        return True

    # Agent-report endpoints (called by jobs/agent.py on each raylet).

    def handle_job_started(self, conn: Connection, data: Dict[str, Any]):
        sid = data["submission_id"]
        with self._lock:
            rec = self.submitted_jobs.get(sid)
            if rec is None or _jobstate.is_terminal(rec):
                # Deleted or stopped while the spawn was in flight; the
                # stop path already told (or will tell) the agent.
                return {"stale": True}
            rec["state"] = _jobstate.RUNNING
            rec["start_time"] = time.time()
            rec["driver_pid"] = data.get("pid")
        return {}

    def handle_job_terminal(self, conn: Connection, data: Dict[str, Any]):
        sid = data["submission_id"]
        rc = data.get("returncode", -1)
        if data.get("stopped"):
            state, msg = _jobstate.STOPPED, "stopped"
        elif rc == 0:
            state, msg = _jobstate.SUCCEEDED, ""
        else:
            state = _jobstate.FAILED
            msg = data.get("message") or f"entrypoint exited with code {rc}"
        self._job_terminal_transition(sid, state, msg)
        return {}

    def handle_job_log_append(self, conn: Connection, data: Dict[str, Any]):
        sid = data["submission_id"]
        lines: List[str] = data.get("lines") or []
        dropped = int(data.get("dropped") or 0)
        budget = max(1024, GLOBAL_CONFIG.job_log_tail_bytes)
        with self._lock:
            rec = self.submitted_jobs.get(sid)
            buf = self.submitted_job_logs.get(sid)
            if buf is None:
                return {"stale": True}  # job deleted; drop the tail
            buf.extend(lines)
            if dropped:
                buf.append(f"... {dropped} log lines dropped (rate limit)")
            size = sum(len(ln) + 1 for ln in buf)
            while buf and size > budget:
                size -= len(buf.popleft()) + 1
            pid = (rec or {}).get("driver_pid") or 0
        # Republish on the LOG plane in the driver-print shape; keyed by
        # the submission id, so interactive drivers (filtering on their
        # own job hex) never see another job's output, while tail_job_logs
        # subscribers and the dashboard do.
        if lines or dropped:
            self.pubsub.publish(CH_LOG, b"*", {
                "worker": f"job:{sid[:12]}", "pid": pid, "job": sid,
                "lines": [("stdout", ln) for ln in lines],
                "dropped": dropped})
        return {}

    # Client-facing job queries: the submitted-job table answers first;
    # anything it doesn't know falls back to the legacy in-GCS manager
    # (only if one was ever created — querying must not instantiate it).

    @property
    def _legacy_job_manager(self):
        if not GLOBAL_CONFIG.job_agent_enabled:
            return self.job_manager
        return getattr(self, "_job_manager", None)

    def handle_job_info(self, conn: Connection, data: Dict[str, Any]):
        sid = data["submission_id"]
        with self._lock:
            rec = self.submitted_jobs.get(sid)
            if rec is not None:
                return {"found": True,
                        "details": _jobstate.public_details(rec)}
        legacy = self._legacy_job_manager
        details = legacy.details(sid) if legacy is not None else None
        if details is None:
            return {"found": False}
        return {"found": True, "details": details}

    def handle_job_logs(self, conn: Connection, data: Dict[str, Any]):
        sid = data["submission_id"]
        with self._lock:
            buf = self.submitted_job_logs.get(sid)
            if buf is not None:
                text = "\n".join(buf) + ("\n" if buf else "")
                return {"found": True, "logs": text}
            known = sid in self.submitted_jobs
        if known:
            return {"found": True, "logs": ""}
        legacy = self._legacy_job_manager
        logs = legacy.logs(sid) if legacy is not None else None
        if logs is None:
            return {"found": False}
        return {"found": True, "logs": logs}

    def handle_stop_job(self, conn: Connection, data: Dict[str, Any]):
        sid = data["submission_id"]
        node_hex = None
        with self._lock:
            rec = self.submitted_jobs.get(sid)
            if rec is not None:
                if _jobstate.is_terminal(rec):
                    return {"stopped": False}
                rec["state"] = _jobstate.STOPPED
                rec["message"] = "stopped"
                rec["end_time"] = time.time()
                node_hex = rec["node_id"]
        if rec is not None:
            # Release sid-owned prewarm refs now; the driver's own
            # teardown (disconnect -> _finish_job) publishes the
            # job_id-carrying finished event once the kill lands.
            self.pubsub.publish(CH_JOB, b"*",
                                {"event": "finished", "job_id": "",
                                 "submission_id": sid})
            if node_hex:
                # Off the RPC thread: the agent's stop is fire-and-forget
                # from the client's perspective (status is already
                # STOPPED; the kill handshake runs on the node).
                self._exec.submit(self._agent_stop, sid, node_hex)
            return {"stopped": True}
        legacy = self._legacy_job_manager
        return {"stopped": legacy.stop(sid) if legacy is not None else False}

    def handle_delete_job(self, conn: Connection, data: Dict[str, Any]):
        sid = data["submission_id"]
        with self._lock:
            rec = self.submitted_jobs.get(sid)
            if rec is not None:
                if not _jobstate.is_terminal(rec):
                    return {"deleted": False}
                del self.submitted_jobs[sid]
                self.submitted_job_logs.pop(sid, None)
                return {"deleted": True}
        legacy = self._legacy_job_manager
        return {"deleted": legacy.delete(sid) if legacy is not None
                else False}

    def handle_list_jobs(self, conn: Connection, data=None):
        with self._lock:
            out = [_jobstate.public_details(rec)
                   for rec in self.submitted_jobs.values()]
        legacy = self._legacy_job_manager
        if legacy is not None:
            out.extend(legacy.list())
        return out

    # ------------------------------------------------------- metrics export

    _METRICS_TTL_S = 30.0
    # A reporter is stale after this many missed flush periods (it sends
    # its period with every report), or immediately once its node is DEAD
    # — a dead worker/replica must not serve its last snapshot from
    # /metrics forever.
    _METRICS_STALE_PERIODS = 5

    def handle_metrics_report(self, conn: Connection, data: Dict[str, Any]):
        """A process pushed its metric registry snapshot (reference
        metrics_agent.py:375 harvest path) — and, piggybacked on the same
        cadence, its tracing flight-recorder spans."""
        spans = data.get("spans")
        with self._lock:
            self.metrics[data["reporter"]] = {
                "metrics": data["metrics"], "ts": data.get("ts", time.time()),
                "period": data.get("period_s"), "node": data.get("node")}
            if spans:
                cap = max(1, GLOBAL_CONFIG.trace_gcs_max_spans)
                proc = data["reporter"]
                for span in spans:
                    span["proc"] = proc
                    while len(self.trace_spans) >= cap:
                        self.trace_spans.popleft()
                        self.trace_dropped += 1
                    self.trace_spans.append(span)
            self.trace_dropped += int(data.get("spans_dropped") or 0)
        return {}

    def _live_metrics(self) -> Dict[str, List]:
        now = time.time()
        with self._lock:
            dead_nodes = {n.node_id.hex() for n in self.nodes.values()
                          if n.state != "ALIVE"}
            stale = []
            for r, e in self.metrics.items():
                ttl = max(self._METRICS_TTL_S,
                          self._METRICS_STALE_PERIODS
                          * float(e.get("period") or 0.0))
                if e["ts"] < now - ttl or (e.get("node") in dead_nodes
                                           and e.get("node")):
                    stale.append(r)
            for r in stale:
                del self.metrics[r]
            self._stale_reporters_total += len(stale)
            out = {r: e["metrics"] for r, e in self.metrics.items()}
            # Synthetic GCS-side gauge: how many reporter snapshots have
            # been expired as stale over this GCS's lifetime.
            out["gcs"] = [{
                "name": "metrics_stale_reporters", "kind": "gauge",
                "description": "metric reporter snapshots expired as stale "
                               "(reporter stopped flushing or node died)",
                "series": [[[], float(self._stale_reporters_total)]]}]
            return out

    def handle_metrics_snapshot(self, conn: Connection, data=None):
        return self._live_metrics()

    def handle_metrics_prometheus(self, conn: Connection, data=None):
        from ray_tpu_torch.util.metrics import render_prometheus

        return {"text": render_prometheus(self._live_metrics())}

    # ------------------------------------------------------- trace export

    def handle_trace_get(self, conn: Connection, data: Dict[str, Any]):
        """Every stored span of one trace (the /api/traces/<id> feed)."""
        trace_id = data["trace_id"]
        with self._lock:
            spans = [s for s in self.trace_spans
                     if s.get("trace_id") == trace_id]
        return {"spans": spans}

    def handle_trace_timeline(self, conn: Connection, data=None):
        """Spans for the Chrome-trace timeline. `window_s` keeps only
        spans that ended within the last window; `limit` caps the span
        count (newest win) so a huge trace buffer cannot OOM the JSON
        encoder downstream."""
        data = data or {}
        window = data.get("window_s")
        limit = data.get("limit")
        with self._lock:
            spans = list(self.trace_spans)
            dropped = self.trace_dropped
        if window:
            cutoff = time.time() - float(window)
            spans = [s for s in spans if (s.get("end") or 0) >= cutoff]
        truncated = 0
        if limit is not None and len(spans) > int(limit):
            truncated = len(spans) - int(limit)
            spans = spans[-int(limit):]
        return {"spans": spans, "dropped": dropped, "truncated": truncated}

    def handle_add_task_events(self, conn: Connection, data: Dict[str, Any]):
        with self._lock:
            self.task_events.extend(data["events"])
        return {}

    def handle_get_task_events(self, conn: Connection, data: Dict[str, Any]):
        limit = (data or {}).get("limit", 10000)
        with self._lock:
            events = list(self.task_events)[-limit:]
        return {"events": events}

    # --------------------------------------------------------------- misc

    def handle_resource_demand(self, conn: Connection, data=None):
        """Aggregated scale-up signal for the autoscaler: queued shapes from
        every live node plus explicit request_resources bundles."""
        with self._lock:
            shapes: List[Dict[str, float]] = []
            for node_id, demand in self.node_demand.items():
                info = self.nodes.get(node_id)
                if info is not None and info.state == "ALIVE":
                    shapes.extend(demand)
            return {"demand": shapes,
                    "requests": list(self.resource_requests)}

    def handle_request_resources(self, conn: Connection, data: Dict[str, Any]):
        """reference `autoscaler.sdk.request_resources`: pin a floor of
        cluster capacity independent of current queue state."""
        with self._lock:
            self.resource_requests = list(data.get("bundles") or [])
        return {}

    def handle_cluster_resources(self, conn: Connection, data=None):
        totals: Dict[str, float] = defaultdict(float)
        avail: Dict[str, float] = defaultdict(float)
        with self._lock:
            for n in self.nodes.values():
                if n.state != "ALIVE":
                    continue
                for r, v in n.resources_total.items():
                    totals[r] += v
                for r, v in n.resources_available.items():
                    avail[r] += v
        return {"total": dict(totals), "available": dict(avail)}

def main():  # standalone GCS for multi-host deployments
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6379)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    gcs = GcsServer(host=args.host, port=args.port)
    gcs.start()
    logger.info("GCS listening on %s", gcs.address)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        gcs.stop()


if __name__ == "__main__":
    main()
