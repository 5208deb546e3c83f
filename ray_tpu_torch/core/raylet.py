"""Raylet: per-node manager — local scheduler, worker pool, object manager.

Equivalent of the reference's raylet process (`src/ray/raylet/node_manager.h`):
the worker lease/dispatch protocol (`HandleRequestWorkerLease`), two-level
scheduling with spillback (`cluster_task_manager.h`, hybrid policy in
`policy/hybrid_scheduling_policy.h`), the worker pool (`worker_pool.h:156`),
dependency management (`dependency_manager.h`), placement-group bundle
2PC resources (`placement_group_resource_manager.h`), and the node's
shared-memory object store + node-to-node transfer (`object_manager.h`).

Differences from the reference, deliberate for the accelerator design:
- Tasks are submitted to a raylet and dispatched to workers by the raylet
  (one hop) instead of the lease-then-direct-push protocol; actor calls are
  direct client->worker (matching the reference's direct actor transport).
- GPUs are node resources. The raylet keeps the node's card ids; a worker
  spawned for a GPU grant gets `CUDA_VISIBLE_DEVICES` set to the cards it
  was assigned (held until it exits) and the grant marker
  `RAY_TPU_TORCH_GRANTED_GPU` that lease matching reads; every other
  worker gets `CUDA_VISIBLE_DEVICES=""` and sees no card. (The JAX
  package's counterpart pins CPU workers with `JAX_PLATFORMS=cpu` and gives
  one TPU-granted process all of a host's chips.)
- Worker spawning is two-path: a per-node forkserver template (the worker
  forge, core/worker_forge.py) forks fully-imported workers in ~10-20ms
  for fork-compatible grants; cold `exec` spawn remains the fallback and
  the GPU-grant path (a forked process must not inherit CUDA state).
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
import struct
import subprocess
import sys
import threading
import time
import weakref
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import msgpack

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.common import CPU, GPU, GPU_GRANT, NodeInfo, TaskSpec
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, PlacementGroupID, WorkerID
from ray_tpu_torch.core.object_store import ObjectStoreFullError, SharedMemoryStore
from ray_tpu_torch.core.rpc import (
    DEFERRED,
    Connection,
    ConnectionLost,
    ReconnectingClient,
    RpcClient,
    RpcServer,
)
from ray_tpu_torch.core.worker_forge import ForgeUnavailable, WorkerForge
from ray_tpu_torch.exceptions import RaySystemError
from ray_tpu_torch.jobs.agent import JobAgent
from ray_tpu_torch.jobs.tenancy import JobAdmission
from ray_tpu_torch.observability import tracing as _tracing

logger = logging.getLogger(__name__)


def _marker_preimports(env_extra: Optional[Dict[str, str]]) -> List[str]:
    """The runtime_env `preimports` set riding in a grant's
    RAY_TPU_TORCH_RUNTIME_ENV marker (runtime_env.granted_env) — what routes a
    spawn to its per-env forge template."""
    marker = (env_extra or {}).get("RAY_TPU_TORCH_RUNTIME_ENV")
    if not marker:
        return []
    try:
        return list(json.loads(marker).get("preimports") or [])
    except (ValueError, AttributeError):
        return []


# --------------------------------------------------------------------------- #
# Resource accounting
# --------------------------------------------------------------------------- #


class ResourceManager:
    """Local resource ledger (reference `local_resource_manager.h`), including
    dynamically added placement-group bundle resources."""

    def __init__(self, total: Dict[str, float]):
        self._lock = threading.Lock()
        self.total: Dict[str, float] = dict(total)
        self.available: Dict[str, float] = dict(total)
        # Streaming gossip hook (reference ray_syncer.proto: raylets STREAM
        # resource deltas instead of waiting for the heartbeat period):
        # called outside the lock after any ledger change; the raylet wires
        # it to a coalescing delta-push loop.
        self.on_change = None

    def _changed(self):
        cb = self.on_change
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — gossip is best-effort
                pass

    def try_acquire(self, request: Dict[str, float]) -> bool:
        with self._lock:
            if all(self.available.get(r, 0.0) + 1e-9 >= amt for r, amt in request.items()):
                for r, amt in request.items():
                    self.available[r] = self.available.get(r, 0.0) - amt
                ok = True
            else:
                ok = False
        if ok:
            self._changed()
        return ok

    def release(self, request: Dict[str, float]):
        with self._lock:
            for r, amt in request.items():
                self.available[r] = self.available.get(r, 0.0) + amt
        self._changed()

    def feasible(self, request: Dict[str, float]) -> bool:
        with self._lock:
            return all(self.total.get(r, 0.0) >= amt for r, amt in request.items())

    def add_resources(self, resources: Dict[str, float]):
        with self._lock:
            for r, amt in resources.items():
                self.total[r] = self.total.get(r, 0.0) + amt
                self.available[r] = self.available.get(r, 0.0) + amt
        self._changed()

    def remove_resources(self, resources: Dict[str, float]):
        with self._lock:
            for r, amt in resources.items():
                self.total[r] = self.total.get(r, 0.0) - amt
                self.available[r] = self.available.get(r, 0.0) - amt
                if abs(self.total[r]) < 1e-9:
                    self.total.pop(r, None)
                    self.available.pop(r, None)
        self._changed()

    def set_total(self, name: str, capacity: float) -> None:
        """Atomically set one resource's TOTAL capacity (dynamic custom
        resources): the read-modify-write must not race concurrent
        bundle add/remove or another set."""
        with self._lock:
            delta = capacity - self.total.get(name, 0.0)
            self.total[name] = self.total.get(name, 0.0) + delta
            self.available[name] = self.available.get(name, 0.0) + delta
            # Delete only when nothing is outstanding: a running task's
            # debt (available < total) must survive a zeroing so its
            # eventual release() can't mint capacity from nowhere.
            if abs(self.total[name]) < 1e-9 \
                    and abs(self.available[name]) < 1e-9:
                self.total.pop(name, None)
                self.available.pop(name, None)
        self._changed()

    def snapshot(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        with self._lock:
            return dict(self.total), dict(self.available)


# --------------------------------------------------------------------------- #
# Worker pool
# --------------------------------------------------------------------------- #


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    pid: int
    conn: Optional[Connection] = None
    # subprocess.Popen for cold spawns, worker_forge._ForgedProc (same
    # poll/wait/terminate/kill surface) for forge forks.
    proc: Optional[Any] = None
    state: str = "starting"          # starting | idle | busy | dead
    # How the process came to be: "forge" (forked from the warm template)
    # or "cold" (exec + full imports).
    spawn_kind: str = "cold"
    # Set when the worker registers its connection — and on death, so
    # spawn-waiters (actor creation) wake on either outcome instead of
    # polling.
    registered: threading.Event = field(default_factory=threading.Event)
    current_task: Optional[TaskSpec] = None
    is_actor: bool = False
    actor_id: Optional[ActorID] = None
    direct_address: Optional[str] = None
    last_idle: float = field(default_factory=time.monotonic)
    # env granted at spawn (e.g. the GPU grant marker)
    granted_env: Dict[str, str] = field(default_factory=dict)
    # Cards this worker was given at spawn (its CUDA_VISIBLE_DEVICES); the
    # pool counts them as taken until the worker is dead.
    gpu_ids: List[str] = field(default_factory=list)
    # Resources held for this worker's lifetime (actor workers hold their
    # creation-task resources until death, like the reference's leases).
    held_resources: Dict[str, float] = field(default_factory=dict)
    # When the current task was dispatched (memory_monitor kills newest
    # first) and, if the OOM killer chose this worker, why.
    task_started: float = 0.0
    oom_kill_reason: Optional[str] = None
    # When mark_dead ran: the reaper prunes long-dead handles from the
    # pool after a grace window (late exit events / by-id lookups still
    # resolve inside it) so worker churn cannot grow the pool forever.
    died_at: float = 0.0


class WorkerPool:
    """Spawns and leases Python worker processes (reference `worker_pool.h`)."""

    def __init__(self, raylet: "Raylet", max_workers: int = 64):
        self._raylet = raylet
        self._lock = threading.RLock()
        self._workers: Dict[WorkerID, WorkerHandle] = {}
        self._starting = 0
        self.max_workers = max_workers
        # Spawn-path accounting (bench/tests assert the forge engages).
        self.spawn_counts: Dict[str, int] = {"forge": 0, "cold": 0}
        # Crash-loop guard: consecutive startup deaths throttle respawns.
        self.consecutive_startup_failures = 0
        self.last_startup_failure = 0.0

    def _spawn_env_delta(self, worker_id: WorkerID,
                         env_extra: Optional[Dict[str, str]]
                         ) -> Dict[str, str]:
        """Worker-specific env on top of this raylet's own environment —
        the full spawn env for a cold exec is os.environ + this delta; a
        forge fork applies ONLY the delta (the template already inherited
        the raylet env at forge start)."""
        delta: Dict[str, str] = {}
        delta.update(GLOBAL_CONFIG.to_env())
        if GPU_GRANT not in (env_extra or {}):
            # CPU-only worker: no card is visible, so user code touching
            # CUDA cannot take a card another process was granted. Card
            # access flows through GPU resource grants only; spawn_worker
            # sets the granted worker's cards.
            delta["CUDA_VISIBLE_DEVICES"] = ""
        delta.update(env_extra or {})
        # Workers must resolve ray_tpu_torch (and the driver's modules) even when
        # the driver got them via sys.path manipulation rather than an
        # installed package: propagate package root + cwd on PYTHONPATH.
        import ray_tpu_torch as _pkg

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(_pkg.__file__)))
        extra_paths = [pkg_root, os.getcwd()]
        # A grant-supplied PYTHONPATH (runtime_env env_vars) overrides the
        # raylet's own, exactly as env_extra overrode os.environ in the
        # flat-env spawn — dropping it would lose the user's module roots.
        existing = delta.get("PYTHONPATH") or os.environ.get("PYTHONPATH", "")
        parts = [p for p in extra_paths if p] + ([existing] if existing else [])
        delta["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
        delta["RAY_TPU_TORCH_WORKER_ID"] = worker_id.hex()
        delta["RAY_TPU_TORCH_RAYLET_ADDRESS"] = self._raylet.server.address
        delta["RAY_TPU_TORCH_GCS_ADDRESS"] = self._raylet.gcs_address
        delta["RAY_TPU_TORCH_NODE_ID"] = self._raylet.node_id.hex()
        delta["RAY_TPU_TORCH_SESSION"] = self._raylet.session_suffix
        delta["RAY_TPU_TORCH_SESSION_DIR"] = self._raylet.session_dir
        return delta

    def forge_available(self, env_extra: Optional[Dict[str, str]]) -> bool:
        """Would a spawn for this grant take the millisecond fork path?"""
        forge = self._raylet.forge_for(env_extra)
        return (forge is not None and forge.alive
                and WorkerForge.compatible(env_extra or {}))

    def spawn_worker(self, env_extra: Optional[Dict[str, str]] = None,
                     kind: Optional[str] = None) -> WorkerHandle:
        """Start a worker process: forge fork when the template is up and
        the grant is fork-compatible, cold exec otherwise. `kind` pins the
        path ("forge" raises ForgeUnavailable instead of falling back —
        bench/test hook). Never called with the pool or raylet lock held:
        the forge spawn is a socket round trip."""
        worker_id = WorkerID.from_random()
        delta = self._spawn_env_delta(worker_id, env_extra)
        log_dir = os.path.join(self._raylet.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{worker_id.hex()[:12]}.out")
        # Register the handle BEFORE the process exists: a forge fork can
        # connect and register within ~10ms, faster than this (possibly
        # GIL-starved) thread gets scheduled again after the spawn reply —
        # a post-spawn insert would make the raylet refuse its own
        # worker's registration.
        handle = WorkerHandle(worker_id=worker_id, pid=0, proc=None,
                              spawn_kind="cold")
        handle.granted_env = env_extra or {}
        if GPU_GRANT in handle.granted_env:
            handle.gpu_ids = self._assign_gpus(
                float(handle.granted_env[GPU_GRANT]))
            delta["CUDA_VISIBLE_DEVICES"] = ",".join(handle.gpu_ids)
        spawn_span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            # Roots its own trace (spawns are demand-driven, not tied to
            # one request); the kind attr lands once the path is known.
            spawn_span = _tracing.get_tracer().start_span(
                "worker.spawn",
                attrs={"worker": worker_id.hex()[:12],
                       "node": self._raylet.node_id.hex()[:12]})
        with self._lock:
            self._workers[worker_id] = handle
            self._starting += 1
        # Per-runtime-env routing: a grant carrying preimports forks from
        # its own template (warm module set), everything else from the
        # node-wide default.
        forge = self._raylet.forge_for(env_extra)
        proc = None
        spawn_err: Optional[str] = None
        try:
            if kind != "cold" and forge is not None \
                    and WorkerForge.compatible(env_extra or {}):
                try:
                    proc = forge.spawn(delta, os.getcwd(), log_path)
                    handle.spawn_kind = "forge"
                except ForgeUnavailable as e:
                    if kind == "forge":
                        raise
                    logger.debug("forge spawn unavailable (%s): cold "
                                 "fallback", e)
                    forge.restart_async()
            elif kind == "forge":
                raise ForgeUnavailable(
                    "forge disabled or env fork-incompatible")
            if proc is None:
                env = dict(os.environ)
                env.update(delta)
                out = open(log_path, "ab")
                proc = subprocess.Popen(
                    [sys.executable, "-u", "-m", "ray_tpu_torch.core.worker"],
                    env=env,
                    stdout=out,
                    stderr=subprocess.STDOUT,
                    cwd=os.getcwd(),
                )
                out.close()  # Popen holds its own dup
        except BaseException as e:
            # No process came to be: unwind the optimistic registration.
            spawn_err = f"{type(e).__name__}: {e}"
            self.mark_dead(worker_id)
            raise
        finally:
            spawn_span.set_attr("kind", handle.spawn_kind)
            spawn_span.end(error=spawn_err)
        handle.pid = proc.pid
        handle.proc = proc
        with self._lock:
            self.spawn_counts[handle.spawn_kind] += 1
        # Event-driven exit detection from birth (satellite of the forge
        # work): cold spawns get a waiter thread; forge forks are covered
        # by the template's exit-event stream.
        self._raylet._watch_worker(handle)
        if proc.poll() is not None and handle.state != "dead":
            # Exit raced the spawn reply (the forge's event stream cannot
            # attribute a pid the pool hadn't seen yet): reap here.
            self._raylet._on_worker_dead(
                handle, f"process exited with code {proc.returncode}")
        return handle

    def on_worker_registered(self, worker_id: WorkerID, conn: Connection,
                             direct_address: str) -> Optional[WorkerHandle]:
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is None:
                return None
            handle.conn = conn
            handle.direct_address = direct_address
            if handle.state == "starting":
                self._starting -= 1
                handle.state = "idle"
                handle.last_idle = time.monotonic()
            self.consecutive_startup_failures = 0
        handle.registered.set()
        return handle

    def pop_idle(self, required_env: Optional[Dict[str, str]] = None
                 ) -> Optional[WorkerHandle]:
        """Lease an idle worker whose granted env matches the task's
        requirement (reference worker_pool lease matching): a GPU task must
        run in a worker started with the GPU grant env, and a GPU-granted
        worker must not serve plain CPU tasks."""
        want = required_env or {}
        with self._lock:
            for h in self._workers.values():
                # oom_kill_reason: the memory monitor has condemned this
                # worker; a SIGKILL is in flight — leasing it would get a
                # fresh task killed and blamed with the old task's OOM.
                if (h.state == "idle" and not h.is_actor
                        and h.granted_env == want
                        and not h.oom_kill_reason):
                    h.state = "busy"
                    return h
            return None

    def pop_idle_mismatched(self, want: Dict[str, str]) -> Optional[WorkerHandle]:
        """Longest-idle worker whose granted env does NOT match `want` —
        retired by the dispatcher when the pool is at capacity but no
        env-compatible worker exists (prevents a wedged pool of idle
        workers none of which can serve the queued task)."""
        with self._lock:
            candidates = [h for h in self._workers.values()
                          if h.state == "idle" and not h.is_actor
                          and h.granted_env != want]
            if not candidates:
                return None
            h = min(candidates, key=lambda x: x.last_idle)
            h.state = "busy"  # reserve so nothing else grabs it
            return h

    def push_idle(self, handle: WorkerHandle):
        with self._lock:
            if handle.state != "dead":
                handle.state = "idle"
                handle.current_task = None
                handle.last_idle = time.monotonic()

    def num_starting(self) -> int:
        with self._lock:
            return self._starting

    def num_alive(self, include_actors: bool = True) -> int:
        """Live workers. The pool cap governs *task* workers: dedicated
        actor workers are bounded by their own resource grants, and
        counting them would wedge a node whose pool fills with actors
        (no task worker could ever spawn — reference worker_pool.h keeps
        dedicated workers outside the idle-pool cap)."""
        with self._lock:
            return sum(1 for h in self._workers.values()
                       if h.state != "dead"
                       and (include_actors or not h.is_actor))

    def supply(self, want: Dict[str, str]) -> Tuple[int, int, int]:
        """Worker supply for a grant: (idle leasable workers matching the
        env, starting workers matching the env, live task workers) — the
        inputs of the spawn-ahead deficit computation. Starting workers
        are filtered by grant: an unrelated slow spawn (a GPU worker's
        cold start) must not satisfy THIS grant's demand and suppress its
        spawn. The global starting count (`num_starting`) still governs
        the cold convoy cap."""
        with self._lock:
            idle = sum(1 for h in self._workers.values()
                       if h.state == "idle" and not h.is_actor
                       and h.granted_env == want and not h.oom_kill_reason)
            starting = sum(1 for h in self._workers.values()
                           if h.state == "starting"
                           and h.granted_env == want)
            alive = sum(1 for h in self._workers.values()
                        if h.state != "dead" and not h.is_actor)
            return idle, starting, alive

    def _assign_gpus(self, gpus: float) -> List[str]:
        """Cards for a new worker granted `gpus` GPUs: ceil(gpus) of the
        node's card ids, those held by the fewest live workers first (so
        free cards go first, and fractional grants share a card only when
        none is free). Idle task workers keep their cards after a task, so
        when too few cards are free they are retired first; a worker's
        cards return to the pool when it is dead."""
        want = max(1, math.ceil(gpus))
        ids = self._raylet.gpu_ids

        def holders():
            held = dict.fromkeys(ids, 0)
            for h in self._workers.values():
                if h.state != "dead":
                    for i in h.gpu_ids:
                        held[i] = held.get(i, 0) + 1
            return held

        while True:
            with self._lock:
                held = holders()
                spare = None
                if sum(1 for n in held.values() if n == 0) < want:
                    spare = next((h for h in self._workers.values()
                                  if h.state == "idle" and not h.is_actor
                                  and h.gpu_ids), None)
                if spare is None:
                    break
                spare.state = "busy"  # reserve so nothing else leases it
            self._raylet.retire_worker(spare, "retired (cards needed)")
            # Its cards go to the new worker only once the process has
            # exited: until then its CUDA context still holds their memory.
            if spare.proc is not None:
                try:
                    spare.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    spare.proc.kill()
                    spare.proc.wait()
        if want > len(ids):
            raise RaySystemError(f"a grant of {gpus} GPUs exceeds this "
                                 f"node's {len(ids)} cards")
        return sorted(ids, key=lambda i: (held.get(i, 0), ids.index(i)))[:want]

    def mark_dead(self, worker_id: WorkerID) -> Optional[WorkerHandle]:
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is None or handle.state == "dead":
                return None
            if handle.state == "starting":
                self._starting -= 1
                self.consecutive_startup_failures += 1
                self.last_startup_failure = time.monotonic()
                if self.consecutive_startup_failures == 3:
                    log_dir = os.path.join(self._raylet.session_dir, "logs")
                    logger.error(
                        "3 consecutive workers died during startup — check "
                        "worker logs in %s. Respawns are throttled to one "
                        "per 5s until a worker starts successfully.", log_dir)
            handle.state = "dead"
            handle.died_at = time.monotonic()
        # Wake spawn-waiters (actor creation) parked on registration.
        handle.registered.set()
        return handle

    def prune_dead(self, grace_s: float = 10.0) -> int:
        """Drop handles that have been dead past the grace window (the
        raylet reaper's anti-entropy call). Without this, worker churn
        grows `_workers` by one dead WorkerHandle — Popen object, env
        dict and all — per spawn, forever (RL011's leak shape)."""
        now = time.monotonic()
        pruned = 0
        with self._lock:
            for wid, h in list(self._workers.items()):
                if h.state == "dead" and h.died_at \
                        and now - h.died_at > grace_s:
                    self._workers.pop(wid, None)
                    pruned += 1
        return pruned

    def spawn_allowed(self) -> bool:
        with self._lock:
            if self.consecutive_startup_failures < 3:
                return True
            return time.monotonic() - self.last_startup_failure > 5.0

    def by_conn(self, conn: Connection) -> Optional[WorkerHandle]:
        wid = conn.meta.get("worker_id")
        if wid is None:
            return None
        with self._lock:
            return self._workers.get(wid)

    def get(self, worker_id: WorkerID) -> Optional[WorkerHandle]:
        with self._lock:
            return self._workers.get(worker_id)

    def kill_all(self):
        with self._lock:
            handles = list(self._workers.values())
        for h in handles:
            if h.proc is not None and h.proc.poll() is None:
                try:
                    h.proc.terminate()
                except OSError:
                    pass  # already reaped
        deadline = time.monotonic() + 3
        for h in handles:
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    try:
                        h.proc.kill()
                    except OSError:
                        pass  # exited between wait and kill


# --------------------------------------------------------------------------- #
# Queued task bookkeeping
# --------------------------------------------------------------------------- #


# --------------------------------------------------------------------------- #
# Object transfer plane
# --------------------------------------------------------------------------- #
#
# Wire format of the raw `pull_object_chunk` method (raw-bytes RPC framing,
# no pickle on either side):
#   request payload:  msgpack {o: oid bytes, f: offset, l: length,
#                              p: puller node hex}
#   response payload: [4B LE meta length][msgpack meta][chunk bytes]
#     meta: {st: "ok"|"busy"|"missing", s: object size,
#            alt: [node hex, ...] redirect hints, gone: bool}
# The chunk bytes part of an "ok" reply is a memoryview slice of the sealed
# (or in-progress) store segment — the vectored send path writes it to the
# socket without an intermediate copy.

_CHUNK_META_HDR = struct.Struct("<I")


def _pack_chunk_reply(meta: Dict[str, Any], chunk=b"") -> list:
    m = msgpack.packb(meta)
    return [_CHUNK_META_HDR.pack(len(m)), m, chunk]


def _unpack_chunk_reply(raw: bytes) -> Tuple[Dict[str, Any], memoryview]:
    (mlen,) = _CHUNK_META_HDR.unpack_from(raw, 0)
    meta = msgpack.unpackb(raw[4: 4 + mlen])
    return meta, memoryview(raw)[4 + mlen:]


class _ActivePull:
    """Receiver-side state of one in-progress multi-source pull.

    Doubles as the chunk-availability index that lets this node SERVE the
    chunks it has already received while the pull is still running — the
    swarm half of the broadcast plane (a node advertises itself as a
    `partial` location the moment its buffer exists)."""

    __slots__ = ("buf", "size", "chunk_bytes", "lock", "done")

    def __init__(self, buf: memoryview, size: int, chunk_bytes: int):
        self.buf = buf
        self.size = size
        self.chunk_bytes = chunk_bytes
        self.lock = threading.Lock()
        self.done: Set[int] = set()

    def mark_done(self, idx: int):
        with self.lock:
            self.done.add(idx)

    def covers(self, offset: int, length: int) -> bool:
        """True when every chunk overlapping [offset, offset+length) has
        fully landed (the requester's chunk size may differ from ours)."""
        if offset >= self.size:
            return False
        end = min(offset + max(length, 1), self.size)
        first = offset // self.chunk_bytes
        last = (end - 1) // self.chunk_bytes
        with self.lock:
            return all(i in self.done for i in range(first, last + 1))


class _PeerSet:
    """Thread-safe rotating set of source addresses for one pull."""

    # A dropped peer may be re-added (by a directory refresh or redirect
    # hint) after this cool-down — one transient RPC failure must not
    # blacklist a node for the lifetime of a long pull, or a sole
    # surviving holder could become permanently unreachable.
    DROP_COOLDOWN_S = 5.0

    def __init__(self, max_peers: int):
        self._lock = threading.Lock()
        self._addrs: List[str] = []
        self._dead: Dict[str, float] = {}  # addr -> drop time
        self._rr = 0
        self._max = max_peers
        self._last_refresh = 0.0

    def add(self, addr: Optional[str]) -> bool:
        if not addr:
            return False
        with self._lock:
            dropped = self._dead.get(addr)
            if dropped is not None:
                if time.monotonic() - dropped < self.DROP_COOLDOWN_S:
                    return False
                del self._dead[addr]
            if addr in self._addrs or len(self._addrs) >= self._max:
                return False
            self._addrs.append(addr)
            return True

    def drop(self, addr: str):
        with self._lock:
            self._dead[addr] = time.monotonic()
            if addr in self._addrs:
                self._addrs.remove(addr)

    def next(self) -> Optional[str]:
        with self._lock:
            if not self._addrs:
                return None
            self._rr += 1
            return self._addrs[self._rr % len(self._addrs)]

    def snapshot(self) -> List[str]:
        with self._lock:
            return list(self._addrs)

    def may_refresh(self, min_interval_s: float = 0.05) -> bool:
        """Rate-limits directory re-queries across this pull's workers."""
        with self._lock:
            now = time.monotonic()
            if now - self._last_refresh < min_interval_s:
                return False
            self._last_refresh = now
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._addrs)


@dataclass
class QueuedTask:
    spec: TaskSpec
    submitter: Connection
    deps_remaining: Set[ObjectID] = field(default_factory=set)
    queued_at: float = field(default_factory=time.monotonic)
    # Worker-lease request (reference `RequestWorkerLease`,
    # `direct_task_transport.h`): when dispatched, the worker is granted to
    # the submitter for direct task pushes instead of receiving a task.
    lease_req_id: Optional[bytes] = None


# In-process raylet registry (fake clusters / tests / benches run many
# raylets in one process). The same-host attach path consults it for two
# things: resolving a holder's shm session suffix without an RPC, and —
# bench honesty — detecting that the SPECIFIC holder models a network
# link (_chunk_serve_delay_s / _chunk_serve_bw_bps), in which case the
# attach bypass must stand down so link-model numbers stay meaningful.
_LOCAL_RAYLETS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class Raylet:
    def __init__(
        self,
        gcs_address: str,
        resources: Dict[str, float],
        session_dir: str,
        session_suffix: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        is_head: bool = False,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: int = 0,
    ):
        self.node_id = NodeID.from_random()
        self.gcs_address = gcs_address
        self.session_dir = session_dir
        self.session_suffix = session_suffix or f"{os.getpid()}_{self.node_id.hex()[:8]}"
        self.is_head = is_head
        self.server = RpcServer(host=host, port=port, name="raylet")
        self.server.register_instance(self)
        self.server.on_disconnect = self._on_disconnect
        self.resources = ResourceManager(resources)
        # The node's card ids: those CUDA_VISIBLE_DEVICES names when it
        # names as many as the GPU resource counts, else 0..n-1.
        n_gpus = int(resources.get(GPU, 0))
        visible = [d.strip() for d in
                   os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
                   if d.strip()]
        self.gpu_ids: List[str] = (visible if len(visible) == n_gpus
                                   else [str(i) for i in range(n_gpus)])
        self.store = SharedMemoryStore(
            self.session_suffix,
            capacity_bytes=object_store_memory,
            spill_dir=os.path.join(session_dir, "spill"),
        )
        _LOCAL_RAYLETS[self.node_id.hex()] = self
        cpus = int(resources.get(CPU, 1) or 1)
        self.pool = WorkerPool(self, max_workers=max(4, cpus * 4))
        # Cold spawns each pay an interpreter's imports, so bursts are
        # capped to keep small hosts responsive.
        self._spawn_parallelism = max(1, min(4, cpus))
        # Forge forks skip the import bill but each child's runtime INIT
        # is still ~50ms of CPU — an unbounded fork burst convoys those
        # inits and starves everything else on the node, so forge spawns
        # get their own (much wider) cap instead of none.
        self._forge_spawn_parallelism = max(4, cpus * 2)
        self.labels = labels or {}
        self._lock = threading.RLock()
        self._queue: deque[QueuedTask] = deque()
        self._waiting_deps: Dict[ObjectID, List[QueuedTask]] = defaultdict(list)
        self._task_submitters: Dict[bytes, Connection] = {}
        self._running: Dict[bytes, Tuple[TaskSpec, WorkerHandle]] = {}
        self._released_cpu: Dict[bytes, Dict[str, float]] = {}  # blocked-task releases
        self._cluster_view: Dict[str, Any] = {}
        self._spread_rr = 0
        self._pending_actor_creates: Dict[ActorID, Dict[str, Any]] = {}
        self._bundles: Dict[Tuple[bytes, int], Dict[str, Any]] = {}  # (pgid, idx) -> record
        self._pulls_inflight: Set[ObjectID] = set()
        # Transfer plane: in-progress pulls (chunk-availability index — this
        # node serves the chunks it already has), sender-side fairness
        # ledger, and a test/bench hook injecting per-chunk-RPC latency.
        self._active_pulls: Dict[ObjectID, _ActivePull] = {}
        self._outbound_lock = threading.Lock()
        # (oid bytes, puller hex) -> last chunk ts; and -> [distinct
        # offsets served (offset -> bytes; retries count once), last ts]
        # for the coverage ledger (ts drives TTL/eviction so a crashed
        # puller's entry can't exempt it from the gate forever).
        self._outbound_last_seen: Dict[Tuple[bytes, str], float] = {}
        self._outbound_chunks: Dict[
            Tuple[bytes, str], List[Any]] = {}  # [Dict[int, int], float]
        # oid bytes -> {holder hex: ts} — redirect hints, TTL-expired so a
        # holder that later evicts the object stops being advertised.
        self._completed_pullers: Dict[bytes, Dict[str, float]] = {}
        self._chunk_serve_delay_s = 0.0   # sender occupancy per chunk
        self._chunk_fetch_delay_s = 0.0   # per-RPC RTT on the pull side
        # Same-host sealed-segment attach (zero-socket handoff): a pull
        # whose holder shares this host copies the sealed shm segment
        # directly instead of chunking over the wire. Counters feed
        # debug_state and the pull microbench's attach arm.
        self._attach_hits = 0
        self._attach_bytes = 0
        self._chunk_bytes_served = 0      # egress actually sent via RPC
        self._peer_suffix_cache: Dict[str, str] = {}
        # Test/bench link model: when set, ALL chunk egress from this node
        # serializes through one token (a NIC) at this many bytes/s —
        # sleeps, never spins, so the modeled network dominates instead of
        # CPU contention. Models per-host DCN capacity for topology
        # benchmarks (star vs ring collectives); 0 disables.
        self._chunk_serve_bw_bps = 0.0
        self._link_lock = threading.Lock()
        # Sealed replicas whose directory announcement failed (GCS outage
        # mid-pull): re-announced by the heartbeat loop, otherwise the
        # node would stay listed as a stale `partial` location forever.
        self._unannounced_objects: Dict[ObjectID, int] = {}
        # Aborted pulls whose partial-location deregistration is pending:
        # drained by the heartbeat loop, since a lost fire-and-forget
        # remove would advertise this node as a partial holder forever
        # (and keep later pulls of a lost object from fast-aborting).
        self._stale_partials: Set[ObjectID] = set()
        self.server.register_raw("pull_object_chunk", self._serve_chunk_raw)
        # Local clients blocked on an object (event-driven get: the raylet
        # pushes object_ready/object_unavailable instead of clients polling).
        self._object_waiters: Dict[ObjectID, List[Connection]] = defaultdict(list)
        # Non-retryable local pull failures (e.g. object exceeds store
        # capacity): surfaced through get_or_pull instead of endless retry.
        self._pull_errors: Dict[ObjectID, str] = {}
        # Task lifecycle events, flushed to the GCS with the heartbeat.
        # Bounded so a long GCS outage can't grow it without limit (oldest
        # events are the right ones to shed — the GCS ring does the same).
        self._task_event_buffer: deque = deque(
            maxlen=GLOBAL_CONFIG.task_events_max_buffer // 10)
        self._stopped = threading.Event()
        self._dispatch_event = threading.Event()
        # Streaming resource gossip (see _resource_sync_loop).
        self._resources_dirty = threading.Event()
        self._resource_version = 0
        self._peer_resource_versions: Dict[str, int] = {}
        # GCS client with pubsub push handling; reconnects (and re-registers
        # this node + its subscriptions) after a GCS restart — the raylet
        # half of GCS fault tolerance.
        self.gcs = ReconnectingClient(
            gcs_address, name=f"raylet-{self.node_id.hex()[:8]}->gcs",
            push_handler=self._on_gcs_push,
            resubscribe=self._register_with_gcs)
        self._node_info: Optional[NodeInfo] = None
        self._peer_clients: Dict[str, RpcClient] = {}
        self._threads: List[threading.Thread] = []
        # Worker forge (forkserver template) — started in start() when
        # enabled; spawn_worker falls back to cold exec while it is down.
        self.forge: Optional[WorkerForge] = None
        # Job tier (docs/JOBS.md): per-node agent hosting submitted-job
        # driver subprocesses (started in start() when enabled), and the
        # per-job dispatch admission (stride fairness + rate quotas).
        self.job_agent: Optional[JobAgent] = None
        self.job_admission = JobAdmission(
            default_weight=GLOBAL_CONFIG.job_default_tenant_weight)
        # Per-runtime-env forge templates: preimports-csv key ->
        # {"forge": WorkerForge|None, "owners": set}. Owners are job
        # hexes / submission ids; the JOB-channel "finished" event drops
        # refs and the last owner out retires the template — bounded by
        # the set of LIVE jobs with preimports, not job history (RL018).
        self._env_forges: Dict[str, Dict[str, Any]] = {}
        self._env_forges_lock = threading.Lock()
        # Recently finished jobs (job hex -> monotonic ts): the reaper
        # retires their leftover idle workers (ones that were busy when
        # the finished event arrived) and TTL-expires entries, so this
        # tracks a ~60s window of terminations, never all of history
        # (RL018: sweep is _sweep_finished_jobs in the reaper loop).
        self._finished_jobs: Dict[str, float] = {}
        # Per-process waiter threads for cold-spawned workers (event-driven
        # death detection; the 2s reaper loop stays as anti-entropy).
        self._proc_waiters: List[threading.Thread] = []
        self._proc_waiters_lock = threading.Lock()
        # Granted worker leases: lease_id -> {worker, resources, conn}
        # (reference `leased_workers_` in node_manager.h).
        self._leases: Dict[bytes, Dict[str, Any]] = {}

    # ------------------------------------------------------------ lifecycle

    def start(self):
        self.server.start()
        if GLOBAL_CONFIG.worker_forge_enabled:
            try:
                self.forge = WorkerForge(
                    self.session_dir, self.session_suffix,
                    self.node_id.hex(),
                    on_worker_exit=self._on_forge_worker_exit)
                self.forge.start()  # template readies in the background
            except Exception:  # noqa: BLE001 — forge is an optimization
                # e.g. unwritable tmpdir, fork/exec failure: the node must
                # still come up — every spawn just takes the cold path.
                logger.warning("worker forge failed to start; cold spawns "
                               "only", exc_info=True)
                self.forge = None
        if GLOBAL_CONFIG.job_agent_enabled:
            self.job_agent = JobAgent(
                self.node_id.hex(), self.session_dir,
                gcs_call=lambda m, p: self.gcs.call(m, p, timeout=10.0),
                gcs_address=self.gcs_address)
        self._node_info = NodeInfo(
            node_id=self.node_id,
            address=self.server.address,
            object_manager_address=self.server.address,
            session_suffix=self.session_suffix,
            hostname=os.uname().nodename,
            ip=self.server.host,
            resources_total=self.resources.total,
            resources_available=dict(self.resources.total),
            labels=self.labels,
            is_head=self.is_head,
        )
        self._register_with_gcs(self.gcs)
        loops = [
            ("raylet-dispatch", self._dispatch_loop),
            ("raylet-heartbeat", self._heartbeat_loop),
            ("raylet-gcs-sync", self._gcs_sync_loop),
            ("raylet-reaper", self._reaper_loop),
        ]
        if GLOBAL_CONFIG.resource_delta_min_interval_ms > 0:
            # Streaming gossip (reference Ray Syncer): push availability
            # deltas the moment the ledger changes (coalesced) instead of
            # waiting out the heartbeat period — remote schedulers see
            # capacity open up in ~the delta interval, which is what makes
            # spillback decisions fresh under bursty load.
            self.resources.on_change = self._mark_resources_dirty
            loops.append(("raylet-resource-sync", self._resource_sync_loop))
        for name, target in loops:
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if GLOBAL_CONFIG.memory_monitor_refresh_ms > 0:
            from ray_tpu_torch.core.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(
                self, GLOBAL_CONFIG.memory_monitor_refresh_ms,
                GLOBAL_CONFIG.memory_usage_threshold)
            self.memory_monitor.start()

    def stop(self):
        self._stopped.set()
        if getattr(self, "memory_monitor", None) is not None:
            self.memory_monitor.stop()
        self._dispatch_event.set()
        if self.job_agent is not None:
            # Before kill_all: driver subprocesses get their group kill
            # (and the grace window) while their workers are still being
            # torn down — no orphaned entrypoints outlive the node.
            self.job_agent.shutdown()
        self.pool.kill_all()
        if self.forge is not None:
            # After kill_all (every known worker got its signal first):
            # detach from the shared template — it lingers for the next
            # cluster in this process and self-exits on idle/parent death.
            # An in-flight fork the pool never saw dies on its own when
            # its registration against this stopped raylet fails.
            self.forge.stop()
        with self._env_forges_lock:
            env_forges = [e["forge"] for e in self._env_forges.values()
                          if e["forge"] is not None]
            self._env_forges.clear()
        for f in env_forges:
            f.stop()
        with self._proc_waiters_lock:
            waiters = list(self._proc_waiters)
            self._proc_waiters.clear()
        for t in waiters:
            t.join(timeout=2.0)
        self.server.stop()
        self.gcs.close()
        for c in self._peer_clients.values():
            c.close()
        self.store.shutdown()

    # ------------------------------------------------ worker exit watchers

    def _watch_worker(self, handle: WorkerHandle):
        """Event-driven dead-worker detection: a per-process waiter thread
        for cold spawns (blocked in waitpid, zero-cost until exit); forge
        forks are covered by the template's exit-event stream. Failed
        spawns fail fast instead of waiting out the 2s reaper poll, which
        stays as anti-entropy."""
        if handle.spawn_kind != "cold":
            return
        t = threading.Thread(target=self._proc_waiter, args=(handle,),
                             name=f"worker-wait-{handle.pid}", daemon=True)
        with self._proc_waiters_lock:
            self._proc_waiters = [x for x in self._proc_waiters
                                  if x.is_alive()]
            self._proc_waiters.append(t)
        t.start()

    def _proc_waiter(self, handle: WorkerHandle):
        try:
            handle.proc.wait()
        except Exception:  # noqa: BLE001 — proc already reaped elsewhere
            return
        if self._stopped.is_set() or handle.state == "dead":
            return
        self._on_worker_dead(
            handle, f"process exited with code {handle.proc.returncode}")

    def _on_forge_worker_exit(self, pid: int, code: int):
        """Forge exit-event stream: a forked worker died (its waitpid
        lives in the template process)."""
        if self._stopped.is_set():
            return
        with self.pool._lock:
            handle = next((h for h in self.pool._workers.values()
                           if h.pid == pid and h.state != "dead"), None)
        if handle is not None:
            self._on_worker_dead(handle,
                                 f"process exited with code {code}")

    def _register_with_gcs(self, client):
        """Announce this node and (re)establish its subscriptions. Called at
        startup and again by the reconnecting client after a GCS restart.

        `reconcile_actors` asks the GCS to cross-check the actors it
        believes ALIVE here against what this node actually hosts (via a
        fresh `list_live_actors` query): actor-death reports sent during
        a GCS outage are lost, and a restored ghost address would
        otherwise make every caller error against it until a minutes-long
        timeout."""
        client.call("register_node", {
            "info": self._node_info,
            "reconcile_actors": True,
            # Reconcile list for the job table: RUNNING jobs the GCS
            # believes live here but a restarted agent doesn't know are
            # failed instead of hanging forever.
            "running_jobs": (self.job_agent.running()
                             if self.job_agent is not None else []),
        })
        client.call("subscribe", {"channel": "RESOURCES", "key": b"*"})
        client.call("subscribe", {"channel": "OBJECT", "key": b"*"})
        client.call("subscribe", {"channel": "JOB", "key": b"*"})

    def handle_list_live_actors(self, conn: Connection, data=None):
        """Actors this node currently hosts OR is creating right now —
        the GCS's failover reconciliation compares its restored table
        against this (in-flight creations count as hosted: failing one
        over would kill an actor that is coming up this instant)."""
        with self.pool._lock:
            live = {h.actor_id for h in self.pool._workers.values()
                    if h.is_actor and h.actor_id is not None
                    and h.state != "dead"}
        with self._lock:
            live.update(self._pending_actor_creates.keys())
        return {"actors": list(live)}

    # ------------------------------------------------------------- job tier

    def handle_agent_run_job(self, conn: Connection, data: Dict[str, Any]):
        """GCS -> agent: launch a submitted job's driver on this node."""
        if self.job_agent is None:
            raise RuntimeError("job agent disabled on this node")
        self.job_agent.run_job(data["submission_id"], data["entrypoint"],
                               data.get("runtime_env"))
        return {"ok": True}

    def handle_agent_stop_job(self, conn: Connection, data: Dict[str, Any]):
        stopped = False
        if self.job_agent is not None:
            stopped = self.job_agent.stop_job(data["submission_id"])
        return {"stopped": stopped}

    def _on_job_event(self, msg: Dict[str, Any]):
        """JOB-channel pubsub from the GCS — the raylet side of the job
        lifecycle: seed admission + pre-warm forges at the front, reclaim
        workers/forges/admission entries at the back."""
        event = msg.get("event")
        if event == "submitted":
            # Submission-time pre-warm: the per-env template pays its
            # preimport bill WHILE the driver subprocess is still
            # starting, so the job's first task forks instead of cold-
            # spawning (bench_jobs measures exactly this overlap).
            renv = msg.get("runtime_env") or {}
            if GLOBAL_CONFIG.job_prewarm_forge and renv.get("preimports"):
                self._env_forge_for(renv["preimports"],
                                    owner=msg.get("submission_id", ""))
        elif event == "running":
            job_hex = msg.get("job_id") or ""
            if job_hex:
                self.job_admission.register(job_hex, msg.get("tenant_qos"))
            renv = msg.get("runtime_env") or {}
            if renv.get("preimports"):
                self._env_forge_for(renv["preimports"], owner=job_hex)
        elif event == "finished":
            job_hex = msg.get("job_id") or ""
            sid = msg.get("submission_id") or ""
            if job_hex:
                self.job_admission.unregister(job_hex)
                with self._lock:
                    self._finished_jobs[job_hex] = time.monotonic()
                self._reclaim_job_workers(job_hex)
            self._release_env_forges({o for o in (job_hex, sid) if o})
            self._dispatch_event.set()

    def _reclaim_job_workers(self, job_hex: str):
        """Retire idle workers whose granted env belongs to a finished
        job: their runtime_env (working_dir, env_vars, preimports) died
        with the job, so no future task can ever lease them — left
        alone they'd sit as permanent orphans against the pool cap."""
        with self.pool._lock:
            victims = [h for h in self.pool._workers.values()
                       if h.state == "idle" and not h.is_actor
                       and h.granted_env.get("RAY_TPU_TORCH_JOB_ID") == job_hex]
            for h in victims:
                h.state = "busy"  # reserve so dispatch can't lease them
        for h in victims:
            self._on_worker_dead(h, "job finished")
            if h.proc is not None and h.proc.poll() is None:
                try:
                    h.proc.terminate()
                except OSError:
                    pass  # already reaped

    _FINISHED_JOB_TTL_S = 60.0

    def _sweep_finished_jobs(self):
        """Reaper-loop anti-entropy for job cleanup: workers that were
        BUSY when the finished event arrived go idle a moment later and
        would dodge the event-time reclaim; re-sweeping for the TTL
        window catches them. Expiry bounds the dict (RL018)."""
        now = time.monotonic()
        with self._lock:
            if not self._finished_jobs:
                return
            for jh in [j for j, ts in self._finished_jobs.items()
                       if now - ts > self._FINISHED_JOB_TTL_S]:
                del self._finished_jobs[jh]
            live = list(self._finished_jobs)
        for job_hex in live:
            self._reclaim_job_workers(job_hex)

    def forge_for(self, env_extra: Optional[Dict[str, str]]
                  ) -> Optional[WorkerForge]:
        """The forge template serving this grant: the node-wide default
        unless the runtime_env carries `preimports`, in which case a
        per-env template (grown on demand, refcounted by owning job)."""
        pre = _marker_preimports(env_extra)
        if not pre:
            return self.forge
        if not GLOBAL_CONFIG.worker_forge_enabled:
            return None
        return self._env_forge_for(
            pre, owner=(env_extra or {}).get("RAY_TPU_TORCH_JOB_ID", ""))

    def _env_forge_for(self, preimports: List[str], owner: str
                       ) -> Optional[WorkerForge]:
        """Get-or-create the template for this preimport set and add
        `owner`'s ref. Launch happens OUTSIDE the lock (RL002: template
        exec is a fork/exec); racers see forge=None while it launches
        and cold-spawn — only the very first spawns pay that."""
        base = [m.strip() for m in
                GLOBAL_CONFIG.worker_forge_preimports.split(",") if m.strip()]
        extra = [m for m in preimports if m and m not in base]
        key = ",".join(base + extra)
        with self._env_forges_lock:
            ent = self._env_forges.get(key)
            creator = ent is None
            if creator:
                ent = self._env_forges[key] = {"forge": None, "owners": set()}
            if owner:
                ent["owners"].add(owner)
            if not creator:
                return ent["forge"]
        forge: Optional[WorkerForge] = None
        try:
            forge = WorkerForge(
                self.session_dir, self.session_suffix, self.node_id.hex(),
                on_worker_exit=self._on_forge_worker_exit, preimports=key)
            forge.start()
        except Exception:  # noqa: BLE001 — per-env forge is an optimization
            logger.warning("per-env forge failed to start; cold spawns for "
                           "runtime_env preimports=%s", key, exc_info=True)
            forge = None
        with self._env_forges_lock:
            ent["forge"] = forge
        return forge

    def _release_env_forges(self, dead_owners: Set[str]):
        if not dead_owners:
            return
        to_stop = []
        with self._env_forges_lock:
            for key, ent in list(self._env_forges.items()):
                ent["owners"] -= dead_owners
                if not ent["owners"]:
                    del self._env_forges[key]
                    if ent["forge"] is not None:
                        to_stop.append(ent["forge"])
        for f in to_stop:
            # Detach only: the shared template lingers briefly and
            # self-exits on idle, so a resubmitted job re-warms cheaply.
            f.stop()

    def _pending_demand(self, cap: int = 64) -> List[Dict[str, float]]:
        """Resource shapes of queued tasks that can't run right now — the
        autoscaler's scale-up signal (reference ResourceDemandScheduler
        input)."""
        with self._lock:
            shapes = []
            for qt in self._queue:
                if len(shapes) >= cap:
                    break
                if not qt.deps_remaining and qt.spec.resources:
                    shapes.append(dict(qt.spec.resources))
            return shapes

    def _mark_resources_dirty(self):
        self._resources_dirty.set()

    def _resource_sync_loop(self):
        """Streamed availability deltas to the GCS (reference
        `ray_syncer.proto` RaySyncer streams; heartbeats remain the
        periodic anti-entropy full report). Coalesces bursts: at most one
        delta per resource_delta_min_interval_ms."""
        interval = GLOBAL_CONFIG.resource_delta_min_interval_ms / 1000.0
        while not self._stopped.is_set():
            if not self._resources_dirty.wait(timeout=1.0):
                continue
            if self._stopped.is_set():
                return
            time.sleep(interval)  # coalesce the burst behind one delta
            self._resources_dirty.clear()
            total, avail = self.resources.snapshot()
            self._resource_version += 1
            try:
                self.gcs.call_async(
                    "resource_delta",
                    {"node_id": self.node_id,
                     "resources_available": avail,
                     "resources_total": total,
                     "version": self._resource_version,
                     "pending_demand": self._pending_demand()})
            except Exception:  # noqa: BLE001 — heartbeat is the backstop
                pass

    def _heartbeat_loop(self):
        """Pure liveness beat. Anything slow (task-event flush, object
        re-announcements) lives in _gcs_sync_loop: sharing this loop with
        a 5s-timeout flush once delayed the next beat past the GCS health
        window during create storms — a false node death under load."""
        period = GLOBAL_CONFIG.raylet_heartbeat_period_ms / 1000.0
        while not self._stopped.wait(period):
            try:
                # Version BEFORE snapshot: a resource delta racing this
                # heartbeat snapshots after its version bump, so whichever
                # state is fresher always carries the strictly newer
                # version — snapshotting first could pair an old snapshot
                # with the delta's new version and silently revert it.
                version = self._resource_version
                total, avail = self.resources.snapshot()
                resp = self.gcs.call(
                    "heartbeat",
                    {"node_id": self.node_id, "resources_available": avail,
                     "resources_total": total,
                     "resource_version": version,
                     "pending_demand": self._pending_demand()},
                    timeout=5,
                )
                if not resp.get("registered"):
                    # A GCS that restarted without persisted node state (or
                    # that marked us dead during the outage): re-announce.
                    self._register_with_gcs(self.gcs)
            except Exception:
                if self._stopped.is_set():
                    return
                logger.warning("heartbeat to GCS failed", exc_info=True)

    def _gcs_sync_loop(self):
        """Anti-entropy GCS sync (split off the heartbeat loop so its
        bounded-but-slow RPCs can never delay a liveness beat): failed
        object announcements, stale partial-location removals, and the
        task-event flush."""
        period = GLOBAL_CONFIG.raylet_heartbeat_period_ms / 1000.0
        while not self._stopped.wait(period):
            try:
                with self._lock:
                    unannounced = list(self._unannounced_objects.items())
                    self._unannounced_objects.clear()
                for i, (oid, size) in enumerate(unannounced):
                    if not self.store.contains(oid):
                        continue
                    try:
                        self.gcs.call(
                            "object_location_add",
                            {"object_id": oid, "node_id": self.node_id,
                             "size": size}, timeout=5)
                    except Exception:  # noqa: BLE001 — retry next beat
                        # First failure: re-queue the REST and stop — N
                        # sequential 5s timeouts against a flaky GCS would
                        # stall this thread past the node-death threshold.
                        with self._lock:
                            for o, s in unannounced[i:]:
                                self._unannounced_objects[o] = s
                        break
                with self._lock:
                    stale = list(self._stale_partials)
                for oid in stale:
                    if self.store.contains(oid):
                        with self._lock:
                            self._stale_partials.discard(oid)
                        continue  # re-pulled since: now a real location
                    try:
                        self.gcs.call(
                            "object_location_remove",
                            {"object_id": oid, "node_id": self.node_id,
                             "partial": True}, timeout=5)
                        with self._lock:
                            self._stale_partials.discard(oid)
                    except Exception:  # noqa: BLE001 — retry next beat,
                        break          # same stall rationale as above
                # Bounded flush batches: after a 20k-task storm a raylet
                # holds tens of thousands of buffered events, and one
                # giant pickled add_task_events monopolizes the (shared,
                # GIL-bound) control plane for seconds right when the
                # next phase's work needs it. The deque sheds oldest on
                # overflow, so draining over several beats loses nothing.
                with self._lock:
                    events = [self._task_event_buffer.popleft()
                              for _ in range(min(
                                  2000, len(self._task_event_buffer)))]
                if events:
                    try:
                        self.gcs.call("add_task_events", {"events": events},
                                      timeout=5)
                    except Exception:
                        # Flush failed (e.g. GCS mid-restart): keep the
                        # events for the next attempt instead of losing
                        # this window's spans.
                        with self._lock:
                            self._task_event_buffer.extendleft(
                                reversed(events))
                        raise
            except Exception:
                if self._stopped.is_set():
                    return
                logger.warning("GCS sync failed", exc_info=True)

    def _reaper_loop(self):
        # Reap idle workers beyond the prestart target and poll dead processes.
        while not self._stopped.wait(2.0):
            with self.pool._lock:
                handles = list(self.pool._workers.values())
            for h in handles:
                if h.proc is not None and h.proc.poll() is not None and h.state != "dead":
                    self._on_worker_dead(h, f"process exited with code {h.proc.returncode}")
            # Long-dead handles leave the pool after a grace window so
            # worker churn cannot grow it without bound.
            self.pool.prune_dead()
            self._sweep_finished_jobs()

    # ------------------------------------------------------- GCS push events

    def _on_gcs_push(self, method: str, data: Any):
        if method == "pubsub_batch":
            # Delta-batched frame: the GCS coalesced this subscriber's
            # OBJECT/RESOURCES events behind one push (order per key
            # preserved; `seq` strictly increases per connection).
            for ev in data.get("events", ()):
                self._on_gcs_push("pubsub", ev)
            return
        if method != "pubsub":
            return
        channel = data["channel"]
        if channel == "RESOURCES":
            msg = data["message"]
            if "delta" in msg:
                # Streamed per-node delta: merge, dropping stale versions
                # (deltas and full views race; versions are per-node
                # monotonic). Heartbeat full views are the anti-entropy.
                view = dict(self._cluster_view)
                for node_hex, entry in msg["delta"].items():
                    ver = entry.get("version", 0)
                    if ver and ver < self._peer_resource_versions.get(
                            node_hex, 0):
                        continue
                    if ver:
                        # Pruned by the full-view anti-entropy below:
                        # each heartbeat view rebuild drops versions for
                        # nodes outside the live set, so dead peers
                        # cannot accumulate (and node ids are never
                        # reused — a stale guard cannot reject a
                        # replacement node's gossip).
                        # raylint: disable=RL012 — swept by full view
                        self._peer_resource_versions[node_hex] = ver
                    view[node_hex] = entry
                self._cluster_view = view
            else:
                self._cluster_view = msg
                # Full view is the anti-entropy: drop version state for
                # nodes that left the cluster (autoscaler churn would
                # otherwise grow this dict one entry per dead node).
                self._peer_resource_versions = {
                    k: v for k, v in self._peer_resource_versions.items()
                    if k in msg}
            # New capacity may have appeared (autoscaler launch): queued
            # tasks this node can never run get handed back to their
            # submitters for re-routing (reference task spilling).
            self._respill_infeasible()
        elif channel == "JOB":
            self._on_job_event(data["message"])
        elif channel == "OBJECT":
            oid = ObjectID(data["key"])
            with self._lock:
                has_waiters = (oid in self._waiting_deps
                               or oid in self._pulls_inflight
                               or oid in self._object_waiters)
            if has_waiters:
                entry = data["message"]
                if entry.get("inline") is not None:
                    self._on_object_local(oid)
                elif entry.get("nodes"):
                    self._start_pull(oid)

    # --------------------------------------------------- submission path

    def handle_submit_task(self, conn: Connection, data: Dict[str, Any]):
        spec: TaskSpec = data["spec"]
        grant_or_reject = data.get("grant_or_reject", False)
        target = self._choose_node(spec)
        if target is not None and target != self.node_id.hex() and not grant_or_reject:
            addr = self._cluster_view.get(target, {}).get("address")
            if addr:
                return {"status": "spillback", "address": addr}
        self._enqueue(spec, conn)
        return {"status": "queued"}

    def handle_request_worker_lease(self, conn: Connection, data: Dict[str, Any]):
        """Grant a worker to the caller for direct task pushes (reference
        `NodeManager::HandleRequestWorkerLease`, node_manager.cc). The
        request queues like a task; the grant arrives as a `lease_granted`
        push once a worker + resources are available."""
        spec: TaskSpec = data["spec"]
        grant_or_reject = data.get("grant_or_reject", False)
        target = self._choose_node(spec)
        if target is not None and target != self.node_id.hex() and not grant_or_reject:
            addr = self._cluster_view.get(target, {}).get("address")
            if addr:
                return {"status": "spillback", "address": addr}
        qt = QueuedTask(spec=spec, submitter=conn,
                        lease_req_id=data["req_id"])
        with self._lock:
            self._queue.append(qt)
        # The queued shape reaches the GCS with the next delta, not the
        # next heartbeat: a node whose worker is still starting holds no
        # resources, and the autoscaler must see its queue to keep it.
        self._mark_resources_dirty()
        self._dispatch_event.set()
        return {"status": "pending"}

    def handle_cancel_lease_request(self, conn: Connection, data: Dict[str, Any]):
        """Owner no longer needs a queued worker lease (demand drained) —
        reference `CancelWorkerLease` (node_manager.cc). Queued requests
        are dropped; already-granted ones are returned by the owner."""
        req_ids = set(data["req_ids"])
        with self._lock:
            doomed = [qt for qt in self._queue
                      if qt.lease_req_id is not None
                      and qt.lease_req_id in req_ids]
            for qt in doomed:
                self._queue.remove(qt)
        return {"cancelled": len(doomed)}

    def handle_return_worker_lease(self, conn: Connection, data: Dict[str, Any]):
        lease_id: bytes = data["lease_id"]
        with self._lock:
            lease = self._leases.pop(lease_id, None)
        if lease is None:
            return {"returned": False}
        worker: WorkerHandle = lease["worker"]
        # Exactly-once via the held_resources swap: a concurrent worker
        # death releases through the same helper and whoever swaps first
        # wins (releasing lease["resources"] directly would double-free).
        self._release_held_resources(worker)
        if worker.state != "dead":
            self.pool.push_idle(worker)
        self._dispatch_event.set()
        return {"returned": True}

    def _grant_lease(self, worker: WorkerHandle, qt: QueuedTask):
        """Worker + resources acquired for a lease request: hand the worker
        to the requester over its push channel."""
        lease_id = os.urandom(16)
        worker.held_resources = dict(qt.spec.resources)
        with self._lock:
            self._leases[lease_id] = {
                "worker": worker, "resources": dict(qt.spec.resources),
                "conn": qt.submitter,
            }
        try:
            qt.submitter.push("lease_granted", {
                "req_id": qt.lease_req_id, "lease_id": lease_id,
                "address": worker.direct_address,
                "raylet_address": self.server.address,
                "node_id": self.node_id,
                "worker_id": worker.worker_id,
            })
        except Exception:  # noqa: BLE001 — requester gone: unwind the grant
            with self._lock:
                self._leases.pop(lease_id, None)
            self._release_held_resources(worker)
            self.pool.push_idle(worker)

    def _reclaim_conn_leases(self, conn: Connection):
        """A lease holder disconnected: its workers may be running orphaned
        tasks — kill them (reference: leased workers are destroyed when the
        owner dies, node_manager.cc HandleUnexpectedWorkerFailure)."""
        with self._lock:
            doomed = [(lid, l) for lid, l in self._leases.items()
                      if l["conn"] is conn]
            for lid, _ in doomed:
                self._leases.pop(lid, None)
        for _, lease in doomed:
            worker: WorkerHandle = lease["worker"]
            # held_resources carries the lease grant; _on_worker_dead
            # releases it exactly once.
            self._on_worker_dead(worker, "lease holder disconnected")
            if worker.proc is not None and worker.proc.poll() is None:
                try:
                    worker.proc.terminate()
                except Exception:  # noqa: BLE001
                    pass
        if doomed:
            self._dispatch_event.set()

    def handle_direct_task_event(self, conn: Connection, data: Dict[str, Any]):
        """Task lifecycle events for directly-executed tasks, reported by
        the worker (the raylet never sees these tasks' dispatch)."""
        with self._lock:
            for ev in data["events"]:
                self._task_event_buffer.append(ev)
        return {}

    def _choose_node(self, spec: TaskSpec) -> Optional[str]:
        """Hybrid scheduling policy over the gossiped cluster view
        (reference `policy/hybrid_scheduling_policy.h`): prefer local while
        utilization is under threshold, else the best feasible node."""
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
            SpreadSchedulingStrategy,
        )

        strategy = spec.scheduling_strategy
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            return strategy.node_id
        view = self._cluster_view
        if not view:
            return None  # no view yet: keep it local
        req = spec.resources
        my_hex = self.node_id.hex()

        def available_now(entry):
            return all(entry["available"].get(r, 0.0) + 1e-9 >= a for r, a in req.items())

        def feasible(entry):
            return all(entry["total"].get(r, 0.0) >= a for r, a in req.items())

        feasible_nodes = [nid for nid, e in view.items() if e.get("alive") and feasible(e)]
        if isinstance(strategy, SpreadSchedulingStrategy):
            if not feasible_nodes:
                return None
            self._spread_rr += 1
            ordered = sorted(feasible_nodes)
            return ordered[self._spread_rr % len(ordered)]
        local = view.get(my_hex)
        # Data locality (reference `lease_policy.h:56` LocalityAwareLeasePolicy):
        # a task consuming large resident objects runs where the bytes are
        # instead of pulling them across the network. Locality outranks
        # INSTANTANEOUS availability: with streamed resource gossip the
        # view is fresh enough to see a node busy for the few ms a cached
        # lease or finishing task still holds its CPU, and bouncing the
        # task off-data to "ready" nodes costs a multi-MB pull — feasible
        # is enough, the data node queues it for the next free worker.
        # Feasible-only locality needs the streamed-gossip freshness
        # argument above; with gossip disabled (heartbeat-only views, up
        # to a full period stale) a merely-feasible data node may be
        # saturated for seconds, so fall back to requiring available-now.
        gossip_on = GLOBAL_CONFIG.resource_delta_min_interval_ms > 0

        def locality_ok(entry):
            return feasible(entry) and (gossip_on or available_now(entry))

        best_data = self._best_data_node(spec)
        if best_data == my_hex and local is not None and locality_ok(local):
            return my_hex  # the bytes are HERE: keep it, don't bounce
        if best_data is not None and best_data != my_hex:
            entry = view.get(best_data)
            if entry is not None and entry.get("alive") and locality_ok(entry):
                return best_data
        if local is not None and feasible(local) and available_now(local):
            return my_hex
        ready = [nid for nid in feasible_nodes if available_now(view[nid])]
        if ready:
            # Prefer local even when queued work exists? No: pick the
            # most-available ready node for work stealing across the cluster.
            ready.sort(key=lambda nid: -sum(view[nid]["available"].values()))
            return ready[0]
        if local is not None and feasible(local):
            return my_hex  # queue locally until resources free up
        if feasible_nodes:
            return feasible_nodes[0]
        return my_hex if local is not None else None

    # Below this, pulling is cheap enough that resource-based placement wins.
    _LOCALITY_MIN_BYTES = 1 << 20

    def _best_data_node(self, spec: TaskSpec) -> Optional[str]:
        """Node holding the most resident bytes of the task's ref args, or
        None when deps are absent/small/inline/local. One batched GCS
        lookup, only paid by dep-carrying tasks whose bytes are NOT
        already here (the common fast paths never leave the process).
        NEVER call while holding self._lock — the GCS round trip would
        stall every other handler on the node."""
        deps = spec.dependencies()
        if not deps:
            return None
        if all(self.store.contains(d) for d in deps):
            # Everything resident here: no RPC needed. Large bytes anchor
            # the task to this node (see _choose_node); small ones don't.
            if sum(self.store.local_size(d)
                   for d in deps) >= self._LOCALITY_MIN_BYTES:
                return self.node_id.hex()
            return None
        try:
            entries = self.gcs.call("object_locations_batch",
                                    {"object_ids": deps}, timeout=5)["entries"]
        except Exception:  # noqa: BLE001 — locality is advisory
            return None
        per_node: Dict[str, float] = {}
        for e in entries:
            if not e.get("known") or e.get("has_inline"):
                continue
            size = e.get("size", 0)
            if size < self._LOCALITY_MIN_BYTES:
                continue
            for nid in e.get("nodes", ()):
                key = nid.hex() if hasattr(nid, "hex") else str(nid)
                per_node[key] = per_node.get(key, 0) + size
        if not per_node:
            return None
        best = max(per_node, key=per_node.get)
        return best if per_node[best] >= self._LOCALITY_MIN_BYTES else None

    def _enqueue(self, spec: TaskSpec, submitter: Connection):
        qt = QueuedTask(spec=spec, submitter=submitter)
        with self._lock:
            self._task_submitters[spec.task_id.binary()] = submitter
            for dep in spec.dependencies():
                if not self._dep_available(dep):
                    qt.deps_remaining.add(dep)
                    self._waiting_deps[dep].append(qt)
            self._queue.append(qt)
        self._mark_resources_dirty()
        for dep in list(qt.deps_remaining):
            self._start_pull(dep)
        self._dispatch_event.set()

    def _respill_infeasible(self):
        """Queued tasks whose resources exceed this node's totals can only
        run elsewhere; once the cluster view shows a node that fits, return
        them to their submitter for re-routing (it re-runs the normal
        submit path, which spills to the capable node)."""
        with self._lock:
            snapshot = [qt for qt in self._queue
                        if not qt.deps_remaining
                        and not self.resources.feasible(qt.spec.resources)]
        # _choose_node may consult the GCS (data locality): keep it OUTSIDE
        # the lock — a slow GCS must not freeze dispatch for the node.
        candidates = []
        for qt in snapshot:
            target = self._choose_node(qt.spec)
            if target is not None and target != self.node_id.hex():
                candidates.append(qt)
        with self._lock:
            candidates = [qt for qt in candidates if qt in self._queue]
            for qt in candidates:
                self._queue.remove(qt)
                self._task_submitters.pop(qt.spec.task_id.binary(), None)
        for qt in candidates:
            if qt.submitter is not None and qt.submitter.alive:
                try:
                    qt.submitter.push("task_respill", {"spec": qt.spec})
                    continue
                except Exception:  # noqa: BLE001
                    pass
            logger.warning("dropping respilled task %s (submitter gone)",
                           qt.spec.name)

    def _dep_available(self, oid: ObjectID) -> bool:
        if self.store.contains(oid):
            return True
        try:
            entry = self.gcs.call("object_locations_get", {"object_id": oid}, timeout=5)
        except Exception:  # noqa: BLE001 — unreachable GCS == not available
            logger.debug("object_locations_get for %s failed", oid,
                         exc_info=True)
            return False
        return bool(entry.get("known") and entry.get("inline") is not None)

    # ------------------------------------------------------- dispatch loop

    def _dispatch_loop(self):
        while not self._stopped.is_set():
            self._dispatch_event.wait(timeout=0.2)
            self._dispatch_event.clear()
            try:
                self._dispatch_once()
            except Exception:
                logger.exception("dispatch loop error")

    # Dispatch policy (reference picks from a scored top-k rather than
    # strict FIFO, `hybrid_scheduling_policy.h:61`): scan past tasks whose
    # resources aren't available right now, so an infeasible or busy head
    # never wedges the node. Anti-starvation: once a *feasible* task has
    # waited past the aging threshold, nothing younger may jump it — the
    # node drains until its resources fit. Never-feasible tasks (requests
    # exceeding node total) can't age-block since they can't drain-to-fit.
    _DISPATCH_SCAN_LIMIT = 128
    _DISPATCH_AGING_S = 10.0

    def _dispatch_once(self):
        progressed = True
        while progressed and not self._stopped.is_set():
            progressed = False
            with self._lock:
                now = time.monotonic()
                # Group the dep-free scan window by job (FIFO preserved
                # within each job); the slot is then offered to jobs in
                # stride order, so a weight-8 job's task storm cannot
                # monopolize dispatch over a weight-1 job's trickle.
                # With a single job this degrades to exactly the old
                # FIFO scan.
                by_job: Dict[str, List[int]] = {}
                scanned = 0
                for i, qt in enumerate(self._queue):
                    if qt.deps_remaining:
                        continue
                    by_job.setdefault(qt.spec.job_id.hex(), []).append(i)
                    if (now - qt.queued_at > self._DISPATCH_AGING_S
                            and self.resources.feasible(qt.spec.resources)):
                        # Aged feasible task: reserve — nothing younger
                        # (in ANY job) may jump it; the node drains
                        # until its resources fit.
                        for jh in by_job:
                            by_job[jh] = [x for x in by_job[jh] if x <= i]
                        break
                    scanned += 1
                    if scanned >= self._DISPATCH_SCAN_LIMIT:
                        break
                ready_idx = None
                for jh in self.job_admission.order(list(by_job)):
                    # Token-bucket rate quota: a throttled job's tasks
                    # stay queued (the 0.2s dispatch tick retries);
                    # other jobs' candidates still get the slot.
                    if self.job_admission.admit(jh) > 0.0:
                        continue
                    for i in by_job[jh]:
                        qt = self._queue[i]
                        if self.resources.try_acquire(qt.spec.resources):
                            ready_idx = i
                            break
                    if ready_idx is not None:
                        break
                    # Nothing dispatchable for this job right now: give
                    # back the stride/bucket charge it didn't use.
                    self.job_admission.refund(jh)
                if ready_idx is None:
                    return
                qt = self._queue[ready_idx]
                del self._queue[ready_idx]
            env = self._env_for(qt.spec)
            worker = self.pool.pop_idle(env)
            if worker is None:
                # Spawn-ahead: size the spawn burst to the queued demand
                # for this grant (this task + dep-free queue head), so a
                # task burst pipelines its worker starts instead of
                # trickling one spawn per dispatch pass.
                with self._lock:
                    pending_specs = [q2.spec for q2 in self._queue
                                     if not q2.deps_remaining]
                    del pending_specs[self._DISPATCH_SCAN_LIMIT:]
                demand = 1 + sum(1 for s in pending_specs
                                 if self._env_for(s) == env)
                self._spawn_for_demand(env, demand)
                # keep resources held? No: release and retry when a worker registers.
                self.resources.release(qt.spec.resources)
                with self._lock:
                    self._queue.appendleft(qt)
                return
            if qt.lease_req_id is not None:
                if qt.submitter is None or not qt.submitter.alive:
                    # Requester died while the lease waited in queue.
                    self.resources.release(qt.spec.resources)
                    self.pool.push_idle(worker)
                else:
                    self._grant_lease(worker, qt)
            else:
                self._dispatch_to(worker, qt)
            progressed = True

    def _spawn_for_demand(self, env: Dict[str, str], demand: int):
        """Spawn-ahead hysteresis: bring (idle + starting) worker supply
        for this grant up to the queued demand. Spawn-kind-aware — forge
        forks skip the import bill so they get the wide
        `_forge_spawn_parallelism` cap; cold exec spawns keep the tight
        `_spawn_parallelism` cap (parallel interpreter starts are CPU
        bound and convoy on small hosts; pool size still targets the
        node's CPU count, reference worker_pool.h:347 prestarts one
        worker per core). Starting workers count as supply, so bursts
        never over-spawn past demand, and the caps pace a burst to the
        node instead of convoying every child's runtime init at once."""
        while not self._stopped.is_set():
            idle, starting, alive = self.pool.supply(env)
            if alive >= self.pool.max_workers:
                # Pool full of env-incompatible workers: retire one so a
                # compatible worker can be spawned on the next pass.
                stale = self.pool.pop_idle_mismatched(env)
                if stale is None:
                    return
                self.retire_worker(stale, "retired (env mismatch)")
                continue
            if idle + starting >= demand or not self.pool.spawn_allowed():
                return
            # The convoy cap is GLOBAL (every starting interpreter shares
            # the node's cores), while the deficit above is per-grant.
            cap = self._forge_spawn_parallelism \
                if self.pool.forge_available(env) else self._spawn_parallelism
            if self.pool.num_starting() >= cap:
                return
            self.pool.spawn_worker(env_extra=env)

    def retire_worker(self, handle: WorkerHandle, reason: str) -> None:
        """Mark a reserved idle worker dead and terminate its process."""
        self._on_worker_dead(handle, reason)
        if handle.proc is not None and handle.proc.poll() is None:
            try:
                handle.proc.terminate()
            except OSError:
                pass  # already reaped

    def _env_for(self, spec: TaskSpec) -> Dict[str, str]:
        env: Dict[str, str] = {}
        gpus = spec.resources.get(GPU, 0)
        if gpus:
            env[GPU_GRANT] = str(gpus)
        # runtime_env (reference runtime_env system): workers are leased
        # by matching granted env, so tasks with different env_vars or
        # working_dir/py_modules get different worker processes; the
        # worker materializes URI packages at startup.
        renv = spec.runtime_env or {}
        for k, v in (renv.get("env_vars") or {}).items():
            env[str(k)] = str(v)
        if renv.get("working_dir") or renv.get("py_modules") \
                or renv.get("pip") or renv.get("preimports"):
            from ray_tpu_torch.core import runtime_env as renv_mod

            env.update(renv_mod.granted_env(renv))
        # Job-scoped worker isolation: the job id is part of the granted
        # env, so pop_idle's exact match never hands one job's worker
        # (its env_vars, working_dir, preimported modules) to another
        # job's task, and job-finish reclamation can find every worker
        # the job left behind by this tag.
        env["RAY_TPU_TORCH_JOB_ID"] = spec.job_id.hex()
        return env

    def _dispatch_to(self, worker: WorkerHandle, qt: QueuedTask):
        spec = qt.spec
        worker.current_task = spec
        worker.task_started = time.monotonic()
        if _tracing._ENABLED:
            # Queue-time span, reconstructed at dispatch: a child of the
            # task's span so "where did the latency go" shows raylet
            # queueing separately from execution.
            now = time.monotonic()
            _tracing.get_tracer().record_span(
                "raylet.queue", _tracing.epoch_of(qt.queued_at),
                _tracing.epoch_of(now), parent_ctx=spec.trace_ctx,
                attrs={"task": spec.name,
                       "node": self.node_id.hex()[:12]})
        with self._lock:
            self._running[spec.task_id.binary()] = (spec, worker)
        self._record_task_event(spec, "RUNNING", worker)
        try:
            worker.conn.push("execute_task", {"spec": spec})
        except (ConnectionLost, OSError):
            self._on_worker_dead(worker, "push failed")

    def _record_task_event(self, spec: TaskSpec, state: str,
                           worker: Optional[WorkerHandle] = None):
        """Task lifecycle event for the state API / chrome timeline
        (reference gcs_task_manager events); buffered, flushed with the
        heartbeat so the hot path never waits on the GCS."""
        with self._lock:
            self._task_event_buffer.append({
                "task_id": spec.task_id.hex(),
                "name": spec.name,
                "state": state,
                "ts": time.time(),
                "node_id": self.node_id.hex()[:12],
                "worker_id": worker.worker_id.hex()[:12] if worker else None,
                "pid": worker.pid if worker else None,
                "queued_at": spec.submitted_at,
                **(spec.trace_ctx or {}),
            })

    # --------------------------------------------- worker-facing handlers

    def handle_register_worker(self, conn: Connection, data: Dict[str, Any]):
        worker_id: WorkerID = data["worker_id"]
        conn.meta["worker_id"] = worker_id
        handle = self.pool.on_worker_registered(worker_id, conn, data.get("direct_address"))
        if handle is None:
            # Worker not spawned by us (e.g. driver-embedded runtime): ignore.
            return {"ok": False}
        self._dispatch_event.set()
        return {"ok": True, "node_id": self.node_id, "session_suffix": self.session_suffix}

    def handle_task_done(self, conn: Connection, data: Dict[str, Any]):
        """Worker finished a task: register results, notify submitter, recycle."""
        task_id_b: bytes = data["task_id"].binary()
        results: List[Dict[str, Any]] = data.get("results", [])
        error_blob: Optional[bytes] = data.get("error")
        with self._lock:
            entry = self._running.pop(task_id_b, None)
            submitter = self._task_submitters.pop(task_id_b, None)
            released = self._released_cpu.pop(task_id_b, None)
        if entry is None:
            return {}
        spec, worker = entry
        self._record_task_event(
            spec, "FAILED" if error_blob is not None else "FINISHED", worker)
        # Resource release (handle partial release from blocked state).
        acquired = self._acquired_resources(spec)
        if released:
            for r, amt in released.items():
                acquired[r] = acquired.get(r, 0) - amt
        remaining = {r: a for r, a in acquired.items() if a > 0}
        if spec.actor_creation and error_blob is None:
            # The actor's *lifetime* resources stay held until death/kill
            # (reference: the lease stays acquired); the placement-only
            # surplus (default 1 CPU used to schedule creation) is returned.
            lifetime = {r: a for r, a in spec.resources.items() if a > 0}
            worker.held_resources = lifetime
            surplus = {r: a - lifetime.get(r, 0.0) for r, a in remaining.items()
                       if a - lifetime.get(r, 0.0) > 0}
            self.resources.release(surplus)
        else:
            self.resources.release(remaining)
        self._register_results(spec, results)
        if submitter is not None and submitter.alive:
            try:
                submitter.push("task_result",
                               {"task_id": spec.task_id, "results": results,
                                "error": error_blob})
            except (ConnectionLost, OSError):
                logger.debug("task_result push for %s dropped: submitter "
                             "gone", spec.task_id, exc_info=True)
        if spec.actor_creation:
            # Dedicated actor worker: stays busy serving direct calls.
            # Resolve by the REPORTING WORKER, not by actor id alone: a
            # superseded create attempt (GCS failover race) shares the
            # actor id AND task id with the live attempt, and resolving
            # the newer record with the older attempt's outcome handed
            # callers a worker the newer attempt never created.
            with self._lock:
                pending = self._pending_actor_creates.get(spec.actor_id)
                ours = pending is not None and pending.get("worker") is worker
                if ours:
                    self._pending_actor_creates.pop(spec.actor_id, None)
            if ours:
                pending["result"] = {"error": error_blob, "worker": worker}
                pending["event"].set()
            else:
                # A superseded attempt's worker finished its creation
                # late: it must not linger as a second host of the actor
                # (its eventual death would also be misattributed to the
                # live incarnation) — kill it silently.
                logger.info("terminating superseded duplicate actor "
                            "worker pid=%s for %s", worker.pid,
                            spec.actor_id.hex()[:12])
                worker.is_actor = False  # suppress the actor_died report
                if self.pool.mark_dead(worker.worker_id) is not None:
                    self._release_held_resources(worker)
                if worker.proc is not None and worker.proc.poll() is None:
                    try:
                        worker.proc.terminate()
                    except OSError:
                        pass  # already reaped
        else:
            self.pool.push_idle(worker)
        self._dispatch_event.set()
        return {}

    def _register_results(self, spec: TaskSpec, results: List[Dict[str, Any]]):
        for r in results:
            oid: ObjectID = r["object_id"]
            if r["kind"] == "inline":
                try:
                    # Pipelined: the submitter gets results directly via the
                    # task_result push; the directory entry only serves
                    # later cross-node dependents, so the completion path
                    # need not wait a GCS round trip per task.
                    self.gcs.call_async(
                        "object_location_add",
                        {"object_id": oid, "inline": r["data"],
                         "size": len(r["data"]), "owner": spec.owner_address})
                except Exception:
                    logger.warning("failed to register inline object %s", oid)
            else:  # sealed into the node store by the worker
                try:
                    self.store.adopt(oid, r["size"])
                except Exception:
                    logger.warning("failed to adopt %s", oid, exc_info=True)
                try:
                    self.gcs.call("object_location_add",
                                  {"object_id": oid, "node_id": self.node_id,
                                   "size": r["size"], "owner": spec.owner_address},
                                  timeout=10)
                except Exception:  # noqa: BLE001 — GCS down; gossip repairs
                    logger.debug("object_location_add for %s failed", oid,
                                 exc_info=True)
                self._on_object_local(oid)

    def handle_object_sealed(self, conn: Connection, data: Dict[str, Any]):
        """A local process (driver/worker put) sealed a segment directly."""
        oid: ObjectID = data["object_id"]
        self.store.adopt(oid, data["size"])
        self.gcs.call("object_location_add",
                      {"object_id": oid, "node_id": self.node_id, "size": data["size"],
                       "owner": data.get("owner")}, timeout=10)
        self._on_object_local(oid)
        return {}

    @staticmethod
    def _acquired_resources(spec: TaskSpec) -> Dict[str, float]:
        """What the raylet actually acquired for this task (actor creation
        acquires placement_resources, everything else spec.resources)."""
        if spec.actor_creation:
            return dict(spec.placement_resources or spec.resources)
        return dict(spec.resources)

    def handle_worker_blocked(self, conn: Connection, data: Dict[str, Any]):
        """Worker blocked in get(): release its CPU so others can run
        (reference: raylet marks the lease as blocked and can start more)."""
        handle = self.pool.by_conn(conn)
        if handle is None or handle.current_task is None:
            return {}
        spec = handle.current_task
        cpus = self._acquired_resources(spec).get(CPU, 0)
        if cpus:
            with self._lock:
                self._released_cpu[spec.task_id.binary()] = {CPU: cpus}
            self.resources.release({CPU: cpus})
            self._dispatch_event.set()
        return {}

    def handle_worker_unblocked(self, conn: Connection, data: Dict[str, Any]):
        handle = self.pool.by_conn(conn)
        if handle is None or handle.current_task is None:
            return {}
        spec = handle.current_task
        with self._lock:
            released = self._released_cpu.pop(spec.task_id.binary(), None)
        if released:
            # Oversubscribe rather than deadlock: force re-acquire.
            with self.resources._lock:
                for r, amt in released.items():
                    self.resources.available[r] = self.resources.available.get(r, 0) - amt
        return {}

    def _release_held_resources(self, handle: WorkerHandle):
        """Release lifetime-held (actor) resources exactly once per worker."""
        held, handle.held_resources = handle.held_resources, {}
        if held:
            self.resources.release(held)

    def _on_worker_dead(self, handle: WorkerHandle, reason: str):
        handle = self.pool.mark_dead(handle.worker_id)
        if handle is None:
            return
        with self._lock:
            # A leased worker dying invalidates its lease record (a late
            # return_worker_lease must not double-release the resources —
            # held_resources below releases them exactly once).
            stale = [lid for lid, l in self._leases.items()
                     if l["worker"] is handle]
            for lid in stale:
                self._leases.pop(lid, None)
        self._release_held_resources(handle)
        logger.warning("worker %s (pid %s) died: %s", handle.worker_id.hex()[:12],
                       handle.pid, reason)
        try:
            # Release any object borrows the dead worker held (the owner's
            # pending frees would otherwise leak store bytes forever).
            self.gcs.call_async("borrower_gone",
                                {"borrower_id": handle.worker_id.hex()})
        except Exception:  # noqa: BLE001
            pass
        spec = handle.current_task
        if spec is not None:
            task_id_b = spec.task_id.binary()
            with self._lock:
                self._running.pop(task_id_b, None)
                submitter = self._task_submitters.pop(task_id_b, None)
                released = self._released_cpu.pop(task_id_b, None)
            res = self._acquired_resources(spec)
            if released:  # worker was blocked in get(): CPU already released
                for r, amt in released.items():
                    res[r] = res.get(r, 0) - amt
            self.resources.release({r: a for r, a in res.items() if a > 0})
            if handle.is_actor or spec.actor_creation:
                pass  # reported below via actor_died
            elif submitter is not None and submitter.alive:
                from ray_tpu_torch.exceptions import (
                    OutOfMemoryError,
                    WorkerCrashedError,
                )

                if handle.oom_kill_reason:
                    exc: WorkerCrashedError = OutOfMemoryError(
                        f"Task {spec.name} was killed by the memory "
                        f"monitor: {handle.oom_kill_reason}")
                else:
                    exc = WorkerCrashedError(
                        f"Worker died while running {spec.name}: {reason}")
                err = serialization.serialize_exception(exc, spec.name)
                try:
                    submitter.push("task_result",
                                   {"task_id": spec.task_id, "results": [],
                                    "error": err, "crashed": True})
                except (ConnectionLost, OSError):
                    logger.debug("crash report for %s dropped: submitter "
                                 "gone", spec.task_id, exc_info=True)
        if handle.is_actor and handle.actor_id is not None:
            with self._lock:
                pending = self._pending_actor_creates.get(handle.actor_id)
                superseded = (pending is not None
                              and pending.get("worker") is not handle)
                if pending is not None and not superseded:
                    self._pending_actor_creates.pop(handle.actor_id, None)
                else:
                    pending = None  # a newer attempt owns the record
            if pending is not None:
                pending["result"] = {"error": serialization.serialize_exception(
                    RaySystemError(f"actor worker died during creation: {reason}"))}
                pending["event"].set()
            if superseded:
                # This worker belonged to a SUPERSEDED create attempt: a
                # newer attempt owns the actor's record, so reporting
                # actor_died here would burn a restart of (or terminally
                # kill) the live incarnation that is coming up right now.
                logger.info("suppressing actor_died for %s: worker pid=%s "
                            "was a superseded create attempt's",
                            handle.actor_id.hex()[:12], handle.pid)
            else:
                try:
                    self.gcs.call("actor_died",
                                  {"actor_id": handle.actor_id,
                                   "reason": reason,
                                   "intended": False}, timeout=5)
                except Exception:  # noqa: BLE001 — GCS death detection
                    logger.debug("actor_died report for %s failed",
                                 handle.actor_id, exc_info=True)
            # actor resources released on death
            if handle.current_task is None and handle.actor_id is not None:
                pass
        self._dispatch_event.set()

    def _on_disconnect(self, conn: Connection):
        handle = self.pool.by_conn(conn)
        if handle is not None and handle.state != "dead":
            self._on_worker_dead(handle, "connection lost")
        self._reclaim_conn_leases(conn)
        # Submitter connections: drop pending notification targets.
        with self._lock:
            doomed = [t for t, c in self._task_submitters.items() if c is conn]
            for t in doomed:
                del self._task_submitters[t]
            for oid in list(self._object_waiters):
                ws = self._object_waiters[oid]
                if conn in ws:
                    ws.remove(conn)
                    if not ws:
                        del self._object_waiters[oid]

    # ------------------------------------------------------ actor creation

    def _pop_pending_create_if_ours(self, actor_id, pending) -> None:
        """Drop an actor's pending-create record only when it is still
        THIS attempt's — an unconditional pop would tear down a newer
        (superseding) attempt's record and strand its waiter."""
        with self._lock:
            if self._pending_actor_creates.get(actor_id) is pending:
                self._pending_actor_creates.pop(actor_id, None)

    def handle_create_actor(self, conn: Connection, data: Dict[str, Any]):
        """GCS asks this node to host an actor (reference
        `GcsActorScheduler::LeaseWorkerFromNode`)."""
        spec: TaskSpec = data["spec"]
        placement = spec.placement_resources or spec.resources
        if not self.resources.try_acquire(placement):
            return {"status": "retry"}
        env = self._env_for(spec)
        # Reuse an idle pooled worker whose granted env matches (reference
        # worker_pool.h lease matching) — saves a cold start.
        worker = self.pool.pop_idle(env)
        if worker is None:
            worker = self.pool.spawn_worker(env_extra=env)
        worker.is_actor = True
        worker.actor_id = spec.actor_id
        pending = {"event": threading.Event(), "result": None, "env": env,
                   "worker": worker}
        # One pending record per actor, owned by the NEWEST attempt.
        # Concurrent creates for the same actor are real under GCS
        # failover: the dead incarnation's create RPC keeps running on
        # this raylet while the restarted GCS re-kicks its own. The older
        # attempt is superseded — fired with an error now (its caller is
        # gone or will retry) — and completions resolve records by the
        # WORKER that reported, never by actor id alone (the creation
        # spec, and so its task id, is identical across attempts).
        with self._lock:
            prev = self._pending_actor_creates.pop(spec.actor_id, None)
            self._pending_actor_creates[spec.actor_id] = pending
        if prev is not None:
            logger.warning(
                "create_actor for %s superseded an in-flight attempt "
                "(GCS failover re-kick racing the old incarnation)",
                spec.actor_id.hex()[:12])
            prev["result"] = {"error": serialization.serialize_exception(
                RaySystemError("superseded by a newer create attempt"))}
            prev["event"].set()
        # Spawn-ahead hysteresis for create bursts: in-flight creates on
        # this node (each arrives on its own GCS connection) are queued
        # demand — prespawn so the next creates find registered idle
        # workers instead of serializing their own starts. Only creates
        # with the SAME grant count: a prespawned worker can serve only
        # an env-matching create.
        with self._lock:
            inflight = sum(1 for p in self._pending_actor_creates.values()
                           if p.get("env") == env)
        if inflight > 1:
            self._spawn_for_demand(env, inflight - 1)
        # Wait for registration (event-driven: `registered` is set on
        # register AND on death — no 10ms poll; the 0.5s slice is pure
        # anti-entropy against a lost event).
        deadline = time.monotonic() + GLOBAL_CONFIG.worker_lease_timeout_ms / 1000.0
        while worker.conn is None and worker.state != "dead":
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            worker.registered.wait(min(remaining, 0.5))
        if worker.conn is None:
            self.resources.release(placement)
            self._pop_pending_create_if_ours(spec.actor_id, pending)
            if worker.state == "dead" or (worker.proc is not None
                                          and worker.proc.poll() is not None):
                return {"status": "error",
                        "error": f"actor worker exited at startup "
                                 f"(code {worker.proc.returncode})"}
            return {"status": "error", "error": "actor worker failed to register"}
        worker.state = "busy"
        qt = QueuedTask(spec=spec, submitter=conn)
        with self._lock:
            self._task_submitters[spec.task_id.binary()] = conn
        self._dispatch_to(worker, qt)
        if not pending["event"].wait(GLOBAL_CONFIG.worker_lease_timeout_ms / 1000.0):
            # Hung __init__: kill the worker; _on_worker_dead releases the
            # resources and cleans up the pending record. Pop only OUR
            # record — a newer attempt may have superseded it.
            self._pop_pending_create_if_ours(spec.actor_id, pending)
            if worker.proc is not None and worker.proc.poll() is None:
                try:
                    worker.proc.terminate()
                except OSError:
                    pass  # already reaped
            return {"status": "error", "error": "actor creation timed out"}
        result = pending["result"]
        if result.get("error") is not None:
            # Creation-task resources were already released by task_done (or
            # by _on_worker_dead if the worker died) — don't double-release.
            return {"status": "error", "error": "actor __init__ raised",
                    "error_blob": result["error"]}
        worker.current_task = None  # stays busy (dedicated), serving direct calls
        return {"status": "ok", "worker_id": worker.worker_id,
                "direct_address": worker.direct_address}

    def handle_kill_worker(self, conn: Connection, data: Dict[str, Any]):
        handle = self.pool.get(data["worker_id"])
        if handle is None:
            return {}
        if data.get("suppress_report", True):
            # GCS marks the actor dead itself (kill with no_restart); a
            # restartable kill must still report actor_died so the GCS
            # drives the RESTARTING transition.
            handle.is_actor = False
        if self.pool.mark_dead(handle.worker_id) is not None:
            self._release_held_resources(handle)
        if handle.proc is not None and handle.proc.poll() is None:
            try:
                handle.proc.terminate()
            except OSError:
                pass  # already reaped
        elif handle.proc is None and handle.conn is not None:
            handle.conn.close()
        if handle.is_actor and handle.actor_id is not None:
            try:
                self.gcs.call("actor_died",
                              {"actor_id": handle.actor_id,
                               "reason": data.get("reason", "killed"),
                               "intended": False}, timeout=5)
            except Exception:  # noqa: BLE001 — GCS death detection covers it
                logger.debug("actor_died report for %s failed",
                             handle.actor_id, exc_info=True)
        return {}

    # ---------------------------------------------------------- chaos hooks

    def handle_chaos_kill_worker(self, conn: Connection, data: Dict[str, Any]):
        """Fault injection (ray_tpu_torch/chaos): SIGKILL one live worker
        PROCESS on this node — no graceful path, no actor bookkeeping.
        Death is discovered by the normal exit-event / reaper machinery
        exactly as a real crash would be, which is the point: the chaos
        plane must exercise detection, not shortcut it. `draw` picks the
        victim deterministically from the sorted live set; `actors_only`
        restricts to dedicated actor workers."""
        import signal as _signal

        draw = int(data.get("draw", 0))
        actors_only = bool(data.get("actors_only", False))
        with self.pool._lock:
            victims = sorted(
                (h for h in self.pool._workers.values()
                 if h.state != "dead" and h.pid
                 and h.proc is not None and h.proc.poll() is None
                 and (h.is_actor or not actors_only)),
                key=lambda h: h.worker_id.hex())
        if not victims:
            return {"killed": False}
        victim = victims[draw % len(victims)]
        try:
            os.kill(victim.pid, _signal.SIGKILL)
        except OSError as e:
            return {"killed": False, "error": str(e)}
        logger.warning("chaos: SIGKILLed worker pid=%d (%s, actor=%s)",
                       victim.pid, victim.worker_id.hex()[:12],
                       victim.is_actor)
        return {"killed": True, "pid": victim.pid,
                "worker_id": victim.worker_id.hex(),
                "actor": victim.is_actor}

    def handle_chaos_kill_forge(self, conn: Connection, data: Dict[str, Any]):
        """Fault injection: SIGKILL the worker-forge template process.
        The forge client notices the loss, restarts the template in the
        background, and spawns fall back to cold exec meanwhile (the
        PR-5 failover discipline this injector exists to exercise)."""
        import signal as _signal

        forge = self.forge
        proc = forge.proc if forge is not None else None
        if proc is None or proc.poll() is not None:
            return {"killed": False}
        try:
            os.kill(proc.pid, _signal.SIGKILL)
        except OSError as e:
            return {"killed": False, "error": str(e)}
        logger.warning("chaos: SIGKILLed forge template pid=%d", proc.pid)
        return {"killed": True, "pid": proc.pid}

    # ------------------------------------------------------ object transfer

    def _start_pull(self, oid: ObjectID):
        with self._lock:
            if oid in self._pulls_inflight or self.store.contains(oid):
                return
            self._pulls_inflight.add(oid)
        threading.Thread(target=self._pull_worker, args=(oid,), daemon=True).start()

    def _pull_worker(self, oid: ObjectID):
        try:
            entry = self.gcs.call("object_locations_get", {"object_id": oid}, timeout=10)
            if not entry.get("known"):
                with self._lock:
                    self._pulls_inflight.discard(oid)
                return  # OBJECT pubsub push will re-trigger when it appears
            if entry.get("inline") is not None:
                with self._lock:
                    self._pulls_inflight.discard(oid)
                self._on_object_local(oid)
                return
            my_hex = self.node_id.hex()
            if any(n.hex() == my_hex for n in entry.get("nodes", [])):
                with self._lock:
                    self._pulls_inflight.discard(oid)
                self._on_object_local(oid)
                return
            ok = False
            try:
                ok = self._pull_object_pipelined(oid, entry)
            except Exception:  # noqa: BLE001 — includes ObjectStoreFullError
                logger.warning("pull of %s failed", oid, exc_info=True)
            with self._lock:
                self._pulls_inflight.discard(oid)
            if ok:
                self._on_object_local(oid)
            else:
                # Every advertised location failed (or there were none):
                # wake blocked owners so they can reconstruct, not hang.
                self._notify_object_waiters(oid, "object_unavailable")
                # Tasks parked on this dependency would wait forever (no
                # object_ready will ever fire): run the lost-dep ladder —
                # tell owners to reconstruct, re-pull with bounded
                # backoff while they do, and only then fail the parked
                # tasks with a loss-shaped error (the PR-10 watchdog
                # class: bounded recovery, never a hang).
                self._handle_lost_dep(oid)
        except Exception:
            with self._lock:
                self._pulls_inflight.discard(oid)
            logger.exception("pull worker failed for %s", oid)

    # Lost-dep ladder bound: ~5s of re-pull attempts while the owner's
    # reconstruction runs, then parked tasks fail loss-shaped.
    _LOST_DEP_RETRIES = 10
    _LOST_DEP_BACKOFF_S = 0.5

    def _handle_lost_dep(self, oid: ObjectID, attempt: int = 0):
        """A dependency pull found no live locations. Ladder:

        1. notify each parked task's submitter (`task_dep_lost`) — the
           OWNER holds the creating task's spec and re-executes it;
        2. re-check the directory with bounded backoff, restarting the
           pull the moment the re-executed object registers;
        3. after the bound, complete the still-parked tasks with an
           ObjectLostError result (loss-shaped, so data-plane lineage
           can recompute) — a fault becomes a bounded error, not a hang.
        """
        from ray_tpu_torch.exceptions import ObjectLostError

        with self._lock:
            if self._stopped.is_set() or not self._waiting_deps.get(oid):
                return
        try:
            entry = self.gcs.call("object_locations_get",
                                  {"object_id": oid}, timeout=5)
        except Exception:  # noqa: BLE001 — directory unreachable: retry arm
            entry = {}
        if entry.get("known") and (entry.get("inline") is not None
                                   or entry.get("nodes")):
            # Advertised copies exist: re-pull (recovered, or the holder
            # is dying and the directory hasn't heard). This arm resets
            # the ladder, but it is bounded by the GCS death sweep —
            # once the health checker marks the holder DEAD its
            # locations are pruned and the next failed pull's ladder
            # advances past this check.
            self._start_pull(oid)
            return
        if attempt == 0:
            with self._lock:
                submitters = {
                    self._task_submitters.get(qt.spec.task_id.binary())
                    for qt in self._waiting_deps.get(oid, [])}
            for conn in submitters:
                if conn is not None and conn.alive:
                    try:
                        conn.push("task_dep_lost", {"object_id": oid})
                    except Exception:  # noqa: BLE001 — submitter gone
                        pass
        if attempt < self._LOST_DEP_RETRIES:
            t = threading.Timer(self._LOST_DEP_BACKOFF_S,
                                self._handle_lost_dep, args=(oid, attempt + 1))
            t.daemon = True
            t.start()
            return
        with self._lock:
            waiters = self._waiting_deps.pop(oid, [])
            for qt in waiters:
                try:
                    self._queue.remove(qt)
                except ValueError:
                    pass
        for qt in waiters:
            tkey = qt.spec.task_id.binary()
            with self._lock:
                submitter = self._task_submitters.pop(tkey, None)
            err = serialization.serialize_exception(
                ObjectLostError(oid), qt.spec.name)
            if submitter is not None and submitter.alive:
                try:
                    submitter.push("task_result",
                                   {"task_id": qt.spec.task_id,
                                    "results": [], "error": err})
                except Exception:  # noqa: BLE001 — submitter gone
                    pass

    def _pull_object_pipelined(self, oid: ObjectID, entry: Dict[str, Any]) -> bool:
        """Windowed, multi-source chunk fetch into a pre-created buffer.

        The reference moves objects as flow-controlled chunk streams with
        multiple chunks in flight (`object_manager.h:206`,
        `object_buffer_pool.h`); same here, plus location-aware striping:
        `object_transfer_window` chunk requests stay pipelined at all
        times, spread round-robin across EVERY advertised location (full
        and partial), and the location set refreshes as the pull runs so
        peers that finish their own pulls become sources mid-transfer.
        """
        chunk_bytes = max(1, GLOBAL_CONFIG.object_transfer_chunk_bytes)
        window = max(1, GLOBAL_CONFIG.object_transfer_window)
        my_hex = self.node_id.hex()
        peers = _PeerSet(max(1, GLOBAL_CONFIG.object_transfer_max_peers))
        self._add_entry_peers(peers, entry, my_hex)

        size = int(entry.get("size") or 0)
        first_data: Optional[memoryview] = None
        if size <= 0:
            # Directory entry without a size: learn it from chunk 0.
            # Busy senders are retried with backoff (consuming their
            # redirect hints) — a busy seed must delay discovery, not
            # fail the pull outright.
            probe_deadline = time.monotonic() + 5.0
            while size <= 0 and time.monotonic() < probe_deadline:
                progress = False
                for addr in peers.snapshot():
                    try:
                        meta, data, _ = self._fetch_chunk(addr, oid, 0,
                                                          chunk_bytes)
                    except Exception:  # noqa: BLE001
                        peers.drop(addr)
                        continue
                    st = meta.get("st")
                    if st == "ok":
                        size = int(meta["s"])
                        first_data = data
                        break
                    if st == "busy":
                        progress = True  # alive sender: worth retrying
                        for alt in meta.get("alt") or ():
                            peers.add(self._addr_for_node(alt))
                    elif meta.get("s"):
                        size = int(meta["s"])  # partial holder knows size
                        break
                if size <= 0:
                    if not progress and not self._refresh_pull_peers(
                            oid, peers, my_hex):
                        break
                    time.sleep(0.05)
            if size <= 0:
                return False
        if self.store.contains(oid):
            return True
        # Same-host fast path: a holder sharing this host already has the
        # sealed bytes in /dev/shm — attach its segment by final name
        # (atomic-rename seal => never torn) and memcpy shm->shm, no
        # socket hop at all. Falls through to the chunk pull on any miss.
        if self._try_same_host_attach(oid, entry, size):
            return True
        try:
            buf = self.store.create(oid, size)
        except ObjectStoreFullError as e:
            # Non-retryable for this node: remember it so get_or_pull can
            # surface a typed error instead of the client retrying forever.
            with self._lock:
                self._pull_errors[oid] = str(e)
            raise
        state = _ActivePull(buf, size, chunk_bytes)
        with self._lock:
            self._active_pulls[oid] = state
        ok = False
        plan: Dict[str, Any] = {}
        pull_span = _tracing.NOOP_SPAN
        if _tracing._ENABLED:
            pull_span = _tracing.get_tracer().start_span(
                "object.pull",
                attrs={"object": oid.hex()[:16], "size": size,
                       "node": self.node_id.hex()[:12]})
        try:
            from ray_tpu_torch._native import copy_at

            if first_data is not None:
                n = min(len(first_data), size)
                copy_at(buf, 0, first_data[:n])
                state.mark_done(0)
            # Advertise the in-progress copy: later pullers stripe their
            # reads across us for the chunks we already hold, turning an
            # N-node broadcast into a tree instead of N unicasts from the
            # seed (the directory returns us under `partial_nodes`).
            try:
                self.gcs.call_async(
                    "object_location_add",
                    {"object_id": oid, "node_id": self.node_id,
                     "size": size, "partial": True})
            except Exception:  # noqa: BLE001 — advisory
                pass
            nchunks = max(1, -(-size // chunk_bytes))
            work = [i for i in range(nchunks) if i not in state.done]
            # Random chunk order per puller (BitTorrent's rarest-first
            # rationale): concurrent pullers fetching 0..N in lockstep
            # would hold identical prefixes and have nothing to trade —
            # disjoint early chunk sets are what make the partial-holder
            # swarm actually drain load off the seed.
            random.shuffle(work)
            plan.update({
                "lock": threading.Lock(),
                "work": deque(work),
                "completed": len(state.done),
                "last_progress": time.monotonic(),
                "abort": None,
            })
            if pull_span is not _tracing.NOOP_SPAN:
                # Per-chunk annotations (bounded): chunk workers append
                # (idx, ms, source) samples under plan["lock"].
                plan["trace_chunks"] = []
            # Stall-based abort, not a fixed bandwidth floor: as long as
            # chunks keep landing the pull may take as long as it takes
            # (a healthy 10 MB/s WAN link must not be declared dead);
            # only rpc_call_timeout_s with zero progress aborts.
            stall_s = GLOBAL_CONFIG.rpc_call_timeout_s
            n_workers = min(window, max(1, len(plan["work"])))
            threads = [
                threading.Thread(
                    target=self._pull_chunk_worker,
                    args=(oid, state, peers, plan, stall_s),
                    name=f"pull-{oid.hex()[:8]}-{i}", daemon=True)
                for i in range(n_workers)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if plan["abort"] is not None:
                logger.warning("pull of %s aborted: %s", oid, plan["abort"])
            ok = plan["abort"] is None and len(state.done) >= nchunks
            if ok:
                self.store.seal(oid)
                with self._lock:
                    self._pull_errors.pop(oid, None)
                try:
                    self.gcs.call("object_location_add",
                                  {"object_id": oid, "node_id": self.node_id,
                                   "size": size}, timeout=10)
                except Exception:  # noqa: BLE001 — heartbeat re-announces
                    with self._lock:
                        self._unannounced_objects[oid] = size
            return ok
        finally:
            if pull_span is not _tracing.NOOP_SPAN:
                pull_span.set_attr("chunks", max(1, -(-size // chunk_bytes)))
                pull_span.set_attr("chunk_samples",
                                   plan.get("trace_chunks") or [])
            pull_span.end(error=None if ok else "pull failed or aborted")
            with self._lock:
                self._active_pulls.pop(oid, None)
            if not ok:
                try:
                    # Drop our export first so delete() can close+unlink the
                    # segment cleanly (workers have all joined by here).
                    buf.release()
                except Exception:  # noqa: BLE001
                    pass
                self.store.delete(oid)  # never leave an unsealed buffer
                # Prompt best-effort deregistration; the heartbeat loop
                # retries until a remove definitely landed.
                with self._lock:
                    self._stale_partials.add(oid)
                try:
                    self.gcs.call(
                        "object_location_remove",
                        {"object_id": oid, "node_id": self.node_id,
                         "partial": True}, timeout=5)
                    with self._lock:
                        self._stale_partials.discard(oid)
                except Exception:  # noqa: BLE001 — heartbeat retries
                    pass

    # ---------------------------------------------------- same-host attach

    def _session_suffix_for(self, node_hex: str) -> Optional[str]:
        """shm session suffix of a SAME-HOST holder; None when the node
        is remote, dead, or unknown. In-process registry first (free),
        then the directory's SessionSuffix (hostname-gated), then the
        peer RPC — cached, since a node's suffix never changes."""
        peer = _LOCAL_RAYLETS.get(node_hex)
        if peer is not None:
            return peer.session_suffix
        cached = self._peer_suffix_cache.get(node_hex)
        if cached is not None:
            return cached or None  # "" caches a known-remote node
        my_host = self._node_info.hostname if self._node_info else ""
        suffix = ""
        try:
            for n in self.gcs.call("get_nodes", timeout=5):
                if n["NodeID"] != node_hex or not n["Alive"]:
                    continue
                if n.get("NodeManagerHostname") != my_host:
                    break  # different host: shm can't reach it
                suffix = n.get("SessionSuffix") or ""
                break
        except Exception:  # noqa: BLE001 — advisory; chunk pull covers it
            return None
        if not suffix:
            try:
                addr = self._addr_for_node(node_hex)
                if addr:
                    resp = self._peer(addr).call("get_session_suffix",
                                                 timeout=5)
                    suffix = resp.get("session_suffix") or ""
            except Exception:  # noqa: BLE001
                suffix = ""
        # raylint: disable=RL011,RL012 — keyed by node id (bounded by lifetime cluster membership, ids never reused); a dead node's entry is inert: the directory stops listing it as a holder, so the key is never consulted again
        self._peer_suffix_cache[node_hex] = suffix
        return suffix or None

    def _try_same_host_attach(self, oid: ObjectID, entry: Dict[str, Any],
                              size: int) -> bool:
        """Adopt a sealed object from a same-host holder's shm segment
        into this node's store, bypassing the chunk protocol entirely.
        Only FULL holders qualify (a partial holder's segment is
        unsealed => unattachable by final name, by construction).
        Declines whenever a transfer-shaping hook is armed on either
        end, so benches that model a network keep measuring the
        network."""
        if not GLOBAL_CONFIG.object_transfer_same_host_attach:
            return False
        if self._chunk_fetch_delay_s:
            return False  # this puller models per-RPC RTT: stay honest
        my_hex = self.node_id.hex()
        for n in entry.get("nodes") or ():
            node_hex = n.hex() if hasattr(n, "hex") else str(n)
            if node_hex == my_hex:
                continue
            peer = _LOCAL_RAYLETS.get(node_hex)
            if peer is not None and (peer._chunk_serve_delay_s
                                     or peer._chunk_serve_bw_bps):
                continue  # holder models a link: pull through it instead
            suffix = self._session_suffix_for(node_hex)
            if not suffix:
                continue
            if self._attach_copy_from_segment(oid, suffix, size):
                return True
        return False

    def _attach_copy_from_segment(self, oid: ObjectID, peer_suffix: str,
                                  size: int) -> bool:
        """Adopt `rtt_{peer_suffix}_{oid}` as this node's copy via a
        tmpfs HARDLINK to our own session name — zero bytes moved. Both
        names share the inode; the holder's eventual unlink drops only
        its name, so our copy's lifetime is independent (POSIX frees the
        pages when the last name AND mapping are gone). The final name
        only exists AFTER the holder's atomic-rename seal, so the link
        target is complete by construction. Pool-recycle safety: a
        holder's SegmentPool rewrites an inode only after the GCS
        confirmed the object freed cluster-wide — at which point reads
        of it anywhere are already undefined, same as holder-local
        zero-copy views. Falls back to a memcpy adoption where shm is
        not a linkable filesystem."""
        import os as _os

        from ray_tpu_torch.core.object_store import (
            _SHM_DIR,
            _STAGING,
            _segment_name,
        )

        if not _STAGING:  # no linkable /dev/shm on this platform
            return self._attach_memcpy_from_segment(oid, peer_suffix, size)
        src = _os.path.join(_SHM_DIR, _segment_name(peer_suffix, oid))
        dst = _os.path.join(_SHM_DIR,
                            _segment_name(self.session_suffix, oid))
        try:
            _os.link(src, dst)
        except FileNotFoundError:
            return False  # evicted/spilled since the directory answered
        except FileExistsError:
            if self.store.contains(oid):
                return True  # raced another pull of the same object
            # Stale file under our name (ours to manage): replace it.
            try:
                _os.unlink(dst)
                _os.link(src, dst)
            except OSError:
                return False
        except OSError:
            return self._attach_memcpy_from_segment(oid, peer_suffix,
                                                    size)
        try:
            if _os.stat(dst).st_size < size:
                _os.unlink(dst)
                return False  # stale directory size: not a copy to trust
            try:
                self.store.adopt(oid, size)
            except ObjectStoreFullError as e:
                with self._lock:
                    self._pull_errors[oid] = str(e)
                _os.unlink(dst)
                raise
        except OSError:
            return False  # holder unlinked the inode mid-adopt: chunk path
        with self._lock:
            self._pull_errors.pop(oid, None)
            self._attach_hits += 1
            self._attach_bytes += size
        self._announce_attached(oid, size)
        return True

    def _attach_memcpy_from_segment(self, oid: ObjectID, peer_suffix: str,
                                    size: int) -> bool:
        """Portability fallback for `_attach_copy_from_segment`: attach
        the holder's segment read-only and memcpy it into our own store
        (create -> copy -> seal). An open mapping keeps the bytes alive
        for the copy even if the holder unlinks mid-read (POSIX)."""
        from multiprocessing import shared_memory

        from ray_tpu_torch._native import copy_at
        from ray_tpu_torch.core.object_store import _segment_name, _untrack

        try:
            shm = shared_memory.SharedMemory(
                name=_segment_name(peer_suffix, oid))
        except FileNotFoundError:
            return False  # evicted/spilled since the directory answered
        except Exception:  # noqa: BLE001 — permissions, platform quirks
            return False
        _untrack(shm)  # the holder owns the segment's lifetime, not us
        try:
            if shm.size < size:
                return False  # stale directory size: not our copy to trust
            try:
                buf = self.store.create(oid, size)
            except ObjectStoreFullError as e:
                with self._lock:
                    self._pull_errors[oid] = str(e)
                raise
            copy_at(buf, 0, shm.buf[:size])
            self.store.seal(oid)
            with self._lock:
                self._pull_errors.pop(oid, None)
                self._attach_hits += 1
                self._attach_bytes += size
            self._announce_attached(oid, size)
            return True
        finally:
            try:
                shm.close()
            except BufferError:
                pass  # transient view still alive; kernel reclaims at exit

    def _announce_attached(self, oid: ObjectID, size: int):
        """Register this node as a holder of a just-adopted object so
        later pullers can route (or attach) to us."""
        try:
            self.gcs.call("object_location_add",
                          {"object_id": oid, "node_id": self.node_id,
                           "size": size}, timeout=10)
        except Exception:  # noqa: BLE001 — heartbeat re-announces
            with self._lock:
                self._unannounced_objects[oid] = size

    def _pull_chunk_worker(self, oid: ObjectID, state: _ActivePull,
                           peers: _PeerSet, plan: Dict[str, Any],
                           stall_s: float):
        """One window slot: keeps exactly one chunk request in flight,
        drawing indices from the shared work queue until drained/abort.
        W slots over one peer connection = W pipelined requests (message
        ids multiplex), so per-chunk RTT no longer serializes the pull."""
        from ray_tpu_torch._native import copy_at

        refetch_every = max(
            1, GLOBAL_CONFIG.object_transfer_refetch_location_chunks)
        my_hex = self.node_id.hex()
        while True:
            with plan["lock"]:
                if plan["abort"] is not None or not plan["work"]:
                    return
                idx = plan["work"].popleft()
            offset = idx * state.chunk_bytes
            length = min(state.chunk_bytes, state.size - offset)
            attempts = 0
            while True:
                with plan["lock"]:
                    stalled = (time.monotonic() - plan["last_progress"]
                               > stall_s)
                if stalled:
                    with plan["lock"]:
                        plan["abort"] = (
                            f"no progress for {stall_s:.0f}s "
                            f"(stuck on chunk {idx})")
                    return
                addr = peers.next()
                if addr is None:
                    if not self._refresh_pull_peers(oid, peers, my_hex):
                        # A FRESH directory answer with zero locations:
                        # the object is gone, not merely cooling down.
                        with plan["lock"]:
                            plan["abort"] = "no live locations remain"
                        return
                    if len(peers) == 0:
                        # Sources exist but are in drop-cooldown (or the
                        # directory is catching up): wait them out rather
                        # than failing a pull whose sole holder had one
                        # transient RPC error. The deadline bounds this.
                        time.sleep(0.1)
                    continue
                try:
                    meta, data, sunk = self._fetch_chunk(
                        addr, oid, offset, length,
                        sink=state.buf[offset: offset + length])
                except Exception:  # noqa: BLE001 — peer died mid-pull
                    peers.drop(addr)
                    self._refresh_pull_peers(oid, peers, my_hex)
                    continue
                st = meta.get("st")
                if st == "ok" and (sunk == length or len(data) == length):
                    if not sunk:
                        copy_at(state.buf, offset, data)
                    state.mark_done(idx)
                    with plan["lock"]:
                        plan["completed"] += 1
                        completed = plan["completed"]
                        now_mono = time.monotonic()
                        chunks = plan.get("trace_chunks")
                        if chunks is not None and len(chunks) < 32:
                            chunks.append(
                                [idx, round((now_mono
                                             - plan["last_progress"]) * 1e3,
                                            2), addr])
                        plan["last_progress"] = now_mono
                    if completed % refetch_every == 0:
                        # Pick up sources that appeared mid-pull.
                        self._refresh_pull_peers(oid, peers, my_hex)
                    break
                if st == "busy":
                    # Sender sheds us: try the hinted holders first.
                    for alt in meta.get("alt") or ():
                        peers.add(self._addr_for_node(alt))
                elif meta.get("gone"):
                    # Peer no longer has ANY copy (evicted/deleted).
                    peers.drop(addr)
                # else "missing": a partial source that simply lacks this
                # chunk yet — keep it for the chunks it does have.
                attempts += 1
                if attempts % max(1, len(peers) or 1) == 0:
                    self._refresh_pull_peers(oid, peers, my_hex)
                    time.sleep(0.02)  # every source busy/missing: back off

    def _fetch_chunk(self, addr: str, oid: ObjectID, offset: int,
                     length: int, sink: Optional[memoryview] = None,
                     ) -> Tuple[Dict[str, Any], memoryview, int]:
        """One chunk RPC. With `sink` (the chunk's slice of the store
        buffer) a matching reply is received DIRECTLY into it — zero-copy
        on the receive side; `sunk` reports the bytes landed there.
        Returns (meta, spilled chunk bytes if not sunk, sunk)."""
        if self._chunk_fetch_delay_s:
            # Test/bench hook modeling per-RPC propagation latency: window
            # slots sleep concurrently, so window>1 hides it exactly the
            # way pipelining hides real RTT.
            time.sleep(self._chunk_fetch_delay_s)
        peer = self._peer(addr)
        req = msgpack.packb({"o": oid.binary(), "f": offset, "l": length,
                             "p": self.node_id.hex()})
        if sink is not None:
            raw, sunk = peer.call_raw_into(
                "pull_object_chunk", req, sink,
                timeout=GLOBAL_CONFIG.rpc_call_timeout_s)
        else:
            raw = peer.call_raw("pull_object_chunk", req,
                                timeout=GLOBAL_CONFIG.rpc_call_timeout_s)
            sunk = 0
        meta, data = _unpack_chunk_reply(raw)
        return meta, data, sunk

    def _addr_for_node(self, node_hex: str,
                       nodes: Optional[List[Dict[str, Any]]] = None,
                       ) -> Optional[str]:
        """Raylet address of a node: gossiped view first, GCS fallback.
        `nodes` is an optional pre-fetched get_nodes() answer so batch
        resolution pays one directory round trip, not one per node."""
        addr = self._cluster_view.get(node_hex, {}).get("address")
        if addr:
            return addr
        if nodes is None:
            try:
                nodes = self.gcs.call("get_nodes")
            except Exception:  # noqa: BLE001 — resolution is best-effort
                return None
        return next((n["RayletAddress"] for n in nodes
                     if n["NodeID"] == node_hex and n["Alive"]), None)

    def _add_entry_peers(self, peers: _PeerSet, entry: Dict[str, Any],
                         my_hex: str) -> int:
        """Resolve a directory entry's locations (full + partial) to raylet
        addresses and add them as stripe sources. Returns the number of
        advertised non-self locations (whether or not each add succeeded —
        a cooling-down peer still counts as an advertised source)."""
        hexes: List[str] = []
        for n in list(entry.get("nodes") or ()) + \
                list(entry.get("partial_nodes") or ()):
            h = n.hex() if hasattr(n, "hex") else str(n)
            if h != my_hex:
                hexes.append(h)
        nodes_cache = None
        for h in hexes:
            addr = self._cluster_view.get(h, {}).get("address")
            if addr is None:
                if nodes_cache is None:
                    try:
                        nodes_cache = self.gcs.call("get_nodes")
                    except Exception:  # noqa: BLE001
                        nodes_cache = []
                addr = self._addr_for_node(h, nodes_cache)
            peers.add(addr)
        return len(hexes)

    def _refresh_pull_peers(self, oid: ObjectID, peers: _PeerSet,
                            my_hex: str) -> bool:
        """Re-query the directory for locations that appeared since the
        pull started (rate-limited across this pull's workers). Returns
        False only when a FRESH directory answer advertises no location at
        all — a peer in drop-cooldown or a failed/rate-limited query is
        'undecided' (True), and the pull deadline bounds how long workers
        keep waiting on undecided sources."""
        if not peers.may_refresh():
            return True  # rate-limited: undecided
        try:
            entry = self.gcs.call("object_locations_get",
                                  {"object_id": oid}, timeout=5)
        except Exception:  # noqa: BLE001 — GCS unreachable: undecided
            return True
        advertised = self._add_entry_peers(peers, entry, my_hex)
        return len(peers) > 0 or advertised > 0

    def _peer(self, address: str) -> RpcClient:
        stale = []
        with self._lock:
            client = self._peer_clients.get(address)
            if client is None or client.is_closed:
                # Amortized pruning on the (rare) dial path: node churn
                # must not grow the peer cache by one client — reconnect
                # state and all — per address that ever existed. A peer
                # is stale once closed or once no live node advertises
                # its address anymore (closed outside the lock).
                live = {e.get("address")
                        for e in self._cluster_view.values()}
                for addr in list(self._peer_clients):
                    c = self._peer_clients[addr]
                    if c.is_closed or (live and addr not in live):
                        stale.append(self._peer_clients.pop(addr))
                client = RpcClient(address, name=f"raylet-peer")
                self._peer_clients[address] = client
        for c in stale:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — already closed/dead peer
                pass
        return client

    # A puller with no chunk served for this long no longer counts against
    # the sender-side concurrency gate (its transfer finished or died).
    _OUTBOUND_ACTIVE_S = 2.0
    # Redirect hints expire: a node that pulled the object from us may
    # have evicted it since, and shedding pullers to a non-holder wedges
    # them between a busy seed and a dead-end hint.
    _HINT_TTL_S = 30.0
    # Coverage-ledger entries idle this long belong to dead/finished
    # transfers — pruned so they can't exempt a restarted puller from
    # the gate or pin the ledger at its size cap.
    _COVERAGE_TTL_S = 60.0

    def _admit_puller(self, oid: ObjectID,
                      puller: Optional[str]) -> Optional[List[str]]:
        """Sender-side fairness: None admits the request; a list of
        redirect hints (node hexes that already pulled the full object
        from us) means 'busy'. A puller mid-transfer is always admitted,
        the gate is per object, and a new puller is only shed when there
        IS an alternative holder to hint at — shedding with nowhere to go
        would fail pulls of an object whose sole copy lives here. So N
        simultaneous pullers self-organize into a tree instead of
        convoying on one NIC, and a lone source still serves everyone."""
        limit = GLOBAL_CONFIG.object_transfer_sender_concurrency
        if not limit or not puller:
            return None
        oid_b = oid.binary()
        now = time.monotonic()
        with self._outbound_lock:
            for k, ts in list(self._outbound_last_seen.items()):
                if now - ts > self._OUTBOUND_ACTIVE_S:
                    del self._outbound_last_seen[k]
            for k, rec in list(self._outbound_chunks.items()):
                if now - rec[1] > self._COVERAGE_TTL_S:
                    del self._outbound_chunks[k]
            key = (oid_b, puller)
            active = sum(1 for (o, p) in self._outbound_last_seen
                         if o == oid_b and p != puller)
            alts = self._fresh_hints_locked(oid_b, puller, now)
            # _outbound_chunks membership exempts SLOW mid-transfer
            # pullers whose per-chunk cadence exceeds the activity
            # window — "mid-transfer is always admitted" must hold on a
            # trickling WAN link too, not just on fast LANs.
            if (key in self._outbound_last_seen
                    or key in self._outbound_chunks
                    or active < limit or not alts):
                self._outbound_last_seen[key] = now
                return None
            return alts

    def _fresh_hints_locked(self, oid_b: bytes, puller: str,
                            now: float) -> List[str]:
        """Non-expired redirect hints for an object (caller holds
        _outbound_lock); expired holders are pruned in place."""
        holders = self._completed_pullers.get(oid_b)
        if not holders:
            return []
        for h, ts in list(holders.items()):
            if now - ts > self._HINT_TTL_S:
                del holders[h]
        if not holders:
            self._completed_pullers.pop(oid_b, None)
            return []
        return [h for h in holders if h != puller]

    def _record_outbound(self, oid: ObjectID, puller: Optional[str],
                         offset: int, nbytes: int, size: int):
        """Per-puller coverage bookkeeping feeding the fairness gate's
        redirect hints. With the gate disabled nothing ever reads these
        tables — and nothing prunes them — so record nothing."""
        if not puller or not GLOBAL_CONFIG.object_transfer_sender_concurrency:
            return
        key = (oid.binary(), puller)
        now = time.monotonic()
        with self._outbound_lock:
            self._outbound_last_seen[key] = now
            if len(self._outbound_chunks) >= 1024 and \
                    key not in self._outbound_chunks:
                # Evict the LEAST-RECENTLY-ACTIVE entry, not the oldest
                # insertion — a live trickling puller must keep its
                # coverage record under sustained many-object load.
                self._outbound_chunks.pop(min(
                    self._outbound_chunks,
                    key=lambda k: self._outbound_chunks[k][1]))
            rec = self._outbound_chunks.setdefault(key, [{}, now])
            offsets = rec[0]
            rec[1] = now
            offsets[offset] = max(offsets.get(offset, 0), nbytes)
            # Distinct-coverage completion: a re-served chunk counts once,
            # so retries can't mark a partial puller as a full holder.
            if sum(offsets.values()) >= size:
                self._outbound_chunks.pop(key, None)
                if len(self._completed_pullers) >= 256:
                    self._completed_pullers.pop(
                        next(iter(self._completed_pullers)))
                holders = self._completed_pullers.setdefault(
                    oid.binary(), {})
                if len(holders) < 16 or puller in holders:
                    holders[puller] = time.monotonic()

    def _serve_chunk_raw(self, conn: Connection, payload: bytes):
        """Raw-RPC chunk server (`pull_object_chunk`): serves a slice of a
        sealed object — or of an in-progress pull whose covering chunks
        already landed — as a memoryview of the store segment. The reply
        is sent inside the handler (DEFERRED) so the segment stays pinned
        for exactly the duration of the vectored zero-copy write."""
        req = msgpack.unpackb(payload)
        oid = ObjectID(req["o"])
        offset = int(req["f"])
        length = int(req["l"])
        puller = req.get("p")
        if self._chunk_serve_delay_s:
            time.sleep(self._chunk_serve_delay_s)  # test/bench RTT hook
        alts = self._admit_puller(oid, puller)
        if alts is not None:
            return _pack_chunk_reply({"st": "busy", "alt": alts})
        msg_id = conn.current_msg_id
        self.store.pin(oid)
        try:
            buf = self.store.get_buffer(oid)
            size = len(buf) if buf is not None else 0
            if buf is None:
                state = self._active_pulls.get(oid)
                if state is not None and state.covers(offset, length):
                    buf, size = state.buf, state.size
                elif state is not None:
                    return _pack_chunk_reply({"st": "missing", "s": state.size})
                else:
                    # Re-check the store: our own pull may have sealed (and
                    # popped _active_pulls) between the two lookups — a
                    # spurious `gone` would permanently blacklist us in
                    # the requester's peer set.
                    buf = self.store.get_buffer(oid)
                    if buf is None:
                        return _pack_chunk_reply({"st": "missing",
                                                  "gone": True})
                    size = len(buf)
            if offset >= size:
                return _pack_chunk_reply({"st": "missing", "s": size})
            end = min(offset + length, size) if length else size
            if self._chunk_serve_bw_bps:
                # Serialized per-node egress: concurrent transfers share
                # the one modeled link instead of sleeping in parallel.
                with self._link_lock:
                    # Sleeping under the lock IS the model: concurrent
                    # sends must serialize on the one emulated link.
                    time.sleep(  # raylint: disable=RL002
                        (end - offset) / self._chunk_serve_bw_bps)
            self._record_outbound(oid, puller, offset, end - offset, size)
            with self._outbound_lock:
                # Cross-node byte meter: benches A/B locality routing by
                # summing this over all raylets (attach hits never pass
                # here — that's the point).
                self._chunk_bytes_served += end - offset
            conn.reply_raw(msg_id, "pull_object_chunk",
                           _pack_chunk_reply({"st": "ok", "s": size},
                                             buf[offset:end]))
            return DEFERRED
        finally:
            self.store.unpin(oid)

    # raylint: disable=RL014 — kept for debug tooling / mixed-version peers
    def handle_pull_object(self, conn: Connection, data: Dict[str, Any]):
        """Legacy pickled transfer surface: one chunk (or, without offset,
        the whole object). The pipelined puller speaks the raw
        `pull_object_chunk` method instead; this stays for debug tooling
        and mixed-version peers."""
        oid: ObjectID = data["object_id"]
        buf = self.store.get_buffer(oid)
        if buf is None:
            return {"data": None}
        if "offset" not in data:
            return {"data": bytes(buf), "size": len(buf)}
        off = int(data["offset"])
        length = int(data.get("length") or len(buf))
        return {"data": bytes(buf[off: off + length]), "size": len(buf)}

    def handle_get_or_pull(self, conn: Connection, data: Dict[str, Any]):
        """Local client wants this object available in the node store.

        Event-driven (no server-side poll loop — a blocking handler would
        also head-of-line-block every other RPC on the caller's
        connection): answers immediately with local/inline, or registers
        the connection as a waiter, starts a pull, and later pushes
        `object_ready` / `object_unavailable` down the caller's channel.
        """
        oid: ObjectID = data["object_id"]
        # get_buffer (not contains) so spilled objects are restored to shm
        # before we tell the client to attach the segment.
        if self.store.get_buffer(oid) is not None:
            return {"status": "local"}
        entry = self.gcs.call("object_locations_get", {"object_id": oid}, timeout=10)
        if entry.get("known") and entry.get("inline") is not None:
            return {"status": "inline", "data": entry["inline"]}
        with self._lock:
            pull_error = self._pull_errors.get(oid)
            if pull_error is not None:
                return {"status": "error", "error": pull_error}
            waiters = self._object_waiters[oid]
            if conn not in waiters:
                waiters.append(conn)
        self._start_pull(oid)
        # Re-check after registration: the pull may have completed between
        # the first check and the waiter insert (notify already fired).
        if self.store.get_buffer(oid) is not None:
            with self._lock:
                ws = self._object_waiters.get(oid)
                if ws is not None:
                    try:
                        ws.remove(conn)
                    except ValueError:
                        pass
                    if not ws:
                        self._object_waiters.pop(oid, None)
            return {"status": "local"}
        # has_copies tells the owner whether reconstruction is needed: the
        # entry exists but every holding node is gone. An entry that only
        # borrowers created (a nested ref whose task has not finished)
        # was never located, so it is still pending, not lost.
        return {"status": "pending",
                "known": bool(entry.get("known") and entry.get("located")),
                "has_copies": bool(entry.get("nodes"))}

    def _notify_object_waiters(self, oid: ObjectID, method: str):
        with self._lock:
            conns = self._object_waiters.pop(oid, [])
        for conn in conns:
            if conn.alive:
                try:
                    conn.push(method, {"object_id": oid})
                except Exception:  # noqa: BLE001 — client gone
                    pass

    def _on_object_local(self, oid: ObjectID):
        """Dependency became available locally (or inline): unblock tasks."""
        with self._lock:
            waiters = self._waiting_deps.pop(oid, [])
            for qt in waiters:
                qt.deps_remaining.discard(oid)
        if waiters:
            self._dispatch_event.set()
        self._notify_object_waiters(oid, "object_ready")

    def handle_cancel_task(self, conn: Connection, data: Dict[str, Any]):
        """Cancel a queued or running normal task (reference
        `ray.cancel`): queued tasks are dropped; running tasks get an
        interrupt signal (or, with force, their worker is killed). The
        submitter receives TaskCancelledError either way, and cancelled
        tasks are never retried."""
        import signal as _signal

        from ray_tpu_torch.exceptions import TaskCancelledError

        task_id = data["task_id"]
        force = bool(data.get("force"))
        tkey = task_id.binary()
        err = serialization.serialize_exception(
            TaskCancelledError(task_id), "cancelled")
        with self._lock:
            queued = next((qt for qt in self._queue
                           if qt.spec.task_id.binary() == tkey), None)
            if queued is not None:
                self._queue.remove(queued)
                for dep in queued.deps_remaining:
                    waiters = self._waiting_deps.get(dep)
                    if waiters and queued in waiters:
                        waiters.remove(queued)
                submitter = self._task_submitters.pop(tkey, None)
        if queued is not None:
            if submitter is not None and submitter.alive:
                try:
                    submitter.push("task_result",
                                   {"task_id": task_id, "results": [],
                                    "error": err})
                except Exception:  # noqa: BLE001
                    pass
            return {"cancelled": "queued"}
        with self._lock:
            entry = self._running.get(tkey)
        if entry is None:
            return {"cancelled": None}  # already finished (or elsewhere)
        spec, worker = entry
        if not force:
            # Cooperative interrupt: tell the worker WHICH task to cancel —
            # it signals itself after recording the id, and its handler
            # verifies the id before raising, so a cancel can never hit a
            # different task the worker has since started. Normal
            # task_done reports the error (crashed=False -> no retry).
            try:
                worker.conn.push("cancel_exec", {"task_id": task_id})
                return {"cancelled": "interrupted"}
            except Exception:  # noqa: BLE001 — worker gone
                return {"cancelled": None}
        # Force: pre-empt the result so the submitter sees cancellation
        # (not WorkerCrashedError), then kill the worker process.
        with self._lock:
            self._running.pop(tkey, None)
            submitter = self._task_submitters.pop(tkey, None)
        if submitter is not None and submitter.alive:
            try:
                submitter.push("task_result",
                               {"task_id": task_id, "results": [],
                                "error": err})
            except Exception:  # noqa: BLE001
                pass
        if worker.proc is not None and worker.proc.poll() is None:
            try:
                worker.proc.terminate()
            except Exception:  # noqa: BLE001
                pass
        return {"cancelled": "killed"}

    def handle_cancel_object_wait(self, conn: Connection, data: Dict[str, Any]):
        """Client gave up on a get (timeout): drop its waiter entry so the
        raylet stops pulling on behalf of nobody."""
        oid: ObjectID = data["object_id"]
        with self._lock:
            ws = self._object_waiters.get(oid)
            if ws is not None:
                try:
                    ws.remove(conn)
                except ValueError:
                    pass
                if not ws:
                    del self._object_waiters[oid]
        return {}

    def handle_delete_objects(self, conn: Connection, data: Dict[str, Any]):
        skip = {o.binary() for o in data.get("skip_unlink", ())}
        for oid in data["object_ids"]:
            self.store.delete(oid, skip_unlink=oid.binary() in skip)
        return {}

    def handle_set_resource(self, conn: Connection, data: Dict[str, Any]):
        """Dynamic custom resources (reference
        `experimental/dynamic_resources.py` -> raylet SetResource): set a
        resource's TOTAL capacity on this node at runtime; queued tasks
        waiting on it re-dispatch."""
        name = data["resource_name"]
        capacity = float(data["capacity"])
        if name in ("CPU", "GPU", "memory", "object_store_memory") \
                or name.startswith("node:"):
            raise ValueError(
                f"cannot dynamically override built-in resource {name!r}")
        if capacity < 0 or not math.isfinite(capacity):
            # NaN would poison the ledger permanently: the abs()<eps
            # delete guard and every feasibility comparison are False
            # against NaN.
            raise ValueError(
                f"resource capacity must be finite and >= 0, "
                f"got {capacity}")
        self.resources.set_total(name, capacity)
        self._dispatch_event.set()
        return {"total": capacity}

    # ------------------------------------------------- placement group 2PC

    def handle_prepare_bundle(self, conn: Connection, data: Dict[str, Any]):
        pg = data["pg"]
        idx: int = data["bundle_index"]
        bundle: Dict[str, float] = pg.bundles[idx]
        if not self.resources.try_acquire(bundle):
            return {"ok": False}
        with self._lock:
            self._bundles[(pg.pg_id.binary(), idx)] = {
                "pg": pg, "bundle": bundle, "state": "prepared"}
        return {"ok": True}

    def handle_commit_bundle(self, conn: Connection, data: Dict[str, Any]):
        pg_id: PlacementGroupID = data["pg_id"]
        idx: int = data["bundle_index"]
        with self._lock:
            rec = self._bundles.get((pg_id.binary(), idx))
            if rec is None or rec["state"] != "prepared":
                return {"ok": False}
            rec["state"] = "committed"
        pg = rec["pg"]
        formatted: Dict[str, float] = {}
        for base, amt in rec["bundle"].items():
            formatted[pg.bundle_resource_name(base, idx)] = amt
            wc = pg.wildcard_resource_name(base)
            formatted[wc] = formatted.get(wc, 0) + amt
        rec["formatted"] = formatted
        self.resources.add_resources(formatted)
        return {"ok": True}

    def handle_cancel_bundle(self, conn: Connection, data: Dict[str, Any]):
        pg_id: PlacementGroupID = data["pg_id"]
        idx: int = data["bundle_index"]
        with self._lock:
            rec = self._bundles.pop((pg_id.binary(), idx), None)
        if rec is not None and rec["state"] == "prepared":
            self.resources.release(rec["bundle"])
        return {}

    def handle_return_bundle(self, conn: Connection, data: Dict[str, Any]):
        pg_id: PlacementGroupID = data["pg_id"]
        idx: int = data["bundle_index"]
        with self._lock:
            rec = self._bundles.pop((pg_id.binary(), idx), None)
        if rec is None:
            return {}
        if rec["state"] == "committed":
            self.resources.remove_resources(rec.get("formatted", {}))
            self.resources.release(rec["bundle"])
        elif rec["state"] == "prepared":
            self.resources.release(rec["bundle"])
        return {}

    # --------------------------------------------------------------- debug

    def handle_get_session_suffix(self, conn: Connection, data=None):
        return {"session_suffix": self.session_suffix,
                "session_dir": self.session_dir}

    def handle_debug_state(self, conn: Connection, data=None):
        total, avail = self.resources.snapshot()
        with self._lock:
            return {
                "node_id": self.node_id.hex(),
                "queued": len(self._queue),
                "running": len(self._running),
                "workers": self.pool.num_alive(),
                "worker_spawns": dict(self.pool.spawn_counts),
                "forge_alive": bool(self.forge is not None
                                    and self.forge.alive),
                "resources_total": total,
                "resources_available": avail,
                "store": self.store.stats(),
                "transfer": {
                    "attach_hits": self._attach_hits,
                    "attach_bytes": self._attach_bytes,
                    "chunk_bytes_served": self._chunk_bytes_served,
                },
            }
