"""Shared control-plane data types: task specs, actor specs, node info.

Equivalent of the reference's `src/ray/common/task/task_spec.h` and
`gcs.proto` node/actor table entries, as plain picklable dataclasses.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID

# Resource names. GPU is the accelerator resource, where the JAX package
# has TPU: a GPU grant pins the worker to its cards (raylet.py).
CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
# Env marker of a worker spawned for a GPU grant (its value: the GPUs
# granted), which lease matching and the forge read; the counterpart of
# the JAX package's RAY_TPU_GRANTED_TPU.
GPU_GRANT = "RAY_TPU_TORCH_GRANTED_GPU"
OBJECT_STORE_MEMORY = "object_store_memory"


def normalize_resources(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    memory: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    default_cpus: float = 1.0,
) -> Dict[str, float]:
    out: Dict[str, float] = {}
    out[CPU] = float(num_cpus) if num_cpus is not None else default_cpus
    if num_gpus:
        out[GPU] = float(num_gpus)
    if memory:
        out[MEMORY] = float(memory)
    if resources:
        for k, v in resources.items():
            if k in (CPU, GPU, MEMORY):
                raise ValueError(f"Use num_cpus/num_gpus/memory instead of "
                                 f"resources[{k!r}]")
            out[k] = float(v)
    return {k: v for k, v in out.items() if v != 0}


class ActorState(str, Enum):
    # Mirrors the GCS-owned actor lifecycle state machine
    # (reference `gcs_actor_manager.h:240-281`).
    DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
    PENDING_CREATION = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class TaskState(str, Enum):
    PENDING_ARGS_AVAIL = "PENDING_ARGS_AVAIL"
    PENDING_NODE_ASSIGNMENT = "PENDING_NODE_ASSIGNMENT"
    PENDING_ARGS_FETCH = "PENDING_ARGS_FETCH"
    SUBMITTED_TO_WORKER = "SUBMITTED_TO_WORKER"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"


class SchedulingStrategy:
    """Base marker; see ray_tpu_torch.util.scheduling_strategies for concrete ones."""


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    name: str
    # Function is either inline pickled bytes (small closures) or a function_id
    # key into the GCS function table (exported once per driver).
    function_id: Optional[str]
    function_blob: Optional[bytes]
    # Args: list of ("v", pickled bytes) inline values or ("r", ObjectID) refs.
    args: List[Tuple[str, Any]] = field(default_factory=list)
    kwargs_keys: List[str] = field(default_factory=list)  # last len(kwargs_keys) args are kwargs
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    # Actor creation: resources required to *schedule* the creation task
    # (reference: PlacementResources — default-CPU actors need 1 CPU to be
    # placed but 0 for their lifetime, so idle actors don't pin cores).
    placement_resources: Optional[Dict[str, float]] = None
    max_retries: int = 0
    retry_exceptions: bool = False
    # Actor fields
    actor_id: Optional[ActorID] = None          # actor task target
    actor_creation: bool = False                # this task creates an actor
    actor_class_blob: Optional[bytes] = None
    actor_max_restarts: int = 0
    actor_max_concurrency: int = 1
    # Which incarnation this creation dispatch is: 0 on first creation,
    # N on the Nth max_restarts restart. The worker passes it to the
    # class's optional `__ray_restart__(restart_count)` state-restore
    # hook so a restarted actor can rebuild state it cannot get from
    # __init__ args alone (reload a checkpoint, re-register, ...).
    actor_restart_count: int = 0
    actor_name: Optional[str] = None
    actor_namespace: Optional[str] = None
    actor_lifetime: Optional[str] = None        # None | "detached"
    method_name: Optional[str] = None
    seq_no: int = 0
    # Scheduling
    scheduling_strategy: Optional[Any] = None   # SchedulingStrategy instance
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    owner_address: Optional[str] = None         # submitter's callback address (raylet conn)
    runtime_env: Optional[Dict[str, Any]] = None
    # Executed over the owner's direct worker-lease channel (bypassing the
    # per-task raylet hop); results then follow actor-result visibility
    # rules (lazy directory publication by the owner).
    direct: bool = False
    # Refs pickled INSIDE argument values (not top-level): pinned by the
    # owner until the task completes, by which time the executing worker
    # has registered its borrow (reference reference_count.h borrowers).
    nested_refs: List["ObjectID"] = field(default_factory=list)
    # Distributed trace context (reference tracing_helper.py:35-81
    # _inject_tracing_into_function): {trace_id, span_id, parent_span_id}
    # — children submitted during execution inherit trace_id and parent.
    trace_ctx: Optional[Dict[str, str]] = None
    # Provenance for state API / timeline
    submitted_at: float = field(default_factory=time.time)

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_return(self.task_id, i + 1) for i in range(self.num_returns)]

    def dependencies(self) -> List[ObjectID]:
        return [a[1] for a in self.args if a[0] == "r"]


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str                    # raylet RPC address
    object_manager_address: str     # raylet's object transfer address (same server)
    session_suffix: str             # shm namespace for the node's store
    hostname: str = ""
    ip: str = "127.0.0.1"
    resources_total: Dict[str, float] = field(default_factory=dict)
    resources_available: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    state: str = "ALIVE"            # ALIVE | DEAD
    last_heartbeat: float = field(default_factory=time.time)
    is_head: bool = False

    def to_public(self) -> Dict[str, Any]:
        return {
            "NodeID": self.node_id.hex(),
            "Alive": self.state == "ALIVE",
            "NodeManagerAddress": self.ip,
            "NodeManagerHostname": self.hostname,
            "RayletAddress": self.address,
            # shm namespace of the node's store: same-host consumers
            # attach sealed segments by name (zero-socket handoff).
            "SessionSuffix": self.session_suffix,
            "Resources": dict(self.resources_total),
            "Available": dict(self.resources_available),
            "Labels": dict(self.labels),
            "IsHead": self.is_head,
        }


@dataclass
class ActorInfo:
    actor_id: ActorID
    job_id: JobID
    class_name: str
    state: ActorState = ActorState.DEPENDENCIES_UNREADY
    node_id: Optional[NodeID] = None
    worker_id: Optional[WorkerID] = None
    direct_address: Optional[str] = None   # worker's direct-call RPC server
    name: Optional[str] = None
    namespace: str = "default"
    max_restarts: int = 0
    num_restarts: int = 0
    lifetime: Optional[str] = None
    death_cause: Optional[str] = None
    resources: Dict[str, float] = field(default_factory=dict)
    creation_spec: Optional[TaskSpec] = None
    owner_worker_id: Optional[WorkerID] = None

    def to_public(self) -> Dict[str, Any]:
        return {
            "ActorID": self.actor_id.hex(),
            "ClassName": self.class_name,
            "State": self.state.value,
            "Name": self.name or "",
            "Namespace": self.namespace,
            "NodeID": self.node_id.hex() if self.node_id else None,
            "Address": self.direct_address,
            "NumRestarts": self.num_restarts,
            "DeathCause": self.death_cause,
        }


@dataclass
class JobInfo:
    job_id: JobID
    driver_pid: int
    entrypoint: str = ""
    state: str = "RUNNING"           # RUNNING | SUCCEEDED | FAILED
    start_time: float = field(default_factory=time.time)
    end_time: Optional[float] = None
    namespace: str = "default"
    # Links a driver job to the submitted-job record that launched it
    # (empty for interactive drivers): job-tier status, logs, and tenant
    # QoS resolve through this.
    submission_id: str = ""


class PlacementStrategy(str, Enum):
    PACK = "PACK"
    SPREAD = "SPREAD"
    STRICT_PACK = "STRICT_PACK"
    STRICT_SPREAD = "STRICT_SPREAD"


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: PlacementStrategy
    name: Optional[str] = None
    state: str = "PENDING"           # PENDING | CREATED | REMOVED | RESCHEDULING
    # bundle index -> node id, filled at commit time
    bundle_locations: Dict[int, NodeID] = field(default_factory=dict)
    job_id: Optional[JobID] = None
    lifetime: Optional[str] = None

    def bundle_resource_name(self, base: str, index: int) -> str:
        return pg_bundle_resource_name(base, index, self.pg_id)

    def wildcard_resource_name(self, base: str) -> str:
        return pg_wildcard_resource_name(base, self.pg_id)


def pg_bundle_resource_name(base: str, index: int, pg_id) -> str:
    """`CPU_group_0_<pgid>` style indexed name as in the reference
    (`src/ray/common/placement_group.h` BundleSpec resource formatting).
    The single source of truth for the format — raylet commit, task
    submission, and actor placement must all agree."""
    return f"{base}_group_{index}_{pg_id.hex()}"


def pg_wildcard_resource_name(base: str, pg_id) -> str:
    return f"{base}_group_{pg_id.hex()}"
