"""Global configuration flag table.

The port's copy of `ray_tpu/core/config.py`: the same declarative table of
flags, overridable through `RAY_TPU_<NAME>` environment variables (the
reference's names, so one setting tunes both packages alike) and
`init(_system_config=...)`. An explicit assignment (`GLOBAL_CONFIG.flag =
x`) wins, else the environment, else the default; environment reads are
memoized until `refresh()`. The runtime's own process variables (session,
addresses, grants) take the `RAY_TPU_TORCH_` prefix instead, so that a
reference cluster and a port cluster can run side by side.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class _Flag:
    name: str
    type: Callable
    default: Any
    doc: str


_FLAG_TABLE: Dict[str, _Flag] = {}


def _flag(name: str, type_: Callable, default: Any, doc: str = ""):
    _FLAG_TABLE[name] = _Flag(name, type_, default, doc)


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


# --- Core runtime -----------------------------------------------------------
_flag("raylet_heartbeat_period_ms", int, 1000, "Raylet -> GCS resource report period")
_flag("resource_delta_min_interval_ms", int, 50,
      "Coalescing window for streamed resource deltas (ray_syncer "
      "equivalent); 0 disables streaming and falls back to "
      "heartbeat-only reports")
_flag("runtime_env_cache_bytes", int, 1 << 30,
      "LRU byte cap for runtime_env packages in the GCS KV")
_flag("runtime_env_eviction_grace_s", float, 300.0,
      "Never LRU-evict a runtime_env blob accessed this recently (in-flight "
      "task specs may still reference it)")
_flag("health_check_period_ms", int, 2000, "GCS node health check period")
_flag("health_check_failure_threshold", int, 5, "Missed health checks before a node is marked dead")
_flag("worker_lease_timeout_ms", int, 60000,
      "Max time waiting for a worker lease (covers a cold worker spawn: "
      "a fresh interpreter importing torch can take >30s on a loaded "
      "host)")
_flag("worker_forge_enabled", _parse_bool, True,
      "Per-node forkserver template ('worker forge'): a process that "
      "preimports the worker module set once and fork()s fully-imported "
      "workers on demand in ~10-20ms, instead of paying exec + imports "
      "per spawn. Cold exec spawn remains the fallback (and the only "
      "path for fork-incompatible grants, e.g. a GPU grant)")
_flag("worker_forge_preimports", str, "ray_tpu_torch.core.worker,numpy",
      "Comma-separated modules the forge template preimports. Must stay "
      "fork-safe: no module here may start threads or initialize CUDA "
      "at import time (the forge refuses to fork otherwise). Add 'torch' "
      "when workers are torch-heavy: importing it leaves CUDA "
      "uninitialized")
_flag("object_inline_max_bytes", int, 100 * 1024, "Objects at or below this size travel inline through the control plane")
_flag("object_store_memory_bytes", int, 0, "Shared-memory store capacity; 0 = auto (30% of system RAM)")
_flag("segment_pool_max_bytes", int, 256 * 1024 * 1024,
      "Warm shm segments recycled across puts (0 disables); see SegmentPool")
_flag("object_spill_dir", str, "", "Directory for spilled objects; empty = <session>/spill")
_flag("task_max_retries", int, 3, "Default retries for normal tasks")
_flag("actor_max_restarts", int, 0, "Default actor restarts")
_flag("scheduler_spread_threshold", float, 0.5, "Hybrid policy: utilization below which packing is preferred")
_flag("rpc_connect_timeout_s", float, 10.0, "TCP connect timeout for internal RPC")
_flag("rpc_call_timeout_s", float, 120.0, "Default RPC call timeout")
_flag("direct_task_enabled", _parse_bool, True,
      "Lease-cached direct-to-worker submission for eligible normal tasks")
_flag("direct_burst_depth_max", int, 16,
      "Cap on the adaptive per-worker pipeline deepening during "
      "submission bursts (set to direct_pipeline_depth to disable)")
_flag("direct_pipeline_depth", int, 2,
      "Task specs in flight per leased worker (keeps the worker busy while "
      "a result is on the wire)")
_flag("direct_max_leases", int, 16,
      "Max concurrent worker leases per scheduling key per owner")
_flag("direct_lease_idle_s", float, 2.0,
      "Idle time before a cached worker lease is returned to the raylet")
_flag("direct_flush_tick_ms", float, 0.2,
      "Owner-side submission flush tick: .remote() calls enqueue and a "
      "dedicated flusher coalesces everything that accumulated into one "
      "multi-spec push frame per lease per pump. The tick bounds how "
      "long a lone submit waits for company; the flusher always wakes "
      "immediately on the first enqueue, so an idle submit pays one "
      "thread handoff, not the tick. 0 disables: every submit pumps "
      "inline on the caller thread (pre-batching behavior, the A-B-A "
      "inertness baseline)")
_flag("direct_lease_steal", _parse_bool, True,
      "Cross-key warm-lease reuse: a backlogged scheduling key may adopt "
      "another key's idle cached lease when the lease's granted "
      "resources cover the new key's demand and the runtime-env "
      "signature matches — skipping the raylet round trip entirely. "
      "Off: leases only ever serve the key that requested them")
_flag("direct_result_batch_max", int, 16,
      "Leased-worker result coalescing: while more direct tasks from the "
      "same owner are queued locally, the worker buffers up to this many "
      "task results and flushes them as ONE task_result_batch push (the "
      "last queued task always flushes immediately, so latency is only "
      "traded when the pipeline is already deep). 1 disables coalescing")
_flag("arg_dedupe_cache_entries", int, 512,
      "Owner-side by-value argument dedupe cache: small immutable args "
      "(str/bytes/int/float/bool/None) serialize once per owner and "
      "repeat submissions reuse the blob. LRU-bounded entry count; 0 "
      "disables")
_flag("pubsub_delta_flush_ms", float, 5.0,
      "GCS pubsub delta-batching tick: OBJECT and RESOURCES channel "
      "publishes accumulate per subscriber (coalesced latest-wins per "
      "key; resource deltas merge per node) and flush as one bounded "
      "monotonic pubsub_batch frame per tick, instead of one push frame "
      "+ one pickle per event per subscriber. 0 disables: every publish "
      "pushes immediately (pre-batching behavior)")
_flag("pubsub_batch_max_events", int, 512,
      "Max coalesced events per pubsub_batch frame; a flush with more "
      "pending events emits multiple frames (bounded frames, nothing "
      "dropped)")
_flag("resource_broadcast_min_interval_ms", int, 100,
      "Rate limit on full resource-view broadcasts (each heartbeat "
      "requests one): at most one per interval, with a trailing "
      "broadcast for the last coalesced request so views still "
      "converge. 0 broadcasts every time (pre-batching behavior). At "
      "100 nodes x 1 heartbeat/s, unthrottled full-view fanout is "
      "10k pickles/s of a 100-entry dict — pure control-plane burn")
_flag("task_events_max_buffer", int, 100000, "Max task events retained by the GCS task manager")
_flag("memory_usage_threshold", float, 0.95,
      "Node memory fraction above which the OOM killer sheds workers")
_flag("memory_monitor_refresh_ms", int, 0, "Memory monitor period; 0 disables")
_flag("gcs_storage", str, "memory", "GCS table storage backend: memory | file")
_flag("gcs_storage_path", str, "", "Persistence path for the file storage backend")
_flag("gcs_persist_interval_s", float, 0.5,
      "Period of the GCS table snapshot loop (file storage backend). Each "
      "snapshot is fsync'd then atomically replaced, so a GCS killed at "
      "ANY instant restarts from a complete snapshot, never a torn one")
_flag("gcs_reconnect_timeout_s", float, 30.0,
      "How long a ReconnectingClient keeps re-dialing (bounded exponential "
      "backoff, re-resolving the address each attempt) before a call fails "
      "with ConnectionLost. Covers a GCS kill->restart window: clients that "
      "noticed the death mid-outage must not cache the dead connection")
_flag("chaos_recovery_deadline_s", float, 120.0,
      "Recovery-transition watchdog horizon: a state-machine transition "
      "(serve replica STARTING, train gang restart) stuck longer than this "
      "fails loudly with the stuck state attributed instead of hanging; "
      "0 disables enforcement")
_flag("data_inflight_budget_bytes", int, 0,
      "Streaming data plane: global in-flight byte budget shared by every "
      "operator of a pipeline execution (replaces per-op block-count "
      "caps). 0 = negotiate against the local object store at execution "
      "start (25% of store capacity, floor 64 MiB) so a shuffle whose "
      "working set exceeds memory degrades into windows that spill "
      "through the store's disk tier instead of OOMing")
_flag("data_prefetch_shards", int, 2,
      "Blocks a train-ingest shard iterator keeps pulled ahead of the "
      "consuming step (per-host double buffering over the transfer "
      "plane); 0 disables prefetch (every batch pays its pull latency "
      "in step-stall time)")
_flag("data_tenant_budget_bytes", int, 0,
      "Per-tenant cap on data-plane in-flight bytes, summed across every "
      "ByteBudget the tenant's executions hold (tenant = "
      "DataContext.tenant, else the submitting job id, else 'default'). "
      "Admission past the cap is refused with backpressure — the "
      "execution drains and retries instead of silently starving a "
      "sibling tenant's working set out of the store. A tenant with "
      "nothing in flight is always admitted (progress guarantee, same "
      "shape as the per-op one). 0 disables tenant capping")
_flag("data_locality_routing", _parse_bool, True,
      "Locality-routed data-plane consumption: shuffle-reduce tasks are "
      "NodeAffinity(soft)-placed on the node holding the most bucket "
      "bytes, and split-coordinator shard pulls prefer blocks already "
      "resident on the consumer's node (lookahead reorder within the "
      "coordinator's window). Off: reduces schedule wherever the "
      "default policy lands and shards hand out blocks strictly FIFO")
_flag("query_sort_sample_rows", int, 1024,
      "Distributed sort: total key samples pulled to the driver to pick "
      "range-partition boundaries. This bounds DRIVER-resident bytes for "
      "a sort of any size — the rows themselves only ever move through "
      "the windowed shuffle. More samples = tighter partition balance "
      "on skewed keys")
_flag("query_broadcast_join_bytes", int, 4 * 1024 * 1024,
      "Join strategy cutover: a build (right) side at or below this many "
      "bytes is broadcast — shipped once per node over the transfer "
      "plane's partial-location tree and joined against each probe "
      "block in place — instead of hash-shuffling both sides. 0 forces "
      "the hash-shuffle path always")
_flag("lineage_max_bytes", int, 64 * 1024 * 1024, "Max lineage bytes retained for reconstruction")
_flag("max_object_reconstructions", int, 3, "Owner-side re-executions of a creating task after object loss")
_flag("max_reconstruction_depth", int, 16, "Max recursive dependency depth for lineage reconstruction")
_flag("object_transfer_chunk_bytes", int, 16 * 1024 * 1024,
      "Node-to-node object transfer chunk size: a pulled object moves as "
      "ceil(size/chunk) independent chunk RPCs into a pre-created store "
      "buffer, so a 1 GiB object never materializes as one RPC frame")
_flag("object_transfer_window", int, 4,
      "Chunk requests kept in flight per pull (pipelined across the "
      "advertised locations). 1 restores stop-and-wait; >1 hides per-chunk "
      "RTT and stripes chunks across every node holding a copy")
_flag("object_transfer_max_peers", int, 8,
      "Cap on simultaneous source nodes a single pull stripes across")
_flag("object_transfer_sender_concurrency", int, 4,
      "Distinct simultaneous pullers a raylet serves chunks to before "
      "answering 'busy' with redirect hints (nodes that already completed "
      "pulls of the object), so N-way broadcasts form a tree instead of "
      "convoying on the seed node's NIC; 0 disables the fairness gate")
_flag("object_transfer_refetch_location_chunks", int, 8,
      "Re-query the object directory for new locations every N completed "
      "chunks during a pull (late-joining sources get picked up mid-pull)")
_flag("object_transfer_same_host_attach", _parse_bool, True,
      "Same-host fast path for pulls: when a holder raylet shares this "
      "host, attach its SEALED shm segment by name and memcpy directly "
      "into the local store — zero socket copies, no chunk RPCs. Safe "
      "by construction: the final segment name only exists after the "
      "atomic-rename seal, so an attach can never observe torn bytes "
      "(FileNotFoundError = not same host or not sealed yet, and the "
      "pull falls back to the chunked transfer plane). Benches that "
      "model link bandwidth disable it per-arm so topology numbers "
      "stay honest")
_flag("collective_stall_timeout_s", float, 60.0,
      "Host-collective abort horizon: an op waiting on a peer contribution "
      "this long with no progress raises CollectiveError instead of "
      "hanging (member death is detected by the GCS and aborts sooner)")
_flag("collective_inline_max_bytes", int, 64 * 1024,
      "Collective payloads at or below this size ride the GCS mailbox "
      "inline instead of the object-transfer plane")
_flag("collective_p2p_ack_window", int, 8,
      "Point-to-point flow control: object-path sends to one peer kept "
      "in flight before the sender blocks on the receiver's drain ack "
      "and frees the oldest payload. Bounds store bytes a pipeline "
      "stage pair can pin at (window x activation size); inline "
      "payloads (<= collective_inline_max_bytes) never ack")
_flag("collective_ring_min_bytes", int, 256 * 1024,
      "Flat buffers below this total size allreduce via direct fan-in "
      "(latency-bound regime); at or above, the bandwidth-optimal ring "
      "reduce-scatter/all-gather runs over the transfer plane")
_flag("tracing_enabled", _parse_bool, False,
      "Distributed tracing plane: cross-process spans recorded into a "
      "per-process flight recorder and flushed to the GCS. Disabled path "
      "is a guard check only (no allocation per call site)")
_flag("trace_sample_rate", float, 1.0,
      "Head-based sampling: probability a new root span starts a "
      "recorded trace. Propagated with the trace context, so a whole "
      "request is in or out together")
_flag("trace_buffer_spans", int, 4096,
      "Per-process flight-recorder capacity in spans; the buffer drops "
      "oldest (counting drops) so tracing memory is bounded under span "
      "storms. Spans that recorded an error survive drop-oldest")
_flag("trace_gcs_max_spans", int, 50000,
      "GCS-side trace store capacity in spans (drop-oldest with a "
      "counter); bounds /api/timeline and /api/traces memory")
_flag("serve_fastpath_enabled", _parse_bool, True,
      "Serve fast data plane: proxies forward request/response bodies as "
      "raw-bytes frames straight to the replica's direct RPC server (no "
      "pickle round trip), coalescing concurrent requests to the same "
      "replica into one multiplexed frame. Off = classic light/heavy lanes")
_flag("serve_coalesce_max_requests", int, 64,
      "Max requests packed into one serve fast-lane frame; requests "
      "arriving in the same event-loop tick coalesce up to this count")
_flag("serve_coalesce_max_bytes", int, 1 << 20,
      "Max total body bytes per coalesced serve fast-lane frame; a "
      "request pushing the pending batch past this flushes it first")
_flag("serve_park_max_bytes", int, 8 << 20,
      "Scale-to-zero buffer cap: total request-body bytes a proxy may "
      "hold for a parked (0-replica) deployment while its replica "
      "cold-starts; beyond this new requests fail fast instead of queuing")
_flag("serve_park_timeout_s", float, 30.0,
      "Scale-to-zero wait horizon: how long a buffered request waits for "
      "a parked deployment's cold-started replica before failing")
_flag("prefix_cache_enabled", _parse_bool, True,
      "Inference engine radix prefix cache: finished sequences donate "
      "their full-block KV prefixes to a radix tree and new requests "
      "skip prefill for the longest cached match (continuous scheduling "
      "only; cached blocks are reclaimed LRU-by-leaf under arena "
      "pressure before any live sequence is preempted)")
_flag("spec_decode_draft_len", int, 0,
      "Speculative decoding draft length k: each decode round proposes "
      "k tokens with the draft model and verifies k+1 with the target "
      "in one fixed-shape program (greedy verify — output is identical "
      "to plain decoding regardless of draft quality). 0 disables")
_flag("slo_default_class", str, "interactive",
      "SLO class for requests that do not name one: 'interactive' "
      "(admission/prefill priority, preferred to survive preemption) or "
      "'batch' (bulk traffic, first preemption victim)")
_flag("slo_interactive_reserved_slots", int, 0,
      "Batch slots the continuous scheduler holds open for "
      "interactive-class admissions: batch-class requests are only "
      "admitted while more than this many slots stay free, so a bulk "
      "flood cannot occupy the whole batch ahead of an interactive "
      "arrival. 0 disables; capped at batch_slots - 1")
_flag("job_agent_enabled", _parse_bool, True,
      "Route submitted jobs through the per-node job agents (GCS job "
      "table + driver subprocess on a worker node, checkpointed across "
      "GCS restarts). False falls back to the legacy in-GCS JobManager "
      "(driver runs inside the GCS process, no persistence)")
_flag("job_log_tail_bytes", int, 256 * 1024,
      "Per-job cap on driver log bytes retained in the GCS log plane "
      "(oldest lines evicted first); get_job_logs serves this tail")
_flag("job_default_tenant_weight", float, 4.0,
      "Dispatch fair-share weight for jobs submitted without a tenant "
      "(and for interactive drivers) — the silver-tier default, so an "
      "untenanted job neither starves nor dominates tenanted ones")
_flag("job_prewarm_forge", _parse_bool, True,
      "Start a per-runtime-env forge template when a job with preimports "
      "is submitted, before its first task arrives — the submit-to-"
      "first-task path then forks from a warm template instead of "
      "paying template startup inline")
_flag("log_to_driver", bool, True, "Stream worker logs back to the driver")
_flag("include_dashboard", bool, True, "Start the HTTP dashboard on the head node")
_flag("dashboard_port", int, 0, "Dashboard HTTP port; 0 = random free port")
_flag("enable_client_server", bool, True, "Start the ray:// client proxy on the head node")


class RayTpuConfig:
    """Process-wide config instance; values resolved lazily from env.

    Reads are memoized: the task fast path consults several flags per
    submit, and resolving each from `os.environ` every time costs more
    than the dict hit that replaces it. Explicit assignment
    (`GLOBAL_CONFIG.flag = x`, the test idiom) lands in `_overrides`
    and always wins; env-derived values land in `_cache`, which
    `refresh()` drops so an env var set before `ray_tpu_torch.init()` takes
    effect in the same process (the bench's A-B-A off-path pattern)."""

    def __init__(self):
        object.__setattr__(self, "_overrides", {})
        object.__setattr__(self, "_cache", {})

    def __setattr__(self, name: str, value) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._overrides[name] = value

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        overrides = self._overrides
        if name in overrides:
            return overrides[name]
        cache = self._cache
        if name in cache:
            return cache[name]
        flag = _FLAG_TABLE.get(name)
        if flag is None:
            raise AttributeError(f"Unknown config flag: {name}")
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            value = _parse_bool(env) if flag.type is bool else flag.type(env)
        else:
            value = flag.default
        cache[name] = value
        return value

    def refresh(self):
        """Drop env-derived memoized values (explicit sets persist) —
        called at init() so env changes made since the last session are
        observed."""
        self._cache.clear()

    def initialize(self, system_config: Dict[str, Any] | None):
        """Apply a `_system_config` dict (propagated cluster-wide via env)."""
        if not system_config:
            return
        for k, v in system_config.items():
            if k not in _FLAG_TABLE:
                raise ValueError(f"Unknown system config key: {k}")
            flag = _FLAG_TABLE[k]
            # Keys were validated against _FLAG_TABLE above: the key
            # space is the fixed flag set, it cannot grow. (RL011 cannot
            # even see _overrides — it is born via object.__setattr__ —
            # so no suppression is needed; the unused-suppression audit
            # retired the one that used to sit here.)
            self._overrides[k] = _parse_bool(v) if flag.type is bool else flag.type(v)

    def to_env(self) -> Dict[str, str]:
        """Serialize overrides as env vars for child processes."""
        out = {}
        for k, v in self._overrides.items():
            out[_ENV_PREFIX + k.upper()] = json.dumps(v) if not isinstance(v, str) else v
        return out

    def dump(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in _FLAG_TABLE}


GLOBAL_CONFIG = RayTpuConfig()
