"""Pluggable fault injectors driven by a ChaosSchedule.

Each injector owns one fault class: it maps a `ChaosEvent`'s
deterministic `draw` onto the victim set that exists at fire time,
injects the fault through a CRASH-shaped path (SIGKILL, no drain — the
detection machinery must earn its keep), and answers `recovered()` so the
runner can measure a bounded per-fault MTTR. Injectors are in-process
companions of `cluster_utils.Cluster`; the worker/forge kills route
through the raylet's chaos RPC handlers so the same injectors work
against out-of-process raylets.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.chaos.schedule import ChaosEvent
from ray_tpu_torch.core import rpc as _rpc

logger = logging.getLogger(__name__)


class Injector:
    """One fault class. Subclasses implement inject()/recovered()."""

    kind = "abstract"

    def inject(self, event: ChaosEvent) -> Dict[str, Any]:
        """Fire the fault; returns attribution detail for the record.
        A {'skipped': reason} return means no fault could be injected
        (e.g. no victims) and the runner records it as a no-op."""
        raise NotImplementedError

    def recovered(self) -> bool:
        """Probe recovery of the LAST injected fault. Must be cheap and
        non-blocking-ish (the runner polls it under the recovery
        deadline)."""
        return True


class NodeKillInjector(Injector):
    """Crash a non-head node (no drain — the GCS health checker must
    discover it), optionally replacing it so capacity recovers.
    Recovered when the GCS has marked the victim DEAD and the alive node
    count is back to its pre-kill level.

    Replacement modes: `replace=True` adds a node inline (the bench's
    immediate `add_node`); `provider=` hands replacement to the cluster's
    AUTOSCALER instead — victims are drawn from the provider's managed
    fleet, nothing is added here, and recovery waits for the autoscaler's
    dead-node reap + relaunch to bring the alive count back (the
    production path: a crashed host is replaced by the control loop, not
    by the test harness)."""

    kind = "node_kill"

    def __init__(self, cluster, replace: bool = True,
                 node_args: Optional[Dict] = None, provider=None):
        self.cluster = cluster
        self.replace = replace and provider is None
        self.provider = provider
        self.node_args = node_args or {}
        self._victim_hex: Optional[str] = None
        self._want_alive = 0

    def inject(self, event: ChaosEvent) -> Dict[str, Any]:
        if self.provider is not None:
            victims = [r for r in self.provider.non_terminated_nodes()
                       if r in self.cluster.raylets and not r.is_head]
        else:
            victims = [r for r in self.cluster.raylets if not r.is_head]
        if not victims:
            return {"skipped": "no killable nodes"}
        victims.sort(key=lambda r: r.node_id.hex())
        victim = victims[event.draw % len(victims)]
        self._victim_hex = victim.node_id.hex()
        replaced = self.replace or self.provider is not None
        self._want_alive = len(self.cluster.raylets) \
            if replaced else len(self.cluster.raylets) - 1
        self.cluster.crash_node(victim)
        if self.replace:
            self.cluster.add_node(**self.node_args)
        return {"node": self._victim_hex[:12], "replaced": replaced,
                "via": "autoscaler" if self.provider is not None
                       else ("inline" if self.replace else "none")}

    def recovered(self) -> bool:
        try:
            nodes = self.cluster.gcs.handle_get_nodes(None)
        except Exception:  # noqa: BLE001 — GCS mid-churn: not recovered yet
            return False
        victim_dead = all(not n["Alive"] or n["NodeID"] != self._victim_hex
                          for n in nodes)
        alive = sum(1 for n in nodes if n["Alive"])
        return victim_dead and alive >= self._want_alive


class GcsRestartInjector(Injector):
    """Kill the GCS, hold it down for a deterministic outage window, then
    restart it at the same address from the persisted tables. Recovered
    when the DRIVER's reconnecting client completes a round trip against
    the restarted GCS (not merely when the server binds)."""

    kind = "gcs_restart"

    def __init__(self, cluster, outage_range_s: Tuple[float, float] = (0.2, 1.0)):
        self.cluster = cluster
        self.outage_range_s = outage_range_s

    def inject(self, event: ChaosEvent) -> Dict[str, Any]:
        if not self.cluster._gcs_storage_path:
            return {"skipped": "cluster has no gcs_storage_path"}
        lo, hi = self.outage_range_s
        outage = lo + event.param * (hi - lo)
        self.cluster.kill_gcs()
        self.cluster.wait_gcs_noticed_down(timeout=10.0)
        time.sleep(outage)
        self.cluster.restart_gcs()
        return {"outage_s": round(outage, 3)}

    def recovered(self) -> bool:
        import ray_tpu_torch

        runtime = ray_tpu_torch._global_runtime
        if runtime is None:
            # No driver attached: server-side liveness is all there is.
            try:
                self.cluster.gcs.handle_get_nodes(None)
                return True
            except Exception:  # noqa: BLE001 — still restarting
                return False
        try:
            runtime.gcs.call("kv_get", {"key": b"chaos:probe"}, timeout=2.0)
            return True
        except Exception:  # noqa: BLE001 — reconnect still in flight
            return False


class WorkerKillInjector(Injector):
    """SIGKILL one worker process on a drawn node via the raylet's chaos
    RPC — a real crash, detected by the exit-event machinery. If the
    victim hosted an actor, recovered once the GCS has driven that actor
    out of RESTARTING (ALIVE again in another worker, or terminally DEAD
    when restarts are exhausted — both are bounded outcomes). The actor
    still ALIVE in the killed worker is not recovered: the GCS has not
    seen the death yet (the JAX package's injector counts it, so its MTTR
    can read ~0). Plain task workers recover by pool replacement,
    observed as the raylet staying responsive."""

    kind = "worker_kill"

    def __init__(self, cluster, actors_only: bool = False):
        self.cluster = cluster
        self.actors_only = actors_only
        self._actor_hex: Optional[str] = None
        self._worker_hex: Optional[str] = None

    def inject(self, event: ChaosEvent) -> Dict[str, Any]:
        if not self.cluster.raylets:
            return {"skipped": "no nodes"}
        raylets = sorted(self.cluster.raylets, key=lambda r: r.node_id.hex())
        # Start at the drawn node, fall through to the others: a draw
        # landing on a node with an empty worker pool must still inject
        # a fault somewhere (determinism is preserved — the scan order
        # is a pure function of the draw and the sorted node set).
        start = event.draw % len(raylets)
        resp = {"killed": False}
        raylet = None
        for k in range(len(raylets)):
            raylet = raylets[(start + k) % len(raylets)]
            resp = raylet.handle_chaos_kill_worker(
                None, {"draw": event.draw, "actors_only": self.actors_only})
            if resp.get("killed"):
                break
        self._actor_hex = None
        self._worker_hex = resp.get("worker_id")
        if resp.get("killed") and resp.get("actor"):
            # Remember which actor died so recovery can track ITS state.
            # Snapshot under the GCS lock: its own threads mutate the
            # actor table concurrently (a racing insert would raise
            # "dict changed size during iteration" and silently untrack
            # this fault).
            with self.cluster.gcs._lock:
                actor_infos = list(self.cluster.gcs.actors.values())
            for info in actor_infos:
                if info.worker_id is not None \
                        and info.worker_id.hex() == resp["worker_id"]:
                    self._actor_hex = info.actor_id.hex()
                    break
        if not resp.get("killed"):
            return {"skipped": resp.get("error", "no live workers")}
        return {"pid": resp["pid"], "actor": resp.get("actor", False)}

    def recovered(self) -> bool:
        if self._actor_hex is not None:
            with self.cluster.gcs._lock:
                actor_infos = list(self.cluster.gcs.actors.values())
            for info in actor_infos:
                if info.actor_id.hex() == self._actor_hex:
                    if info.state.value == "DEAD":
                        return True
                    return info.state.value == "ALIVE" \
                        and info.worker_id is not None \
                        and info.worker_id.hex() != self._worker_hex
            return True
        try:
            self.cluster.raylets[0].handle_debug_state(None)
            return True
        except Exception:  # noqa: BLE001
            return False


class ForgeKillInjector(Injector):
    """SIGKILL the worker-forge template on a drawn node. Recovered when
    the forge is serving again (template restarted) or has permanently
    given up (cold-exec fallback engaged) — both are bounded states; a
    forge wedged in neither is the bug this injector hunts."""

    kind = "forge_kill"

    def __init__(self, cluster):
        self.cluster = cluster
        self._raylet = None

    def inject(self, event: ChaosEvent) -> Dict[str, Any]:
        candidates = sorted(
            (r for r in self.cluster.raylets if r.forge is not None),
            key=lambda r: r.node_id.hex())
        if not candidates:
            return {"skipped": "no forge-enabled nodes"}
        self._raylet = candidates[event.draw % len(candidates)]
        resp = self._raylet.handle_chaos_kill_forge(None, {})
        if not resp.get("killed"):
            self._raylet = None
            return {"skipped": "forge template not running"}
        return {"pid": resp["pid"], "node": self._raylet.node_id.hex()[:12]}

    def recovered(self) -> bool:
        if self._raylet is None:
            return True
        forge = self._raylet.forge
        if forge is None:
            return True
        given_up = forge._consecutive_failures >= forge.MAX_CONSECUTIVE_FAILURES
        return forge.alive or given_up


class RpcFaultInjector(Injector):
    """Install the process-wide RPC fault filter for a bounded window:
    drop / delay / error a seeded fraction of matching calls — the
    partition and slow-link shapes a process kill cannot express. The
    filter is seeded from the event draw, so two runs with the same
    schedule fault the same *fraction* reproducibly (per-call coin flips
    ride thread scheduling and are reported as counts, not replayed).
    Recovered once the window has elapsed and the filter is removed."""

    kind = "rpc_faults"

    def __init__(self, fraction: float = 0.2, action: Any = "error",
                 window_s: float = 1.0,
                 match_methods: Optional[Tuple[str, ...]] = None,
                 match_clients: Optional[Tuple[str, ...]] = None):
        self.fraction = fraction
        self.action = action
        self.window_s = window_s
        self.match_methods = match_methods
        self.match_clients = match_clients
        self.faults_injected = 0
        self._until = 0.0
        self._lock = threading.Lock()

    def _make_filter(self, seed: int):
        rng = random.Random(seed)

        def chaos_filter(client_name: str, address: str, method: str):
            if self.match_methods is not None and not any(
                    method.startswith(m) for m in self.match_methods):
                return None
            if self.match_clients is not None and not any(
                    m in client_name for m in self.match_clients):
                return None
            with self._lock:
                if rng.random() >= self.fraction:
                    return None
                self.faults_injected += 1
            return self.action

        return chaos_filter

    def inject(self, event: ChaosEvent) -> Dict[str, Any]:
        _rpc.install_chaos_filter(self._make_filter(event.draw))
        self._until = time.monotonic() + self.window_s
        return {"action": str(self.action), "fraction": self.fraction,
                "window_s": self.window_s}

    def recovered(self) -> bool:
        if time.monotonic() < self._until:
            return False
        _rpc.clear_chaos_filter()
        return True

    def close(self):
        """Safety: never leave a filter installed past the run."""
        _rpc.clear_chaos_filter()
