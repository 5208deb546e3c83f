"""Single-process multi-node simulation for tests.

Equivalent of the reference's `python/ray/cluster_utils.py` (`Cluster`,
`add_node` :165): starts a real GCS plus multiple raylets (each with its own
shared-memory store namespace and worker pool) in one machine, so scheduling,
spillback, object transfer and failover paths run for real without a cluster.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.gcs import GcsServer
from ray_tpu_torch.core.node import default_session_dir
from ray_tpu_torch.core.raylet import Raylet


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None,
                 gcs_storage_path: Optional[str] = None):
        self._gcs_storage_path = gcs_storage_path
        self.gcs = GcsServer(storage_path=gcs_storage_path)
        self.gcs.start()
        self.session_dir = default_session_dir()
        self.raylets: List[Raylet] = []
        self._connected = False
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def address(self) -> str:
        return self.gcs.address

    @property
    def gcs_address(self) -> str:
        return self.gcs.address

    def add_node(self, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: int = 0,
                 labels: Optional[Dict[str, str]] = None) -> Raylet:
        from ray_tpu_torch.core.common import CPU, GPU

        total: Dict[str, float] = {CPU: float(num_cpus)}
        if num_gpus:
            total[GPU] = float(num_gpus)
        if resources:
            total.update({k: float(v) for k, v in resources.items()})
        is_head = len(self.raylets) == 0
        raylet = Raylet(
            gcs_address=self.gcs.address,
            resources=total,
            session_dir=self.session_dir,
            is_head=is_head,
            labels=labels,
            object_store_memory=object_store_memory,
        )
        raylet.start()
        self.raylets.append(raylet)
        return raylet

    def remove_node(self, raylet: Raylet, allow_graceful: bool = True):
        raylet.stop()
        try:
            self.gcs.handle_drain_node(None, {"node_id": raylet.node_id})
        except Exception:
            pass
        self.raylets = [r for r in self.raylets if r is not raylet]

    def crash_node(self, raylet: Raylet):
        """Kill a node WITHOUT telling the GCS (fault injection): the
        raylet stops serving but no drain is issued, so the GCS discovers
        the death through missed health checks exactly as it would for a
        crashed host — the detection + cleanup path chaos must exercise
        (remove_node's drain skips it)."""
        raylet.stop()
        self.raylets = [r for r in self.raylets if r is not raylet]

    def kill_gcs(self):
        """Stop the GCS process (fault injection). Raylets and drivers keep
        running and reconnect when `restart_gcs` brings it back."""
        self.gcs.stop()

    def wait_gcs_noticed_down(self, timeout: float = 10.0) -> bool:
        """Block until the driver's GCS client has OBSERVED the death of
        the killed GCS (its reader drained with ConnectionLost). Tests
        that simulate an outage window wait on this event instead of a
        fixed sleep — the race they exercise (reconnect dialing a dead
        address) only exists once the loss is seen."""
        import ray_tpu_torch

        runtime = ray_tpu_torch._global_runtime
        if runtime is not None and hasattr(runtime.gcs, "wait_disconnected"):
            return runtime.gcs.wait_disconnected(timeout)
        # No connected driver: the GCS server is stopped synchronously.
        return True

    def restart_gcs(self):
        """Bring the GCS back at the SAME address, restoring tables from the
        persistence path (requires `gcs_storage_path`)."""
        if not self._gcs_storage_path:
            raise ValueError("restart_gcs requires gcs_storage_path")
        host, port = self.gcs.address.rsplit(":", 1)
        self.gcs = GcsServer(host=host, port=int(port),
                             storage_path=self._gcs_storage_path)
        self.gcs.start()

    def wait_for_nodes(self, timeout: float = 10.0):
        deadline = time.monotonic() + timeout
        want = len(self.raylets)
        while time.monotonic() < deadline:
            alive = sum(1 for n in self.gcs.handle_get_nodes(None) if n["Alive"])
            if alive >= want:
                return
            time.sleep(0.05)
        raise TimeoutError(f"only {alive}/{want} nodes alive")

    def connect(self, namespace: str = "default"):
        import ray_tpu_torch

        info = ray_tpu_torch.init(address=self.gcs.address, namespace=namespace)
        self._connected = True
        return info

    def shutdown(self):
        import ray_tpu_torch

        if self._connected:
            ray_tpu_torch.shutdown()
            self._connected = False
        for r in self.raylets:
            try:
                r.stop()
            except Exception:
                pass
        self.raylets = []
        self.gcs.stop()


class NodeKiller:
    """Chaos fault injector: kill a random non-head node every `period_s`,
    optionally replacing it so capacity recovers (reference
    `python/ray/_private/test_utils.py` NodeKillerActor).

    Use as a context manager around a workload that must survive node
    churn (task retries + actor restarts + lineage reconstruction).
    """

    def __init__(self, cluster: Cluster, period_s: float = 2.0,
                 replace: bool = True, max_kills: int = 1000,
                 node_args: Optional[Dict] = None):
        self.cluster = cluster
        self.period_s = period_s
        self.replace = replace
        self.max_kills = max_kills
        self.node_args = node_args or {}
        self.kills = 0
        self._stop = None
        self._thread = None

    def _loop(self):
        import random

        while not self._stop.wait(self.period_s):
            victims = [r for r in self.cluster.raylets if not r.is_head]
            if not victims or self.kills >= self.max_kills:
                continue
            victim = random.choice(victims)
            self.cluster.remove_node(victim)
            self.kills += 1
            if self.replace:
                self.cluster.add_node(**self.node_args)

    def __enter__(self):
        import threading as _t

        self._stop = _t.Event()
        self._thread = _t.Thread(target=self._loop, name="node-killer",
                                 daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        return False
