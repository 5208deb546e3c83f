"""Node bring-up: session directory, embedded GCS (head), raylet.

Equivalent of `python/ray/_private/node.py` (`Node.start_ray_processes`) —
but the GCS and raylet run as threads of the head process instead of separate
native processes (workers are real subprocesses). `cluster_utils.Cluster`
adds more raylets (in-process or subprocess) for multi-node simulation.
"""

from __future__ import annotations

import logging
import os
import tempfile
import subprocess
import time
from typing import Dict, Optional

from ray_tpu_torch.core.common import CPU, GPU
from ray_tpu_torch.core.gcs import GcsServer
from ray_tpu_torch.core.raylet import Raylet

logger = logging.getLogger(__name__)


def default_session_dir() -> str:
    base = os.environ.get("RAY_TPU_TORCH_TMPDIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch")
    path = os.path.join(base, f"session_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}")
    os.makedirs(os.path.join(path, "logs"), exist_ok=True)
    return path


def detect_gpus(dev_dir: str = "/dev", nvidia_smi: str = "nvidia-smi") -> int:
    """Local GPU count without importing torch or initialising CUDA (the
    counterpart of the JAX package's `detect_tpu_chips`).

    `RAY_TPU_TORCH_NUM_GPUS` overrides it; else a set CUDA_VISIBLE_DEVICES
    gives the cards this process may use ("" none); else the driver's own
    list of cards (`nvidia-smi -L`, which reads NVML in its own process);
    else, where nvidia-smi is absent, the card nodes `/dev/nvidia0`,
    `/dev/nvidia1`, ... A container may hold nodes of cards it cannot use
    (the H100 machine shows nvidia0 and nvidia6 for its one card), which
    is why the driver's list comes first."""
    env = os.environ.get("RAY_TPU_TORCH_NUM_GPUS")
    if env:
        return int(env)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    try:
        out = subprocess.run([nvidia_smi, "-L"], capture_output=True,
                             text=True, timeout=30)
        if out.returncode == 0:
            return sum(1 for line in out.stdout.splitlines()
                       if line.startswith("GPU "))
    except (OSError, subprocess.SubprocessError):
        pass  # no driver tool here: count the card nodes
    try:
        import glob

        return len(glob.glob(os.path.join(dev_dir, "nvidia[0-9]*")))
    except OSError:
        return 0


class Node:
    def __init__(
        self,
        head: bool = True,
        gcs_address: Optional[str] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: int = 0,
        session_dir: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
        gcs_host: str = "127.0.0.1",
        gcs_port: int = 0,
        host: str = "127.0.0.1",
    ):
        self.head = head
        self.session_dir = session_dir or default_session_dir()
        self.gcs: Optional[GcsServer] = None
        self.dashboard = None
        if head:
            self.gcs = GcsServer(host=gcs_host, port=gcs_port)
            self.gcs.start()
            self.gcs_address = self.gcs.address
            from ray_tpu_torch.core.config import GLOBAL_CONFIG

            if GLOBAL_CONFIG.include_dashboard:
                try:
                    from ray_tpu_torch.dashboard import DashboardServer

                    self.dashboard = DashboardServer(
                        self.gcs_address,
                        port=GLOBAL_CONFIG.dashboard_port).start()
                except Exception:
                    import logging

                    logging.getLogger(__name__).warning(
                        "dashboard failed to start", exc_info=True)
        else:
            assert gcs_address, "non-head node requires gcs_address"
            self.gcs_address = gcs_address
        total: Dict[str, float] = {}
        total[CPU] = float(num_cpus) if num_cpus is not None else float(os.cpu_count() or 1)
        gpus = float(num_gpus) if num_gpus is not None else float(detect_gpus())
        if gpus:
            total[GPU] = gpus
        if resources:
            total.update({k: float(v) for k, v in resources.items()})
        # Per-node affinity resource (reference: `node:<ip>` custom
        # resource); uses the advertised host so it stays unique across
        # machines.
        total[f"node:{host}"] = 1.0
        self.raylet = Raylet(
            gcs_address=self.gcs_address,
            resources=total,
            session_dir=self.session_dir,
            host=host,
            is_head=head,
            labels=labels,
            object_store_memory=object_store_memory,
        )
        self.raylet.start()
        self.client_server = None
        if head:
            from ray_tpu_torch.core.config import GLOBAL_CONFIG

            if GLOBAL_CONFIG.enable_client_server:
                try:
                    from ray_tpu_torch.client import ClientServer

                    self.client_server = ClientServer(
                        self.gcs_address, self.raylet_address,
                        self.session_suffix, self.node_id).start()
                except Exception:
                    import logging

                    logging.getLogger(__name__).warning(
                        "client server failed to start", exc_info=True)

    @property
    def raylet_address(self) -> str:
        return self.raylet.server.address

    @property
    def session_suffix(self) -> str:
        return self.raylet.session_suffix

    @property
    def node_id(self):
        return self.raylet.node_id

    @property
    def worker_forge(self):
        """This node's forkserver template handle (None when
        `worker_forge_enabled` is off) — see docs/WORKER_POOL.md."""
        return self.raylet.forge

    def shutdown(self):
        # Teardown order matters for process hygiene: raylet.stop() kills
        # the pool's workers first, then detaches from the worker forge —
        # no worker survives the node (asserted by the /proc-scan orphan
        # tests). The forge template itself is process-shared and lingers
        # for the next cluster, self-exiting on idle or parent death.
        if self.client_server is not None:
            try:
                self.client_server.stop()
            except Exception:  # noqa: BLE001 — stop() must keep going
                logger.warning("node stop: client server shutdown failed",
                               exc_info=True)
        self.raylet.stop()
        if self.dashboard is not None:
            try:
                self.dashboard.stop()
            except Exception:  # noqa: BLE001 — stop() must keep going
                logger.warning("node stop: dashboard shutdown failed",
                               exc_info=True)
        if self.gcs is not None:
            self.gcs.stop()
