"""Training backends: the process-group seam.

The port's copy of `ray_tpu/train/backend.py` (the reference's
`Backend.on_start`, `python/ray/train/backend.py:53`, whose Torch
implementation runs `dist.init_process_group`, `torch/config.py:69-113`).
`TorchBackend` forms one torch.distributed group over the worker group:
NCCL when the workers hold the card, gloo on the CPU. A world of one forms
no group, as in the JAX package, unless the run has a mesh: a DeviceMesh
needs a group, so one of one rank is formed. The mesh itself is built in
each worker (`mesh_builder`), where the JAX package's JaxBackend builds
its `jax.sharding.Mesh`. There is no JaxBackend.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.parallel.distributed import get_address_and_port
from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

logger = logging.getLogger(__name__)


@dataclass
class BackendConfig:
    backend_name: str = "none"

    def backend_cls(self):
        return Backend


class Backend:
    """No-op backend: workers run independently (single-worker, or loops
    that need no group)."""

    def on_start(self, worker_group, backend_config: "BackendConfig"):
        pass

    def on_training_start(self, worker_group, backend_config: "BackendConfig"):
        pass

    def on_shutdown(self, worker_group, backend_config: "BackendConfig"):
        pass


@dataclass
class TorchConfig(BackendConfig):
    """torch.distributed process group over the worker group.

    backend: "nccl" or "gloo"; None picks NCCL when the workers hold the
    card and gloo on the CPU (the trainer decides from its device).
    mesh: logical mesh laid over the group's ranks, built in each worker.
    """

    backend_name: str = "torch"
    backend: Optional[str] = None
    init_timeout_s: int = 120
    mesh: Optional[MeshSpec] = None

    def backend_cls(self):
        return TorchBackend


def _mesh_builder_for(spec: Optional[MeshSpec]):
    """build(device_type) -> the DeviceMesh, run in each worker once the
    group is formed; None without a mesh."""
    if spec is None:
        return None
    return functools.partial(build_mesh, spec)


def _setup_torch_process_group(backend: str, addr: str, port: int,
                               rank: int, world: int, timeout_s: int):
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _teardown_torch_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: "TorchConfig"):
        import ray_tpu_torch

        world = len(worker_group)
        if world <= 1 and backend_config.mesh is None:
            return
        backend = backend_config.backend or "gloo"
        host, port = worker_group.execute_single(0, get_address_and_port)
        logger.info("forming torch %s process group: %d procs via %s:%d",
                    backend, world, host, port)
        # Every rank joins at once: rank 0 hosts the rendezvous store.
        refs = [w.execute.remote(_setup_torch_process_group, backend, host,
                                 port, rank, world,
                                 backend_config.init_timeout_s)
                for rank, w in enumerate(worker_group.workers)]
        ray_tpu_torch.get(refs)

    def mesh_builder(self, backend_config: "TorchConfig"):
        return _mesh_builder_for(backend_config.mesh)

    def on_shutdown(self, worker_group, backend_config: "TorchConfig"):
        try:
            worker_group.execute(_teardown_torch_process_group)
        except Exception:  # noqa: BLE001 — workers may already be gone
            pass
