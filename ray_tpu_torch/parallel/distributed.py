"""torch.distributed process-group formation.

The port's copy of `ray_tpu/parallel/distributed.py`. The JAX package joins
`jax.distributed` here; the port joins one `torch.distributed` group (the
reference's `init_process_group`, `python/ray/train/torch/config.py:69,113`):
NCCL when the ranks compute on the card, gloo on the CPU.

Protocol (as `train.TorchBackend` drives it over a worker group):
  1. rank 0 picks a free port -> coordinator address
  2. every worker calls `initialize_distributed(addr, world, rank, device)`
  3. each worker builds the same DeviceMesh over the group's ranks
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)


@dataclass
class DistributedContext:
    coordinator_address: str
    num_processes: int
    process_id: int
    initialized: bool = False
    backend: Optional[str] = None    # the group's, when this call formed one

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


_ctx: Optional[DistributedContext] = None


def get_address_and_port() -> tuple:
    """The address this worker's node advertises (its raylet's host, or
    localhost outside the runtime) and a free TCP port, for rank 0 to host
    the group's rendezvous."""
    raylet = os.environ.get("RAY_TPU_TORCH_RAYLET_ADDRESS", "127.0.0.1:0")
    host = raylet.rsplit(":", 1)[0]
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return host, port


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: int = 1,
    process_id: int = 0,
    device=None,
    timeout_s: float = 120.0,
) -> DistributedContext:
    """Join the torch.distributed group of `num_processes` ranks whose
    rendezvous rank 0 hosts at `coordinator_address` ("host:port").

    The backend follows `device` ("cuda", the default, or "cpu"): NCCL on
    the card, gloo on the CPU, never chosen by what is available; "cuda"
    raises without CUDA. A single process with no coordinator address only
    records the context, as in the JAX package; given an address it forms
    a group of one, which a DeviceMesh needs."""
    global _ctx
    if _ctx is not None and _ctx.initialized:
        if (_ctx.coordinator_address == (coordinator_address or "local")
                and _ctx.process_id == process_id):
            return _ctx
        raise RuntimeError("torch.distributed already initialized differently")
    ctx = DistributedContext(coordinator_address or "local",
                             num_processes, process_id)
    if num_processes > 1 or coordinator_address is not None:
        if coordinator_address is None:
            raise ValueError(f"{num_processes} processes need a coordinator "
                             "address")
        import torch
        import torch.distributed as dist

        from ray_tpu_torch._torch_env import resolve_device

        dev = resolve_device(device)
        ctx.backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(
            ctx.backend, init_method=f"tcp://{coordinator_address}",
            rank=process_id, world_size=num_processes,
            timeout=datetime.timedelta(seconds=timeout_s))
        logger.info("torch.distributed (%s) initialized: rank %d/%d via %s",
                    ctx.backend, process_id, num_processes,
                    coordinator_address)
    ctx.initialized = True
    _ctx = ctx
    return ctx


def shutdown_distributed():
    """Leave the group this module formed, if it formed one."""
    global _ctx
    if _ctx is not None and _ctx.backend is not None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _ctx = None


def distributed_context() -> Optional[DistributedContext]:
    return _ctx


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0
