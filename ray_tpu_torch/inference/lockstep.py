"""Step records for tensor-parallel serving: one rank schedules, the others
follow.

The JAX package serves a tp mesh from one process: GSPMD partitions each
jitted step program over the devices, so every device runs every step and
the scheduler never learns that a mesh exists. In the port one process
holds one card, so every tp rank runs an `InferenceEngine` of its own on
its shards, and all of them must run the same program on the same
arguments at every step. The rank at tp coordinate 0 schedules: before
each program call it broadcasts the step's record, and every other rank's
`InferenceEngine.follow()` receives it and runs the same program.

A record is a dict of host objects:

- ``program``, ``args``: the program's name and its host argument arrays,
  as the engine's `_upload` takes them;
- ``adapters``: the adapter-bank residency changes since the last record
  (`AdapterManager.take_changes`);
- ``reset``: the arenas were rebuilt (`fail_all`);
- ``stop``: the follower returns.

Records travel pickled over a gloo group on the CPU made beside the mesh's
tp group (one per tp line), by broadcast: never through NCCL, and never as
a CUDA tensor or by point-to-point (gloo's send/recv of a CUDA tensor
kills the peer). The record group keeps the tp group's timeout, so a
follower whose leader is gone or broken fails its wait within it; an idle
leader sends an empty record every `heartbeat_s` (a quarter of that
timeout, `InferenceEngine.heartbeat`) to keep the wait inside it. A step
that fails on the leader leaves the ranks out of step for good: the
channel is then `broken`, later sends raise at once and nothing more is
sent, so the leader's requests fail at once and its followers' waits run
out; the rank that serves them is restarted with its peers.
"""

from __future__ import annotations

import datetime
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.parallel.mesh import axis_rank, axis_size


def tp_lines(mesh) -> List[List[int]]:
    """The global ranks of each tp line of `mesh`, in tp order."""
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    tp = names.index("tp")
    return ranks.movedim(tp, -1).reshape(-1, ranks.shape[tp]).tolist()


def group_timeout(group) -> datetime.timedelta:
    """The collective timeout of process group `group` (gloo serves its CPU
    tensors; an NCCL group has only a CUDA backend)."""
    import torch

    try:
        backend = group._get_backend(torch.device("cpu"))
    except RuntimeError:
        backend = group._get_backend(torch.device("cuda"))
    return backend.options._timeout


class Lockstep:
    """The record channel of this rank's tp line on `mesh`. Collective to
    make: every rank of the process group makes it, with the same mesh."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.tp = axis_size(mesh, "tp")
        self.is_leader = axis_rank(mesh, "tp") == 0
        self.timeout = group_timeout(mesh.get_group("tp"))
        self.heartbeat_s = self.timeout.total_seconds() / 4
        me = dist.get_rank()
        for line in tp_lines(mesh):
            group = dist.new_group(line, backend="gloo", timeout=self.timeout)
            if me in line:
                self.group, self.src = group, line[0]
        self.sent = 0
        self.last_sent = time.monotonic()
        self.stopped = False
        self.broken: Optional[str] = None

    def fail(self, error: BaseException) -> None:
        """Mark the channel broken by `error` (the first one is kept)."""
        if self.broken is None:
            self.broken = f"{type(error).__name__}: {error}"

    def send(self, record: Dict[str, Any]) -> None:
        import torch.distributed as dist

        if self.broken is not None:
            raise RuntimeError(f"the tp ranks are out of step since "
                               f"{self.broken}")
        try:
            dist.broadcast_object_list([record], src=self.src,
                                       group=self.group)
        except BaseException as e:
            self.fail(e)
            raise
        self.sent += 1
        self.last_sent = time.monotonic()

    def recv(self) -> Dict[str, Any]:
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]
