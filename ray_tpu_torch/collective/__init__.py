"""ray_tpu_torch.collective: host-RAM collectives over the transfer plane.

The port's copy of `ray_tpu/collective/`. Public surface mirrors the
reference's `ray.util.collective` (init_collective_group / allreduce /
allgather / broadcast / reducescatter / barrier /
destroy_collective_group), backed by the GCS-registered group control
plane (`core/gcs.py`, `handle_collective_*`) and the pipelined
object-transfer data plane. The JAX package's docs/COLLECTIVE.md describes
the algorithms, chunking, failure semantics and flags, which are the same
here. Values are pytrees of numpy arrays or torch tensors; a tensor on the
card leaves it and comes back to it through host memory (`buffer.py`).
Training loops on the cards sync over torch.distributed (NCCL); this plane
is for what moves between processes outside it.
`ray_tpu_torch.util.collective` is a thin compatibility shim over this
package.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.collective.buffer import (  # noqa: F401
    PackedTree,
    tree_flatten,
    tree_index,
    tree_unflatten,
)
from ray_tpu_torch.collective.group import (  # noqa: F401
    CollectiveGroup,
    RayletTransport,
    RuntimeTransport,
)
from ray_tpu_torch.exceptions import CollectiveError  # noqa: F401

_groups: Dict[str, CollectiveGroup] = {}
_lock = threading.Lock()


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default",
                          transport=None,
                          stall_timeout_s: Optional[float] = None
                          ) -> CollectiveGroup:
    """Create-or-attach this process as `rank` of a named group.

    The first caller creates the GCS group record; every later attach
    must present the same world_size (ValueError otherwise — a stale
    record can never silently skew an op). Raises CollectiveError when
    attaching to a group broken by a member death.
    """
    group = CollectiveGroup(group_name, world_size, rank,
                            transport=transport,
                            stall_timeout_s=stall_timeout_s)
    with _lock:
        _groups[group_name] = group
    return group


def get_group(group_name: str = "default") -> CollectiveGroup:
    with _lock:
        group = _groups.get(group_name)
    if group is None:
        raise ValueError(f"collective group '{group_name}' not initialized "
                         "in this process")
    return group


def allreduce(value: Any, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(value, op)


def allgather(value: Any, group_name: str = "default") -> List[Any]:
    return get_group(group_name).allgather(value)


def broadcast(value: Any, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(value, src_rank)


def reducescatter(value: Any, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).reducescatter(value, op)


def barrier(group_name: str = "default") -> None:
    get_group(group_name).barrier()


def send(value: Any, dst: int, group_name: str = "default",
         tag: str = "p2p") -> None:
    """Point-to-point post to `dst` (ordered per (src, dst, tag)
    channel; outside the bulk-synchronous collective op sequence)."""
    get_group(group_name).send(value, dst, tag=tag)


def recv(src: int, group_name: str = "default", tag: str = "p2p"):
    """Blocking take of the next message `src` sent on `tag`."""
    return get_group(group_name).recv(src, tag=tag)


def destroy_collective_group(group_name: str = "default") -> None:
    with _lock:
        group = _groups.pop(group_name, None)
    if group is not None:
        group.destroy()
