"""Per-worker training session: report(), ranks, dataset shards, the
device, the torch.distributed group and the host collective plane.

The port's copy of `ray_tpu/train/session.py` (the reference's
`session.report`/`get_dataset_shard`, `python/ray/air/session.py:43,359`,
and `_TrainSession`, `python/ray/train/_internal/session.py:63`).
`get_device()` is the card (or CPU) the loop trains on, `get_mesh()` the
DeviceMesh the backend's mesh spec laid over the group's ranks (where the
JAX package's is a `jax.sharding.Mesh`), and `sync_gradients` and
`broadcast_params` run over the torch.distributed group that the backend
formed (NCCL on the card, gloo on the CPU) where the JAX package uses its
host collective plane. That plane is here too:
`get_collective()` is the run-wide `ray_tpu_torch.collective` group of
the training workers (host memory, over the object store), for what a
loop exchanges outside torch.distributed.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


class TrainContext:
    def __init__(self, world_rank: int, world_size: int, local_rank: int = 0,
                 local_world_size: int = 1, node_rank: int = 0,
                 trial_name: str = "", experiment_name: str = ""):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.local_world_size = local_world_size
        self.node_rank = node_rank
        self.trial_name = trial_name
        self.experiment_name = experiment_name


class _TrainSession:
    """Lives inside each training worker while the user loop runs."""

    def __init__(self, context: TrainContext, device=None,
                 datasets: Optional[Dict[str, Any]] = None,
                 checkpoint: Optional[Checkpoint] = None,
                 mesh=None, collective_factory=None):
        self.context = context
        self.device = device
        self.mesh = mesh
        self.datasets = datasets or {}
        self.loaded_checkpoint = checkpoint
        self.result_queue: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        self.final_return: Any = None
        # Host collective plane: joined on first use, so loops that never
        # ask for it never pay for it.
        self._collective_factory = collective_factory
        self._collective = None
        self._collective_lock = threading.Lock()

    def collective(self):
        """This worker's handle on the run-wide host collective group
        (ray_tpu_torch.collective), joined on first use. None when the
        session runs outside a WorkerGroup of more than one worker (no
        factory)."""
        with self._collective_lock:
            if self._collective is None and self._collective_factory is not None:
                self._collective = self._collective_factory()
            return self._collective

    def teardown_collective(self):
        with self._collective_lock:
            group, self._collective = self._collective, None
            self._collective_factory = None  # no join can land after this
        if group is not None:
            try:
                group.leave()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        self.result_queue.put({"metrics": dict(metrics),
                               "checkpoint": checkpoint})

    def get_dataset_shard(self, name: str = "train"):
        # ray_tpu_torch.data shards are pre-split by the trainer
        # (prefetching ShardIterators); plain iterables pass through.
        return self.datasets.get(name)

    def ingest_stats(self) -> Dict[str, Any]:
        """Per-dataset step-stall accounting from every shard that keeps
        it (ShardIterator): did input ever stall the step?"""
        out: Dict[str, Any] = {}
        for name, ds in self.datasets.items():
            stats_fn = getattr(ds, "ingest_stats", None)
            if stats_fn is not None:
                out[name] = stats_fn()
        return out


_session: Optional[_TrainSession] = None
_session_lock = threading.Lock()


def init_session(session: _TrainSession):
    global _session
    with _session_lock:
        _session = session


def shutdown_session():
    global _session
    with _session_lock:
        _session = None


def get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active: session APIs are only usable inside "
            "a train_loop_per_worker launched by a Trainer.")
    return _session


# Public functional API ------------------------------------------------------


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().loaded_checkpoint


def get_context() -> TrainContext:
    return get_session().context


def get_world_rank() -> int:
    return get_session().context.world_rank


def get_world_size() -> int:
    return get_session().context.world_size


def get_local_rank() -> int:
    return get_session().context.local_rank


def get_dataset_shard(name: str = "train"):
    return get_session().get_dataset_shard(name)


def get_ingest_stats() -> Dict[str, Any]:
    """Step-stall accounting of this worker's dataset shards (per
    dataset: steps, stall_ms_total, stall_frac — see
    ray_tpu_torch/data/streaming/ingest.py). Empty when shards don't track
    ingest (plain iterables)."""
    return get_session().ingest_stats()


def get_device():
    """The torch device this worker trains on: its granted card
    (`cuda`, which is card 0 of its CUDA_VISIBLE_DEVICES) or the CPU."""
    return get_session().device


def get_mesh():
    """The DeviceMesh the backend laid over the training workers' ranks
    (`ScalingConfig.mesh`), on this worker's device type; None when the
    trainer was configured without one."""
    return get_session().mesh


def get_collective():
    """The run-wide host collective group (`ray_tpu_torch.collective`):
    ring allreduce, broadcast and barriers between the training workers,
    through host memory. Raises when the session has no group of peers."""
    group = get_session().collective()
    if group is None:
        raise RuntimeError(
            "No host collective available: this session is not running "
            "under a WorkerGroup of more than one worker (a single-process "
            "loop has no peers).")
    return group


def _tensors(tree):
    """The tensors of a tensor, a (nested) list, tuple or dict of them, or
    a module's state dict, in a fixed order."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _tensors(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    if tree is None:
        return []
    raise TypeError(f"expected tensors, got {type(tree).__name__}")


def sync_gradients(grads, op: str = "mean"):
    """Data-parallel gradient sync: all-reduce, in place, every tensor of
    `grads` (a tensor, a nested list/tuple/dict of tensors, e.g.
    `[p.grad for p in model.parameters()]`) across the training workers
    over the torch.distributed group, and return `grads`. `op` is "mean"
    or "sum". One worker has nothing to sync."""
    import torch.distributed as dist

    if op not in ("mean", "sum"):
        raise ValueError(f"op must be 'mean' or 'sum', not {op!r}")
    world = get_session().context.world_size
    if world <= 1:
        return grads
    for t in _tensors(grads):
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        if op == "mean":
            t.div_(world)
    return grads


def broadcast_params(params, src_rank: int = 0):
    """Broadcast, in place, every tensor of `params` (a module, whose state
    dict is sent, or tensors as `sync_gradients` takes them) from worker
    `src_rank` to all others, and return `params`."""
    import torch.distributed as dist

    if get_session().context.world_size <= 1:
        return params
    for t in _tensors(params):
        dist.broadcast(t, src=src_rank)
    return params
