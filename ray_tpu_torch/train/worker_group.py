"""WorkerGroup: N training-worker actors, placement-grouped.

The port's copy of `ray_tpu/train/worker_group.py` (the reference's
`python/ray/train/_internal/worker_group.py:100`). Workers are generic
function-executor actors; the backend's process-group setup and the
training loop both run through them. A worker granted GPUs sees exactly
its cards (the raylet sets its CUDA_VISIBLE_DEVICES) and trains on
`cuda`. A group of more than one worker is watched by the `shardgroup`
gang monitor: when a rank dies, the next `execute*` call fails at once,
naming the rank, instead of at the collective's timeout.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.session import (
    TrainContext,
    _TrainSession,
    init_session,
)

logger = logging.getLogger(__name__)


class TrainWorker:
    """Actor hosting one training process."""

    def __init__(self, rank: int, world_size: int,
                 env: Optional[Dict[str, str]] = None):
        self.rank = rank
        self.world_size = world_size
        if env:
            os.environ.update(env)
        self._session: Optional[_TrainSession] = None
        self._thread: Optional[threading.Thread] = None

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def ping(self) -> Dict[str, Any]:
        """Liveness probe for the group's death monitor."""
        return {"ok": True, "rank": self.rank}

    def node_info(self):
        import socket

        return {"hostname": socket.gethostname(), "pid": os.getpid(),
                "rank": self.rank}

    # -- training lifecycle --------------------------------------------------

    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       checkpoint=None, device: str = "cuda",
                       experiment_name: str = ""):
        """Run `train_fn` in a thread of this actor, on `device` ("cuda",
        the card this worker was granted, or "cpu")."""
        assert self._thread is None or not self._thread.is_alive(), \
            "training already running"
        from ray_tpu_torch._torch_env import resolve_device

        context = TrainContext(world_rank=self.rank,
                               world_size=self.world_size,
                               experiment_name=experiment_name)
        session = _TrainSession(context, device=resolve_device(device),
                                checkpoint=checkpoint)
        self._session = session
        init_session(session)

        def run():
            try:
                import inspect

                if config and len(inspect.signature(train_fn).parameters) > 0:
                    session.final_return = train_fn(config)
                elif len(inspect.signature(train_fn).parameters) > 0:
                    session.final_return = train_fn({})
                else:
                    session.final_return = train_fn()
            except BaseException as e:  # noqa: BLE001
                session.error = e
                logger.exception("train loop failed on rank %d", self.rank)
            finally:
                session.finished.set()

        self._thread = threading.Thread(target=run, name="train-loop",
                                        daemon=True)
        self._thread.start()
        return True

    def next_result(self, timeout: float = 3600.0):
        """Block until the next session.report() or loop completion."""
        import queue as _q

        session = self._session
        assert session is not None, "training not started"
        while True:
            try:
                item = session.result_queue.get(timeout=0.1)
                return {"done": False, **item}
            except _q.Empty:
                if session.finished.is_set() and session.result_queue.empty():
                    if session.error is not None:
                        from ray_tpu_torch.core import serialization

                        return {"done": True,
                                "error": serialization.serialize_exception(
                                    session.error, "train_loop_per_worker")}
                    return {"done": True, "final": session.final_return}
                timeout -= 0.1
                if timeout <= 0:
                    return {"done": False, "timeout": True}


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_strategy: str = "PACK",
                 use_placement_group: bool = True):
        self.num_workers = num_workers
        self._resources_per_worker = dict(
            resources_per_worker or {"CPU": 1.0})
        self._placement_strategy = placement_strategy
        self._use_placement_group = use_placement_group
        # Bumped on every successful (re)creation.
        self.incarnation = 0
        self.workers: List[Any] = []
        self._pg = None
        self._dead_rank: Optional[int] = None
        self._monitor = None
        self._create(num_workers)

    @property
    def dead_rank(self) -> Optional[int]:
        return self._dead_rank

    def _create(self, num_workers: int, pg_timeout_s: float = 120.0):
        resources = dict(self._resources_per_worker)
        self.num_workers = num_workers
        self._pg = None
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        num_cpus = resources.pop("CPU", 1.0)
        num_gpus = resources.pop("GPU", 0)
        # CPU is a *logical* resource: scale the per-worker request down so
        # the group always fits the cluster (a 2-worker default must work on
        # a 1-CPU host). GPUs are physical and never scaled.
        try:
            total_cpu = ray_tpu_torch.cluster_resources().get("CPU", 0.0)
        except Exception:
            total_cpu = 0.0
        if total_cpu and num_cpus * num_workers > total_cpu:
            fitted = max(0.01, int(total_cpu * 100 / num_workers) / 100)
            logger.warning(
                "ScalingConfig requests %s CPUs x %d workers but the cluster "
                "has %s; scaling the per-worker CPU request to %s.",
                num_cpus, num_workers, total_cpu, fitted)
            num_cpus = fitted
        if self._use_placement_group and num_workers > 1:
            from ray_tpu_torch.util.placement_group import placement_group

            bundle = {"CPU": num_cpus}
            if num_gpus:
                bundle["GPU"] = num_gpus
            bundle.update(resources)
            self._pg = placement_group([dict(bundle)] * num_workers,
                                       strategy=self._placement_strategy)
            self._pg.ready(timeout=pg_timeout_s)
        self.workers = []
        self._dead_rank = None
        self._monitor = None
        try:
            for rank in range(num_workers):
                opts: Dict[str, Any] = {"num_cpus": num_cpus}
                if num_gpus:
                    opts["num_gpus"] = num_gpus
                if resources:
                    opts["resources"] = dict(resources)
                if self._pg is not None:
                    from ray_tpu_torch.util.scheduling_strategies import (
                        PlacementGroupSchedulingStrategy,
                    )

                    opts["scheduling_strategy"] = \
                        PlacementGroupSchedulingStrategy(
                            self._pg, placement_group_bundle_index=rank)
                try:
                    handle = actor_cls.options(**opts).remote(
                        rank, num_workers)
                except Exception as e:
                    raise RuntimeError(
                        f"creating train worker rank {rank}/{num_workers} "
                        f"failed: {type(e).__name__}: {e}") from e
                self.workers.append(handle)
        except Exception:
            # All-or-nothing: a mid-gang failure releases every
            # already-created worker AND the placement group's bundles.
            self._abort_gang()
            raise
        if num_workers > 1:
            # Group death hook: a dead worker fails the next execute()
            # fast with a rank-attributed error instead of a generic actor
            # error at the collective's timeout.
            from ray_tpu_torch.shardgroup import (GangMonitor, ReplicaGroup,
                                                  ShardSpec)

            grp = ReplicaGroup(
                f"train-wg-{id(self):x}", ShardSpec(world_size=num_workers),
                None, self.workers,
                [f"rank{r}" for r in range(num_workers)])
            self._monitor = GangMonitor(grp, self._on_worker_death)
        self.incarnation += 1

    def restart(self, num_workers: Optional[int] = None,
                deadline_s: Optional[float] = None) -> int:
        """Gang restart: abort the whole gang (every rank AND the
        placement group), then re-create it on a FRESH placement group
        under the recovery deadline, shrinking the world when the full
        gang no longer places. Returns the new world size; raises when no
        gang of any size could be formed within the deadline."""
        import time as _time

        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        if deadline_s is None:
            deadline_s = GLOBAL_CONFIG.chaos_recovery_deadline_s or 300.0
        deadline = _time.monotonic() + deadline_s
        self.shutdown()
        n = num_workers if num_workers is not None else self.num_workers
        last_err: Optional[BaseException] = None
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    f"train gang restart stuck: no {n}-worker gang could "
                    f"be formed within the {deadline_s:.0f}s recovery "
                    f"deadline (last error: {last_err})") from last_err
            try:
                self._create(n, pg_timeout_s=min(30.0, remaining))
                logger.info("train gang restarted: world=%d incarnation=%d",
                            n, self.incarnation)
                return n
            except Exception as e:  # noqa: BLE001 — retried under deadline
                last_err = e
                self._abort_gang()
                if n > 1:
                    logger.warning(
                        "train gang restart at world=%d failed (%s); "
                        "shrinking to %d", n, e, n - 1)
                    n -= 1
                _time.sleep(min(0.5, max(0.0,
                                         deadline - _time.monotonic())))

    def _abort_gang(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — never created / dead
                pass
        self.workers = []
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group,
            )

            try:
                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001 — already removed
                pass
            self._pg = None

    def _on_worker_death(self, group, rank: int):
        self._dead_rank = rank

    def _check_group_alive(self):
        if self._dead_rank is not None:
            raise RuntimeError(
                f"train worker group lost rank {self._dead_rank}/"
                f"{self.num_workers} — the group must be shut down and "
                "recreated (workers restart as a unit)")

    def __len__(self):
        return self.num_workers

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        self._check_group_alive()
        return ray_tpu_torch.get([w.execute.remote(fn, *args, **kwargs)
                                  for w in self.workers])

    def execute_async(self, fn: Callable, *args, **kwargs):
        self._check_group_alive()
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        self._check_group_alive()
        return ray_tpu_torch.get(
            self.workers[rank].execute.remote(fn, *args, **kwargs))

    def shutdown(self):
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor.group._dead = True
            self._monitor = None
        self._abort_gang()
