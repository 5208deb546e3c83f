"""WorkerGroup: N training-worker actors, placement-grouped.

The port's copy of `ray_tpu/train/worker_group.py` (the reference's
`python/ray/train/_internal/worker_group.py:100`). Workers are generic
function-executor actors; the backend's process-group setup and the
training loop both run through them. A worker granted GPUs sees exactly
its cards (the raylet sets its CUDA_VISIBLE_DEVICES) and trains on
`cuda`. A group of more than one worker is watched by the `shardgroup`
gang monitor: when a rank dies, the next `execute*` call fails at once,
naming the rank, instead of at the collective's timeout. `shutdown()`
returns once the worker processes on this host have exited, so a card
they held is free when it returns.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.session import (
    TrainContext,
    _TrainSession,
    init_session,
    shutdown_session,
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
                       datasets: Optional[Dict[str, Any]] = None,
                       experiment_name: str = "", run_nonce: str = "",
                       mesh_builder: Optional[Callable] = None):
        """Run `train_fn` in a thread of this actor, on `device` ("cuda",
        the card this worker was granted, or "cpu"), with this worker's
        dataset shards (`session.get_dataset_shard`) and the mesh that
        `mesh_builder(device_type=...)` builds over the group's ranks
        (`session.get_mesh`; every rank builds it here, together). Whether
        this process can train on the card is checked here, where the card
        is: a worker that cannot raises, naming itself."""
        assert self._thread is None or not self._thread.is_alive(), \
            "training already running"
        from ray_tpu_torch._torch_env import resolve_device

        try:
            torch_device = resolve_device(device)
        except RuntimeError as e:
            raise RuntimeError(
                f"train worker rank {self.rank} (pid {os.getpid()}, "
                "CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}) cannot train "
                f"on {device!r}: {e}") from None
        mesh = (mesh_builder(device_type=torch_device.type)
                if mesh_builder is not None else None)
        context = TrainContext(world_rank=self.rank,
                               world_size=self.world_size,
                               experiment_name=experiment_name)
        collective_factory = None
        if self.world_size > 1:
            rank, world = self.rank, self.world_size
            # Run-unique name (nonce from the executor): concurrent runs
            # with the same experiment name can never share a group.
            group_name = (f"train:{experiment_name or 'run'}"
                          f":{run_nonce or 'default'}")

            def collective_factory():
                from ray_tpu_torch import collective as _collective
                from ray_tpu_torch.exceptions import CollectiveError

                try:
                    return _collective.init_collective_group(
                        world, rank, group_name=group_name)
                except CollectiveError:
                    # A crashed previous run left the name broken (its
                    # members died, the record stayed). Clear it — only
                    # if still broken, so a peer's fresh incarnation
                    # survives the race — and join the new epoch.
                    ray_tpu_torch._require_runtime().gcs.call(
                        "collective_destroy",
                        {"name": group_name, "if_broken": True}, timeout=10)
                    return _collective.init_collective_group(
                        world, rank, group_name=group_name)

        session = _TrainSession(context, device=torch_device,
                                datasets=datasets, checkpoint=checkpoint,
                                mesh=mesh,
                                collective_factory=collective_factory)
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

    def finish(self):
        if self._session is not None:
            self._session.teardown_collective()
        shutdown_session()
        self._session = None
        return True


def process_exited(pid: int) -> bool:
    """Whether process `pid` has exited: gone, or a zombie its parent has
    not reaped yet (which holds no memory and no card)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True
    except OSError:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except PermissionError:
            pass
        return False


def wait_exited(procs: List[Dict[str, Any]],
                timeout: float = 30.0) -> List[int]:
    """Wait until each process of `procs` (`TrainWorker.node_info()`
    records) that runs on this host has exited. The runtime hands a killed
    worker's resources on at once, before its process has ended; waiting
    here means the next holder of its card starts on a card no process of
    this group still holds. Returns the pids still alive at `timeout`."""
    host = socket.gethostname()
    pids = [p["pid"] for p in procs if p.get("hostname") == host
            and not process_exited(p["pid"])]
    deadline = time.monotonic() + timeout
    while pids and time.monotonic() < deadline:
        time.sleep(0.02)
        pids = [pid for pid in pids if not process_exited(pid)]
    return pids


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
        # Each worker's node_info(): its host and pid, which shutdown()
        # waits on.
        self.procs: List[Dict[str, Any]] = []
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
            self.procs = ray_tpu_torch.get(
                [w.node_info.remote() for w in self.workers])
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
        """Kill every worker and release the placement group; returns once
        the worker processes on this host have exited (`wait_exited`).
        Raises RuntimeError if one is still alive 30 s after its kill: a
        card it holds is not free."""
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor.group._dead = True
            self._monitor = None
        self._abort_gang()
        procs, self.procs = self.procs, []
        alive = wait_exited(procs)
        if alive:
            raise RuntimeError(f"train worker processes {alive} still alive "
                               "30 s after their group was shut down")
