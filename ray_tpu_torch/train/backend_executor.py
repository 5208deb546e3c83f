"""BackendExecutor: worker-group lifecycle + result streaming.

The port's copy of `ray_tpu/train/backend_executor.py` (the reference's
`python/ray/train/_internal/backend_executor.py:43`, `start` :94,
`start_training` :332): starts the WorkerGroup, runs the backend's
process-group setup, launches the per-worker loop, and streams reported
results back; whole-group restart on failure (FailureConfig).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.exceptions import RayActorError
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig,
                 max_failures: int = 0,
                 elastic_world_fn: Optional[Callable[[int, int],
                                                     Optional[int]]] = None):
        self.backend_config = backend_config
        self.backend: Backend = backend_config.backend_cls()()
        self.scaling_config = scaling_config
        self.max_failures = max_failures
        # Policy hook for elastic restarts: called with (failure_index,
        # current_world) before each gang restart; a non-None return
        # OVERRIDES the restart width (pipeline runs shrink pp this way:
        # the checkpoint restore re-splits stages at the new width). None
        # keeps WorkerGroup.restart's same-size-then-shrink-on-placement.
        self.elastic_world_fn = elastic_world_fn
        self.worker_group: Optional[WorkerGroup] = None
        # Latest checkpoint REPORTED by the run (rank 0), so a gang
        # restart resumes at the last reported step — not from the
        # checkpoint the run originally started from.
        self.latest_checkpoint = None
        # (restart_count, world_size) history for observability.
        self.restarts: List[Dict[str, Any]] = []

    def start(self):
        sc = self.scaling_config
        self.worker_group = WorkerGroup(
            num_workers=sc.num_workers,
            resources_per_worker=sc.worker_resources(),
            placement_strategy=sc.placement_strategy,
            use_placement_group=sc.num_workers > 1,
        )
        self.backend.on_start(self.worker_group, self.backend_config)

    def run(self, train_fn: Callable, config: Dict[str, Any],
            checkpoint=None, device: str = "cuda",
            datasets_per_worker: Optional[List[Dict]] = None,
            experiment_name: str = "") -> Iterator[List[Dict[str, Any]]]:
        """Generator: yields one list of per-worker results per report round;
        returns when all workers finish.

        Failure semantics (gang restart): any rank's failure aborts the
        whole gang, which restarts as a unit on a FRESH placement group,
        and the loop resumes from the LATEST reported checkpoint (the
        worker's session hands it to train_fn via session.get_checkpoint).
        Up to max_failures."""
        failures = 0
        self.latest_checkpoint = checkpoint
        while True:
            try:
                yield from self._run_once(train_fn, config,
                                          self.latest_checkpoint, device,
                                          datasets_per_worker,
                                          experiment_name)
                return
            except (RayActorError, TrainingFailedError):
                failures += 1
                if failures > self.max_failures:
                    raise
                logger.warning("worker group failed; gang restart %d/%d "
                               "(resuming from %s checkpoint)",
                               failures, self.max_failures,
                               "latest" if self.latest_checkpoint is not None
                               else "no")
                self._restart_group()

    def _restart_group(self):
        """Gang restart: abort + recreate as a unit (fresh pg), backend
        re-setup on the new incarnation. Falls back to a cold start() when
        no group exists."""
        if self.worker_group is None:
            self.start()
            return
        # No backend teardown: `restart` kills every rank, and a survivor's
        # `destroy_process_group` blocks ~10 s on the TCPStore of a dead
        # rank 0 before it gives up.
        target = None
        if self.elastic_world_fn is not None:
            target = self.elastic_world_fn(len(self.restarts) + 1,
                                           self.worker_group.num_workers)
        world = self.worker_group.restart(num_workers=target)
        self.restarts.append({"world_size": world,
                              "incarnation": self.worker_group.incarnation})
        self.backend.on_start(self.worker_group, self.backend_config)

    def _run_once(self, train_fn, config, checkpoint, device,
                  datasets_per_worker, experiment_name):
        wg = self.worker_group
        mesh_builder = None
        if hasattr(self.backend, "mesh_builder"):
            mesh_builder = self.backend.mesh_builder(self.backend_config)
        self.backend.on_training_start(wg, self.backend_config)
        # Run-unique tag shared by all ranks: the host-collective group is
        # named per run, so concurrent runs (or a restart of this one) can
        # never interleave joins into one group.
        run_nonce = os.urandom(4).hex()
        ray_tpu_torch.get([w.start_training.remote(
            train_fn, config, checkpoint, device,
            datasets_per_worker[i] if datasets_per_worker else None,
            experiment_name, run_nonce, mesh_builder)
            for i, w in enumerate(wg.workers)])
        done = [False] * len(wg.workers)
        while not all(done):
            refs = [w.next_result.remote()
                    for w, d in zip(wg.workers, done) if not d]
            alive = [i for i, d in enumerate(done) if not d]
            results = ray_tpu_torch.get(refs)
            round_results: List[Dict[str, Any]] = []
            for idx, res in zip(alive, results):
                if res.get("done"):
                    done[idx] = True
                    if res.get("error") is not None:
                        err = serialization.deserialize_exception(res["error"])
                        raise TrainingFailedError(
                            f"worker {idx} train loop failed") from err
                elif not res.get("timeout"):
                    round_results.append({"rank": idx, **res})
                    if idx == 0 and res.get("checkpoint") is not None:
                        # Rank 0's reported checkpoint is the resume
                        # point for a gang restart.
                        self.latest_checkpoint = res["checkpoint"]
            if round_results:
                yield round_results
        # Every rank's loop ended: each leaves its host collective group
        # (a graceful leave, which aborts no peer) before the group is
        # shut down. The run is over: a rank lost now restarts nothing.
        try:
            ray_tpu_torch.get([w.finish.remote() for w in wg.workers])
        except RayActorError:
            logger.warning("a train worker died after its loop ended",
                           exc_info=True)

    def worker_ids(self) -> List[str]:
        """The actor ids (hex) of the current group's workers."""
        wg = self.worker_group
        return [w._actor_id.hex() for w in wg.workers] if wg else []

    def shutdown(self):
        """Shut the group down, its worker processes gone on return (see
        WorkerGroup.shutdown, which raises if one outlives the wait)."""
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group,
                                         self.backend_config)
            except Exception:
                pass
            wg, self.worker_group = self.worker_group, None
            wg.shutdown()
