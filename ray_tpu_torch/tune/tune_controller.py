"""TuneController: trials as actors, scheduler decisions, experiment state.

The port's copy of `ray_tpu/tune/tune_controller.py` (the reference's
`TrialRunner`/`TuneController`,
`python/ray/tune/execution/trial_runner.py:1189`, `tune_controller.py`, and
`RayTrialExecutor`, `ray_trial_executor.py:188`, collapsed): trials run in
dedicated CPU actors (the report-queue protocol of Train's workers), the
controller multiplexes `next_result` futures with `ray_tpu_torch.wait`,
applies scheduler decisions (ASHA stop, PBT exploit), persists experiment
state after every event, and restores mid-experiment.

What differs from the JAX package: the trial actor sets up no accelerator
environment (a trainer's workers are granted the card, not the trial
actor); `resources_per_trial` speaks `GPU`; and a trial that is stopped or
fails leaves no worker of its trainer alive. The controller asks the trial
actor to `stop()` before it kills it: the trainable's next report raises
`TrialStopped`, which unwinds a trainer's run through its own shutdown of
its workers (their processes gone), so the next trial's worker can be
granted the card. Killing the actor stays the fallback, and the trainer
workers that the trial last reported are killed after it.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import _TrainSession
from ray_tpu_torch.tune.schedulers import (
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.trial import Trial, TrialStatus

logger = logging.getLogger(__name__)

# How long the controller waits for a trial actor to stop its trainable and
# its trainer's workers before it kills the actor anyway.
STOP_TIMEOUT_S = 120.0


class TrialStopped(BaseException):
    """Raised by `tune.report` in a trial the controller stopped, so the
    trainable unwinds through its own clean-up (`finally` blocks, a
    trainer's worker shutdown). A BaseException, so a trainable's
    `except Exception` does not swallow it."""


class _TrialSession(_TrainSession):
    """The trial's session: `report` raises once the trial was stopped.
    `trainer_workers` holds the actor ids (hex) of the workers of a trainer
    running in the trial, set by its trainable (`as_trainable`)."""

    stopped = False
    trainer_workers: List[str] = []

    def report(self, metrics, checkpoint=None):
        if self.stopped:
            raise TrialStopped(f"trial {self.context.trial_name} was stopped")
        super().report(metrics, checkpoint)


class _TrialActor:
    """Runs one trial's function in a thread; results stream via a queue
    (the TrainWorker protocol, `ray_tpu_torch/train/worker_group.py`)."""

    def __init__(self):
        self._session: Optional[_TrialSession] = None
        self._thread: Optional[threading.Thread] = None

    def run(self, fn: Callable, config: Dict[str, Any],
            checkpoint_path: Optional[str], trial_id: str):
        from ray_tpu_torch.train.session import TrainContext, init_session

        checkpoint = Checkpoint.from_directory(checkpoint_path) \
            if checkpoint_path else None
        context = TrainContext(world_rank=0, world_size=1, trial_name=trial_id)
        session = _TrialSession(context, checkpoint=checkpoint)
        self._session = session
        init_session(session)

        def target():
            try:
                import inspect

                if len(inspect.signature(fn).parameters) > 0:
                    session.final_return = fn(config)
                else:
                    session.final_return = fn()
            except BaseException as e:  # noqa: BLE001
                session.error = e
            finally:
                session.finished.set()

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return True

    def next_result(self, timeout: float = 600.0):
        """The next report, or the trainable's end; each reply also names
        the trainer workers this trial runs now (`workers`), which the
        controller kills should this actor die."""
        import queue as _q

        session = self._session
        deadline = time.monotonic() + timeout
        while True:
            try:
                item = session.result_queue.get(timeout=0.1)
                return {"done": False, **item,
                        "workers": list(session.trainer_workers)}
            except _q.Empty:
                if session.finished.is_set() and session.result_queue.empty():
                    if session.error is not None:
                        from ray_tpu_torch.core import serialization

                        return {"done": True,
                                "error": serialization.serialize_exception(
                                    session.error, "trainable")}
                    return {"done": True, "final": session.final_return}
                if time.monotonic() > deadline:
                    return {"done": False, "timeout": True}

    def stop(self, timeout: float = STOP_TIMEOUT_S) -> bool:
        """End the trial here: the trainable's next report raises
        TrialStopped, which a trainer's run unwinds through its workers'
        shutdown, and the trainable's thread is joined. True when the
        thread ended within `timeout` with no error but TrialStopped; else
        the controller goes on to kill the actor and the workers. A
        trainable that had already ended stops as it is: its error, if
        any, is the trial's result."""
        session = self._session
        if session is None or session.finished.is_set():
            return True
        session.stopped = True
        self._thread.join(timeout)
        return not self._thread.is_alive() and (
            session.error is None or isinstance(session.error, TrialStopped))


class TuneController:
    def __init__(self, trainable: Callable, trials: List[Trial],
                 scheduler: Optional[TrialScheduler] = None,
                 max_concurrent: int = 0,
                 experiment_dir: str = ".",
                 stop: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None,
                 mode: str = "min",
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 searcher: Optional[Any] = None,
                 num_samples: Optional[int] = None,
                 max_failures: int = 0,
                 sync_uri: Optional[str] = None,
                 sync_period_s: float = 5.0):
        self.trainable = trainable
        self.trials = trials
        self.scheduler = scheduler or TrialScheduler()
        self.stop = stop or {}
        self.metric = metric
        self.mode = mode
        # Adaptive search: the searcher proposes new trials as capacity
        # frees, informed by completed results, up to num_samples total.
        self.searcher = searcher
        self.num_samples = num_samples or len(trials)
        self._created = len(trials)
        # Trial fault tolerance: a trial whose ACTOR dies (node failure,
        # OOM kill) restarts from its last checkpoint up to max_failures
        # times (reference FailureConfig.max_failures).
        self.max_failures = max_failures
        self.experiment_dir = experiment_dir
        self.resources_per_trial = resources_per_trial or {}
        if max_concurrent <= 0:
            max_concurrent = self._default_concurrency()
        self.max_concurrent = max_concurrent
        os.makedirs(experiment_dir, exist_ok=True)
        # Cloud experiment sync (reference tune/syncer.py): the local
        # experiment dir mirrors to a bucket URI, throttled, plus a final
        # sync when the run ends; `Tuner.restore()` reads the bucket copy.
        self.sync_uri = sync_uri
        self.sync_period_s = sync_period_s
        self._last_sync = 0.0
        self._actors: Dict[str, Any] = {}          # trial_id -> actor handle
        self._inflight: Dict[Any, Trial] = {}      # next_result ref -> trial
        self._workers: Dict[str, List[str]] = {}   # trial_id -> worker ids

    def _default_concurrency(self) -> int:
        """One trial per cluster CPU, and no more trials than the cluster
        has cards for when the trainable says it trains on GPUs
        (`tune_gpus`, set by `TorchTrainer.as_trainable`): a GPU trial
        beyond that would only wait for a card."""
        try:
            resources = ray_tpu_torch.cluster_resources()
        except Exception:  # noqa: BLE001 — no cluster view: stay small
            return 2
        n = max(1, int(resources.get("CPU", 2)))
        gpus = getattr(self.trainable, "tune_gpus", 0)
        if gpus:
            n = min(n, max(1, int(resources.get("GPU", 0) // gpus)))
        return n

    # ------------------------------------------------------------- main loop

    def _more_to_create(self) -> bool:
        return self.searcher is not None and self._created < self.num_samples

    def run(self) -> List[Trial]:
        while not all(t.is_finished for t in self.trials) \
                or self._more_to_create():
            self._start_pending()
            if not self._inflight:
                # PENDING covers a just-restarted trial whose relaunch the
                # next pass will attempt — breaking here would strand it.
                if any(t.status in (TrialStatus.RUNNING, TrialStatus.PENDING)
                       for t in self.trials):
                    time.sleep(0.05)
                    continue
                break
            refs = list(self._inflight.keys())
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=5.0)
            for ref in ready:
                trial = self._inflight.pop(ref)
                try:
                    res = ray_tpu_torch.get(ref)
                except Exception as e:  # actor died
                    self._maybe_restart(trial, f"trial actor died: {e}")
                    continue
                self._handle_result(trial, res)
            self.save()
        self.save(final=True)
        return self.trials

    def _start_pending(self):
        running = sum(1 for t in self.trials if t.status == TrialStatus.RUNNING)
        pending = [t for t in self.trials if t.status == TrialStatus.PENDING]
        while running < self.max_concurrent:
            if not pending and self._more_to_create():
                config = self.searcher.suggest()
                if config is None:
                    break
                trial = Trial(config=config)
                self.trials.append(trial)
                pending.append(trial)
                self._created += 1
            if not pending:
                break
            trial = self.scheduler.choose_trial_to_run(pending)
            if trial is None:
                break
            pending.remove(trial)
            self._launch(trial)
            if trial.status == TrialStatus.RUNNING:
                running += 1  # failed launches don't consume concurrency

    def _launch(self, trial: Trial):
        opts: Dict[str, Any] = {}
        if self.resources_per_trial:
            res = dict(self.resources_per_trial)
            if "CPU" in res:
                opts["num_cpus"] = res.pop("CPU")
            if "GPU" in res:
                opts["num_gpus"] = res.pop("GPU")
            if res:
                opts["resources"] = res
        actor_cls = ray_tpu_torch.remote(_TrialActor)
        try:
            actor = actor_cls.options(**opts).remote() if opts \
                else actor_cls.remote()
            self._actors[trial.trial_id] = actor
            trial.start_time = time.time()
            ray_tpu_torch.get(actor.run.remote(self.trainable, trial.config,
                                               trial.checkpoint_path,
                                               trial.trial_id))
            ref = actor.next_result.remote()
        except Exception as e:  # noqa: BLE001 — a fast-dying trainable can
            # take the actor down before run() even acknowledges (or between
            # the ack and the first next_result submission); same restart
            # budget as a mid-trial death.
            self._maybe_restart(trial, f"trial failed during launch: {e}")
            return
        trial.status = TrialStatus.RUNNING
        self._inflight[ref] = trial

    def _maybe_restart(self, trial: Trial, msg: str):
        if trial.num_failures < self.max_failures:
            trial.num_failures += 1
            logger.warning(
                "trial %s died (%s); restarting from %s (failure %d/%d)",
                trial.trial_id, msg, trial.checkpoint_path,
                trial.num_failures, self.max_failures)
            self._cleanup_actor(trial, kill=True)
            trial.status = TrialStatus.PENDING
        else:
            self._fail_trial(trial, msg)

    def _handle_result(self, trial: Trial, res: Dict[str, Any]):
        actor = self._actors.get(trial.trial_id)
        if res.get("done"):
            if res.get("error") is not None:
                from ray_tpu_torch.core import serialization

                err = serialization.deserialize_exception(res["error"])
                self._fail_trial(trial, repr(err))
            else:
                final = res.get("final")
                if isinstance(final, dict):
                    trial.last_result.update(final)
                    trial.metrics_history.append(dict(final))
                trial.status = TrialStatus.TERMINATED
                trial.runtime_s = time.time() - trial.start_time
                self.scheduler.on_trial_complete(trial)
                self._notify_searcher(trial)
            self._cleanup_actor(trial)
            return
        if res.get("timeout"):
            self._inflight[actor.next_result.remote()] = trial
            return
        self._workers[trial.trial_id] = list(res.get("workers") or ())
        # A reported (metrics, checkpoint) pair.
        metrics = dict(res.get("metrics") or {})
        trial.num_results += 1
        metrics.setdefault("training_iteration", trial.num_results)
        ckpt = res.get("checkpoint")
        if ckpt is not None:
            path = os.path.join(self.experiment_dir, trial.trial_id,
                                f"checkpoint_{trial.num_results:06d}")
            ckpt.to_directory(path)
            trial.checkpoint_path = path
        trial.last_result.update(metrics)
        trial.metrics_history.append(metrics)
        if self.searcher is not None and hasattr(self.searcher, "on_result"):
            # Fidelity-aware searchers (BOHB) model intermediate results
            # at their budget (training_iteration), not just final scores.
            try:
                self.searcher.on_result(trial.config, metrics)
            except Exception:
                logger.exception("searcher on_result failed")
        decision = self.scheduler.on_trial_result(trial, metrics)
        if self._stop_condition_met(metrics):
            decision = TrialScheduler.STOP
        if decision == TrialScheduler.STOP:
            trial.status = TrialStatus.TERMINATED
            trial.runtime_s = time.time() - trial.start_time
            self.scheduler.on_trial_complete(trial)
            self._notify_searcher(trial)
            self._cleanup_actor(trial, kill=True)
        elif decision == PopulationBasedTraining.EXPLOIT and \
                isinstance(self.scheduler, PopulationBasedTraining):
            self._exploit(trial)
        else:
            self._inflight[actor.next_result.remote()] = trial

    def _exploit(self, trial: Trial):
        """PBT: restart this trial from a top-quantile trial's checkpoint
        with a perturbed config."""
        sched: PopulationBasedTraining = self.scheduler
        target = sched.exploit_target(trial)
        if target is None or target.checkpoint_path is None:
            self._inflight[self._actors[trial.trial_id].next_result.remote()] = trial
            return
        logger.info("PBT exploit: trial %s <- %s", trial.trial_id,
                    target.trial_id)
        self._cleanup_actor(trial, kill=True)
        trial.config = sched.perturb(target.config)
        trial.checkpoint_path = target.checkpoint_path
        trial.status = TrialStatus.PENDING

    def _stop_condition_met(self, metrics: Dict[str, Any]) -> bool:
        for key, bound in self.stop.items():
            v = metrics.get(key)
            if v is None:
                continue
            if key == "training_iteration" or self.mode == "max":
                if v >= bound:
                    return True
            elif v <= bound:
                return True
        return False

    def _notify_searcher(self, trial: Trial):
        if self.searcher is None:
            return
        score = trial.last_result.get(self.metric) if self.metric else None
        try:
            self.searcher.on_trial_complete(trial.config, score)
        except Exception:
            logger.exception("searcher on_trial_complete failed")

    def _fail_trial(self, trial: Trial, msg: str):
        trial.status = TrialStatus.ERROR
        trial.error = msg
        trial.runtime_s = time.time() - trial.start_time
        self._cleanup_actor(trial, kill=True)

    def _cleanup_actor(self, trial: Trial, kill: bool = False):
        """Drop the trial's actor and end its process. With `kill` (the
        trial was stopped or failed while its trainable may still run),
        first ask it to stop: its trainable unwinds and its trainer's
        workers exit. Then kill it and any trainer worker it last
        reported, which covers an actor that died before it could stop
        them."""
        actor = self._actors.pop(trial.trial_id, None)
        workers = self._workers.pop(trial.trial_id, [])
        doomed = [r for r, t in self._inflight.items() if t is trial]
        for r in doomed:
            self._inflight.pop(r, None)
        if actor is None:
            return
        try:
            if kill and not ray_tpu_torch.get(actor.stop.remote(),
                                              timeout=STOP_TIMEOUT_S + 10):
                logger.warning("trial %s did not stop cleanly within "
                               "%.0f s; killing its actor and workers",
                               trial.trial_id, STOP_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — dead actor: the kills below
            logger.debug("stop of trial %s failed", trial.trial_id,
                         exc_info=True)
        from ray_tpu_torch.actor import ActorHandle
        from ray_tpu_torch.core.ids import ActorID

        for handle in [actor] + [ActorHandle(ActorID.from_hex(w))
                                 for w in workers]:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001 — already gone
                pass

    # ------------------------------------------------------ experiment state

    def save(self, final: bool = False):
        state = {"trials": [t.state() for t in self.trials],
                 "metric": self.metric, "mode": self.mode}
        path = os.path.join(self.experiment_dir, "tuner.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)
        self._maybe_sync(final)

    def _maybe_sync(self, final: bool):
        if not self.sync_uri:
            return
        now = time.time()
        if not final and now - self._last_sync < self.sync_period_s:
            return
        self._last_sync = now
        from ray_tpu_torch.train import storage

        attempts = 3 if final else 1
        for i in range(attempts):
            try:
                storage.upload_dir(self.experiment_dir, self.sync_uri)
                return
            except Exception:  # noqa: BLE001 — results are already safe
                # in experiment_dir; a failed upload must not turn a
                # completed run into a raise out of fit().
                logger.warning("experiment sync to %s failed (attempt "
                               "%d/%d)", self.sync_uri, i + 1, attempts,
                               exc_info=True)
                time.sleep(1.0 * (i + 1))

    @staticmethod
    def load_trials(experiment_dir: str) -> List[Trial]:
        path = os.path.join(experiment_dir, "tuner.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        trials = [Trial.from_state(s) for s in state["trials"]]
        # Trials that were mid-flight resume from their last checkpoint.
        for t in trials:
            if t.status in (TrialStatus.RUNNING, TrialStatus.PAUSED):
                t.status = TrialStatus.PENDING
        return trials
