"""IMPALA: async sampling + V-trace off-policy correction.

The port of `ray_tpu/rllib/impala.py` (the reference's
`rllib/algorithms/impala/impala.py:65,677`: async request pipeline, mixin
replay, periodic weight broadcast; and `vtrace_torch.py`). V-trace is a
reverse loop over the fragment's T steps on device tensors (the reference's
reverse `lax.scan`); the loss, V-trace and the optimizer step run on the
learner's card.

Design differences from PPO (the on-policy path): rollout workers sample
continuously with up to `max_requests_in_flight_per_worker` outstanding
tasks each; the driver harvests whichever fragment finishes first
(`ray_tpu_torch.wait(num_returns=1)`), assembles fixed-shape train batches
(fresh fragments + mixin replay, a constant fragment count), updates the
learner, and broadcasts weights every `broadcast_interval` updates without
blocking on the workers. Workers are therefore a bounded number of policy
versions stale — exactly the off-policyness V-trace corrects.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.learner import (Learner, global_mean_std,
                                          make_learner_group)
from ray_tpu_torch.rllib.rl_module import build_module_from_env_spec
from ray_tpu_torch.rllib.rollout import WorkerSet

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------- #
# V-trace
# --------------------------------------------------------------------------- #


@torch.no_grad()
def vtrace_returns(behavior_logp, target_logp, rewards, terminateds, dones,
                   values, next_values, gamma: float,
                   clip_rho_threshold: float = 1.0,
                   clip_c_threshold: float = 1.0):
    """V-trace targets and policy-gradient advantages.

    All inputs [T, B] (time-major) tensors on one device. `terminateds`
    zeroes the bootstrap (true episode end); `dones` (terminated |
    truncated) cuts the trace so corrections never leak across auto-reset
    boundaries. `next_values[t]` is V(x_{t+1}) as seen by the behavior
    worker.

    Returns (vs, pg_advantages), both [T, B] and outside the autograd
    graph (the reference's stop_gradient).
    """
    rho = torch.exp(target_logp - behavior_logp)
    clipped_rho = torch.clamp(rho, max=clip_rho_threshold)
    clipped_c = torch.clamp(rho, max=clip_c_threshold)

    bootstrap_gamma = gamma * (1.0 - terminateds)      # [T, B]
    trace_cont = 1.0 - dones                           # [T, B]
    deltas = clipped_rho * (rewards + bootstrap_gamma * next_values - values)

    # The reverse recursion acc_t = delta_t + gamma * cont_t * c_t *
    # acc_{t+1}, one step of T at a time.
    decay = gamma * trace_cont * clipped_c
    acc = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + decay[t] * carry
        acc[t] = carry
    vs = values + acc

    # vs_{t+1} for the pg advantage: within-fragment shift; at episode ends
    # (and the fragment tail) the future is just the bootstrap value.
    vs_next = torch.cat([vs[1:], next_values[-1:]], dim=0)
    vs_next = torch.where(dones > 0, next_values, vs_next)
    pg_adv = clipped_rho * (rewards + bootstrap_gamma * vs_next - values)
    return vs, pg_adv


# --------------------------------------------------------------------------- #
# Config / Learner / Algorithm
# --------------------------------------------------------------------------- #


@dataclass
class IMPALAConfig:
    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    num_envs_per_worker: int = 8
    rollout_fragment_length: int = 64
    fragments_per_batch: int = 2       # fresh fragments per train batch
    replay_fragments: int = 0          # mixin-replayed fragments per batch
    replay_buffer_num_slots: int = 16
    max_requests_in_flight_per_worker: int = 2
    updates_per_iteration: int = 8     # learner updates per train() call
    broadcast_interval: int = 1        # weight push every N updates
    lr: float = 5e-4
    gamma: float = 0.99
    vtrace_clip_rho_threshold: float = 1.0
    vtrace_clip_c_threshold: float = 1.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 40.0
    # Standardize pg advantages per batch. The reference leaves vtrace
    # advantages raw; with small per-update batches the raw scale is
    # dominated by critic error early on, so normalization buys stable
    # small-batch learning. Set False for paper-faithful behavior.
    standardize_advantages: bool = True
    hidden: tuple = (64, 64)
    seed: int = 0
    learner_mode: str = "local"        # local | remote
    num_learners: int = 1              # dp group (see LearnerGroup)
    learner_resources: Optional[Dict[str, float]] = None
    num_cpus_per_worker: float = 0.4
    rollout_platform: Optional[str] = "cpu"  # the samplers' device
    connectors: Any = None  # observation connector pipeline
    # The learner's device: the card unless "cpu" is asked for.
    device: Optional[str] = "cuda"

    def environment(self, env) -> "IMPALAConfig":
        self.env = env
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None
                 ) -> "IMPALAConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "IMPALAConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown IMPALA option {k}")
            setattr(self, k, v)
        return self

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALALearner(Learner):
    # Batches are time-major [T, n_envs, ...]: dp splits envs so the
    # V-trace loop over T never crosses ranks.
    dp_axis = 1

    def _fragment_forward(self, net, batch):
        """One forward over the fragment obs plus the tail obs [T+1, B]:
        the learner computes its OWN values everywhere (reference vtrace
        uses learner-side values for both v_t and the bootstrap — mixing
        the behavior worker's stale value head in poisons the targets).
        Returns time-major [T, B] heads plus the extended value column
        (shared by IMPALA's loss and APPO's target-anchored variant)."""
        T, B = batch[sb.ACTIONS].shape
        obs_ext = torch.cat([batch[sb.OBS], batch["last_obs"]], dim=0)
        actions = batch[sb.ACTIONS]
        flat = {
            "obs": obs_ext.reshape(((T + 1) * B,) + obs_ext.shape[2:]),
            "actions": torch.cat(
                [actions, actions.new_zeros((1, B))],
                dim=0).reshape((T + 1) * B),
        }
        out = self.module.forward_train(net, flat)
        vf_ext = out["vf"].reshape(T + 1, B)
        heads = {
            "logp": out["logp"].reshape(T + 1, B)[:T],
            "vf": vf_ext[:T],
            "vf_ext": vf_ext,
            "entropy": out["entropy"].reshape(T + 1, B)[:T],
        }
        if "logits" in out:
            heads["logits"] = out["logits"].reshape(
                (T + 1, B) + out["logits"].shape[1:])[:T]
        return heads

    def _vtrace_advantages(self, target_logp, batch, vf, vf_ext):
        """V-trace targets + pg advantages for a fragment, with the
        done-row bootstrap substitution and optional standardization
        (over the whole batch, every rank's envs)."""
        cfg = self.config
        # V(x_{t+1}) under current params: within-fragment shift. At done
        # rows the shifted value belongs to the next episode's reset obs,
        # so substitute the behavior worker's value of the TRUE final obs
        # (terminated rows are zeroed by bootstrap_gamma; truncated rows
        # genuinely need it).
        next_vf = torch.where(batch[sb.DONES] > 0,
                              batch["behavior_next_vf"], vf_ext[1:])
        vs, pg_adv = vtrace_returns(
            behavior_logp=batch[sb.LOGP],
            target_logp=target_logp,
            rewards=batch[sb.REWARDS],
            terminateds=batch["terminateds"],
            dones=batch[sb.DONES],
            values=vf,
            next_values=next_vf,
            gamma=cfg.gamma,
            clip_rho_threshold=cfg.vtrace_clip_rho_threshold,
            clip_c_threshold=cfg.vtrace_clip_c_threshold,
        )
        if cfg.standardize_advantages:
            mean, std = global_mean_std(pg_adv, self.dp_world)
            pg_adv = (pg_adv - mean) / (std + 1e-8)
        return vs, pg_adv

    def compute_loss(self, net, batch):
        cfg = self.config
        heads = self._fragment_forward(net, batch)
        target_logp = heads["logp"]
        vf, entropy = heads["vf"], heads["entropy"]
        vs, pg_adv = self._vtrace_advantages(target_logp, batch, vf,
                                             heads["vf_ext"])
        policy_loss = -torch.mean(pg_adv * target_logp)
        vf_loss = 0.5 * torch.mean((vs - vf) ** 2)
        mean_entropy = torch.mean(entropy)
        loss = policy_loss + cfg.vf_loss_coeff * vf_loss \
            - cfg.entropy_coeff * mean_entropy
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "entropy": mean_entropy,
                      "mean_vtrace_rho": torch.mean(
                          torch.exp(target_logp - batch[sb.LOGP]))}


class IMPALA:
    """Async-sampling algorithm (reference `impala.py:677` training_step)."""

    # Subclasses on the same async machinery (APPO) swap the learner.
    learner_cls = None  # default: IMPALALearner

    def __init__(self, config: IMPALAConfig):
        import ray_tpu_torch

        self.config = config
        self.workers = WorkerSet(
            config.env, num_workers=config.num_rollout_workers,
            n_envs=config.num_envs_per_worker, hidden=config.hidden,
            seed=config.seed,
            num_cpus_per_worker=config.num_cpus_per_worker,
            device=config.rollout_platform,
            connectors=config.connectors)
        try:
            module = build_module_from_env_spec(self.workers.env_spec(),
                                                hidden=config.hidden)
            self.learner_group = make_learner_group(
                config, module, type(self).learner_cls or IMPALALearner)
            self.workers.sync_weights(self.learner_group.get_weights())
        except Exception:
            self.workers.shutdown()
            raise

        self.iteration = 0
        self._timesteps = 0
        self._updates = 0
        self._rng = np.random.default_rng(config.seed)
        self._worker_failures = 0
        self._replay: deque = deque(maxlen=config.replay_buffer_num_slots)
        self._fresh_queue: deque = deque()
        # ref -> worker index, for resubmission on completion.
        self._inflight: Dict[Any, int] = {}
        self._ray = ray_tpu_torch

    # ------------------------------------------------------------- sampling

    def _pump_sampling(self):
        """Keep every worker loaded with outstanding sample tasks.
        Submission to a dead actor raises — replace the worker and retry
        (same fault path as a failed harvest)."""
        per_worker: Dict[int, int] = {}
        for idx in self._inflight.values():
            per_worker[idx] = per_worker.get(idx, 0) + 1
        for idx in range(len(self.workers.workers)):
            while per_worker.get(idx, 0) < \
                    self.config.max_requests_in_flight_per_worker:
                try:
                    ref = self.workers.workers[idx].sample.remote(
                        self.config.rollout_fragment_length)
                except Exception:  # noqa: BLE001 — dead actor
                    if not self._replace_worker(idx):
                        break
                    continue
                self._inflight[ref] = idx
                per_worker[idx] = per_worker.get(idx, 0) + 1

    def _replace_worker(self, idx: int) -> bool:
        """Restart worker `idx`; False once the failure budget is spent."""
        self._worker_failures += 1
        if self._worker_failures > 3 * max(
                1, self.config.num_rollout_workers):
            raise RuntimeError(
                "impala: rollout workers keep dying "
                f"({self._worker_failures} failures)")
        logger.warning("impala: restarting rollout worker %d", idx)
        for r, i in list(self._inflight.items()):
            if i == idx:
                self._inflight.pop(r, None)
        try:
            worker = self.workers.restart_worker(idx)
            worker.set_weights.remote(self._ray.put(
                self.learner_group.get_weights()))
        except Exception:  # noqa: BLE001
            logger.exception("impala: worker %d restart failed", idx)
            return False
        return True

    def _harvest(self, block: bool) -> int:
        """Collect finished fragments into the fresh queue."""
        if not self._inflight:
            # Nothing outstanding (every worker dead with failed restarts,
            # or first call): re-pump rather than letting a blocking caller
            # spin; if pumping can't put anything in flight either, the
            # sampler is wedged — surface it instead of hanging.
            self._pump_sampling()
            if not self._inflight:
                if block:
                    raise RuntimeError(
                        "impala: no rollout tasks in flight and no worker "
                        f"accepts new ones ({self._worker_failures} worker "
                        "failures)")
                return 0
        refs = list(self._inflight.keys())
        ready, rest = self._ray.wait(
            refs, num_returns=1, timeout=None if block else 0.0)
        if rest:
            # Drain everything else already finished too — in particular
            # error-resolved refs from a dead worker (submission to a dead
            # actor returns errored refs rather than raising), so the
            # replacement path always runs even when a live worker's
            # fragment came back first.
            more, _ = self._ray.wait(rest, num_returns=len(rest),
                                     timeout=0.0)
            ready = list(ready) + list(more)
        got = 0
        for ref in ready:
            idx = self._inflight.pop(ref, None)
            try:
                frag = self._ray.get(ref)
            except Exception:  # noqa: BLE001 — worker died: replace it
                if idx is not None:
                    self._replace_worker(idx)
                continue
            self._fresh_queue.append(self._to_time_major(frag))
            got += 1
        self._pump_sampling()
        return got

    def _to_time_major(self, frag: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
        T, n = frag.pop("_shape")
        obs_shape = frag[sb.OBS].shape[1:]  # (obs_dim,) or image dims
        dones = frag[sb.DONES].reshape(T, n).astype(np.float32)
        truncs = frag[sb.TRUNCATEDS].reshape(T, n).astype(np.float32)
        return {
            sb.OBS: frag[sb.OBS].reshape((T, n) + obs_shape),
            "last_obs": frag["_last_obs"].reshape((1, n) + obs_shape),
            sb.ACTIONS: frag[sb.ACTIONS].reshape(T, n),
            sb.REWARDS: frag[sb.REWARDS].reshape(T, n),
            sb.LOGP: frag[sb.LOGP].reshape(T, n),
            sb.DONES: dones,
            "terminateds": np.maximum(dones - truncs, 0.0),
            # Behavior-side V(x_{t+1}) with the TRUE final obs at done rows
            # (rollout patches them); used only at episode boundaries.
            "behavior_next_vf": frag["_next_vf"].reshape(T, n),
        }

    def _assemble_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.config
        fresh = [self._fresh_queue.popleft()
                 for _ in range(cfg.fragments_per_batch)]
        for frag in fresh:
            self._replay.append(frag)
        frags = list(fresh)
        for _ in range(cfg.replay_fragments):
            # Mixin replay (reference replay_proportion): sample a stored
            # fragment; until the buffer warms up this re-reads fresh ones,
            # keeping the batch shape constant.
            frags.append(self._replay[self._rng.integers(len(self._replay))])
        # Every array is [T, n, ...] except last_obs's leading dim of 1 —
        # both concatenate along the env axis (axis 1).
        return {k: np.concatenate([f[k] for f in frags], axis=1)
                for k in frags[0]}

    # ------------------------------------------------------------- training

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, float] = {}
        frames_per_batch = (cfg.fragments_per_batch
                            * cfg.rollout_fragment_length
                            * cfg.num_envs_per_worker)
        sample_s = 0.0
        learn_s = 0.0
        self._pump_sampling()
        for _ in range(cfg.updates_per_iteration):
            t0 = time.perf_counter()
            while len(self._fresh_queue) < cfg.fragments_per_batch:
                self._harvest(block=True)
            batch = self._assemble_batch()
            sample_s += time.perf_counter() - t0

            t1 = time.perf_counter()
            metrics = self.learner_group.update(batch) or metrics
            learn_s += time.perf_counter() - t1
            self._updates += 1
            self._timesteps += frames_per_batch
            # Opportunistically drain finished fragments (non-blocking) so
            # workers never stall on a full in-flight budget.
            self._harvest(block=False)

            if self._updates % cfg.broadcast_interval == 0:
                weights_ref = self._ray.put(
                    self.learner_group.get_weights())
                for w in self.workers.workers:
                    w.set_weights.remote(weights_ref)

        total = cfg.updates_per_iteration * frames_per_batch
        return {
            "sample_wait_s": sample_s,
            "learn_s": learn_s,
            "learner_sps": total / learn_s if learn_s else 0.0,
            "updates": self._updates,
            **metrics,
        }

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        t0 = time.perf_counter()
        step_metrics = self.training_step()
        wall = time.perf_counter() - t0
        stats = self.workers.episode_stats()
        rewards = [s["episode_reward_mean"] for s in stats
                   if s["episode_reward_mean"] is not None]
        lens = [s["episode_len_mean"] for s in stats
                if s["episode_len_mean"] is not None]
        frames = (self.config.updates_per_iteration
                  * self.config.fragments_per_batch
                  * self.config.rollout_fragment_length
                  * self.config.num_envs_per_worker)
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps,
            "env_steps_per_s": frames / wall,
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else None,
            "episode_len_mean": float(np.mean(lens)) if lens else None,
            **step_metrics,
        }

    # --------------------------------------------------------- checkpointing

    def save(self, path: str) -> str:
        import os
        import pickle

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm.pkl"), "wb") as f:
            pickle.dump({"learner": self.learner_group.get_state(),
                         "iteration": self.iteration,
                         "timesteps": self._timesteps}, f)
        return path

    def restore(self, path: str):
        import os
        import pickle

        with open(os.path.join(path, "algorithm.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self.iteration = state["iteration"]
        self._timesteps = state["timesteps"]
        self.workers.sync_weights(self.learner_group.get_weights())

    def get_weights(self):
        return self.learner_group.get_weights()

    def stop(self):
        # Drop in-flight refs before killing workers.
        self._inflight.clear()
        self.workers.shutdown()
        self.learner_group.shutdown()

    @staticmethod
    def as_trainable(base_config: "IMPALAConfig") -> Callable:
        """Not ported yet: Tune has no port (ROADMAP M10)."""
        raise NotImplementedError(
            "IMPALA.as_trainable needs ray_tpu_torch.tune, which is not "
            "ported yet (ROADMAP M10)")
