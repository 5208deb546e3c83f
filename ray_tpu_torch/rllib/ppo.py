"""PPO on the new stack: config -> algorithm -> learner loss.

The port of `ray_tpu/rllib/ppo.py` (the reference's
`rllib/algorithms/ppo/ppo.py:368,394`, `PPOConfig` and
`PPO.training_step`, and the clip-surrogate loss of `ppo_torch_policy.py`):
sample via WorkerSet on CPU actors, GAE + standardized advantages on the
host, minibatch SGD epochs on the learner's card (`update_many`: one copy
of each shuffled epoch), then a weight broadcast back to the workers.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.learner import Learner, make_learner_group
from ray_tpu_torch.rllib.rl_module import build_module_from_env_spec
from ray_tpu_torch.rllib.rollout import WorkerSet

logger = logging.getLogger(__name__)


@dataclass
class PPOConfig:
    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    num_envs_per_worker: int = 8
    rollout_fragment_length: int = 64
    train_batch_size: int = 0          # 0 = workers * envs * fragment
    sgd_minibatch_size: int = 256
    num_sgd_iter: int = 8
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    kl_target: float = 0.2
    grad_clip: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0
    learner_mode: str = "local"        # local | remote
    num_learners: int = 1              # dp group (see LearnerGroup)
    learner_resources: Optional[Dict[str, float]] = None
    num_cpus_per_worker: float = 0.4
    # The samplers' device: "cpu" keeps the card free for the learner (the
    # workers are CPU actors); None or "cuda" puts them on the card, sharing
    # one card's worth of GPU grants (WorkerSet).
    rollout_platform: Optional[str] = "cpu"
    # Observation connector pipeline (reference agent connectors); Atari
    # ids get GrayscaleResize+FrameStack automatically via make_env.
    connectors: Any = None
    # The learner's device: the card unless "cpu" is asked for.
    device: Optional[str] = "cuda"

    # Fluent API parity with the reference's AlgorithmConfig builder.
    def environment(self, env) -> "PPOConfig":
        self.env = env
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None) -> "PPOConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "PPOConfig":
        for k, v in kwargs.items():
            key = "lambda_" if k == "lambda" else k
            if not hasattr(self, key):
                raise ValueError(f"unknown PPO option {k}")
            setattr(self, key, v)
        return self

    def build(self) -> "PPO":
        return PPO(self)


class PPOLearner(Learner):
    def compute_loss(self, net, batch):
        cfg = self.config
        out = self.module.forward_train(net, batch)
        logp_ratio = torch.exp(out["logp"] - batch[sb.LOGP])
        advantages = batch[sb.ADVANTAGES]
        surrogate = torch.minimum(
            advantages * logp_ratio,
            advantages * torch.clamp(logp_ratio, 1 - cfg.clip_param,
                                     1 + cfg.clip_param))
        policy_loss = -torch.mean(surrogate)
        # Clipped value loss (reference ppo_torch_policy vf_clip_param).
        vf = out["vf"]
        vf_old = batch[sb.VF_PREDS]
        vf_clipped = vf_old + torch.clamp(vf - vf_old, -cfg.vf_clip_param,
                                          cfg.vf_clip_param)
        vf_loss = torch.mean(torch.maximum(
            (vf - batch[sb.VALUE_TARGETS]) ** 2,
            (vf_clipped - batch[sb.VALUE_TARGETS]) ** 2))
        entropy = torch.mean(out["entropy"])
        kl = torch.mean(batch[sb.LOGP] - out["logp"])
        loss = policy_loss + cfg.vf_loss_coeff * vf_loss \
            - cfg.entropy_coeff * entropy
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "entropy": entropy, "kl": kl}


class PPO:
    """The Algorithm: train() runs one iteration (reference
    `Algorithm.train` -> `PPO.training_step`)."""

    def __init__(self, config: PPOConfig):
        self.config = config
        if config.train_batch_size:
            # Derive the per-worker fragment so one sampling round yields
            # the configured train batch (reference train_batch_size).
            per_step = config.num_rollout_workers * config.num_envs_per_worker
            config.rollout_fragment_length = max(
                1, config.train_batch_size // per_step)
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
            self.learner_group = make_learner_group(config, module,
                                                    PPOLearner)
            self.workers.sync_weights(self.learner_group.get_weights())
        except Exception:
            self.workers.shutdown()
            raise
        self.iteration = 0
        self._timesteps = 0
        self._rng = np.random.default_rng(config.seed)

    # ------------------------------------------------------------- training

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        raw_batches = self.workers.sample(cfg.rollout_fragment_length)
        sample_s = time.perf_counter() - t0

        processed = [self._postprocess(b) for b in raw_batches]
        batch = sb.concat_batches(processed)
        batch[sb.ADVANTAGES] = sb.standardize(batch[sb.ADVANTAGES])
        self._timesteps += sb.batch_size(batch)

        t1 = time.perf_counter()
        metrics: Dict[str, float] = {}
        sgd_steps = 0
        for _ in range(cfg.num_sgd_iter):
            shuffled = sb.shuffle_batch(batch, self._rng)
            stacked, remainder = sb.stack_minibatches(
                self._learner_view(shuffled), cfg.sgd_minibatch_size)
            if stacked:
                # The whole epoch goes to the learner's device in one copy.
                m = self.learner_group.update_many(stacked)
                if m:
                    metrics = m
                    sgd_steps += len(next(iter(stacked.values())))
            if remainder and sb.batch_size(remainder) >= 2:
                # The ragged tail trains too (one ordinary update; may be
                # a no-op {} if dp trimming leaves nothing).
                m = self.learner_group.update(remainder)
                if m:
                    metrics = m
                    sgd_steps += 1
            if not sgd_steps:
                break
            if metrics.get("kl", 0.0) > cfg.kl_target:
                break  # early stop like the reference's KL guard
        learn_s = time.perf_counter() - t1
        self.workers.sync_weights(self.learner_group.get_weights())
        return {"sample_s": sample_s, "learn_s": learn_s,
                "sgd_steps": sgd_steps, **metrics}

    @staticmethod
    def _learner_view(mb: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {k: v for k, v in mb.items()
                if not k.startswith("_") and k not in (sb.DONES, sb.TRUNCATEDS,
                                                       sb.REWARDS)}

    def _postprocess(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        cfg = self.config
        T, n = batch.pop("_shape")
        batch.pop("_last_obs", None)       # IMPALA-only bootstrap obs
        batch.pop("_final_obs", None)      # DQN-only truncation bootstrap
        batch.pop("_final_obs_at", None)   # (optional keys would break
        #                                    concat_batches' key union)
        rewards = batch[sb.REWARDS].reshape(T, n)
        values = batch[sb.VF_PREDS].reshape(T, n)
        dones = batch[sb.DONES].reshape(T, n)
        truncs = batch[sb.TRUNCATEDS].reshape(T, n)
        next_values = batch.pop("_next_vf").reshape(T, n)
        adv, targets = sb.compute_gae(rewards, values, dones, truncs,
                                      next_values, gamma=cfg.gamma,
                                      lam=cfg.lambda_)
        batch[sb.ADVANTAGES] = adv.reshape(-1)
        batch[sb.VALUE_TARGETS] = targets.reshape(-1)
        return batch

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        step_metrics = self.training_step()
        stats = self.workers.episode_stats()
        rewards = [s["episode_reward_mean"] for s in stats
                   if s["episode_reward_mean"] is not None]
        lens = [s["episode_len_mean"] for s in stats
                if s["episode_len_mean"] is not None]
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps,
            "episode_reward_mean": float(np.mean(rewards)) if rewards else None,
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
        self.workers.shutdown()
        self.learner_group.shutdown()

    # ------------------------------------------------------- Tune trainable

    @staticmethod
    def as_trainable(base_config: PPOConfig) -> Callable:
        """A Tune trainable: PPO from `base_config` with the trial's
        overrides (`lambda` sets `lambda_`), reporting each `train()`
        until the trial is stopped, then `stop()`."""
        def trainable(config: Dict[str, Any]):
            import copy

            from ray_tpu_torch import tune

            cfg = copy.deepcopy(base_config)
            for k, v in (config or {}).items():
                key = "lambda_" if k == "lambda" else k
                if hasattr(cfg, key):
                    setattr(cfg, key, v)
            algo = PPO(cfg)
            try:
                while True:
                    tune.report(algo.train())
            finally:
                algo.stop()

        trainable.__name__ = "PPO"
        return trainable
