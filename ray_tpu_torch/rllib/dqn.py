"""DQN on the new stack: Q-module, double-Q learner, prioritized replay.

The port of `ray_tpu/rllib/dqn.py` (the reference's `rllib/algorithms/dqn/`:
DQNConfig, target network, double-Q, prioritized replay): the TD update
(double-Q argmax, Huber loss, importance weighting, the optimizer step)
runs on the learner's card, the target network is a frozen copy of the
net refreshed by `sync_target`, and exploration is epsilon-greedy with
epsilon carried as a buffer of the net, so it rides the ordinary weight
broadcast to every rollout actor with no side-channel schedule state.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.learner import (Learner, make_learner_group,
                                          target_copy)
from ray_tpu_torch.rllib.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer)
from ray_tpu_torch.rllib.rl_module import (
    RLModule,
    SpecDict,
    _ConvPolicyValueNet,
    _PolicyValueNet,
    as_device_tensor,
    conv_spec_for,
    net_device,
    params_from_jax as _net_params_from_jax,
)
from ray_tpu_torch.rllib.rollout import WorkerSet

logger = logging.getLogger(__name__)


class _QNet(nn.Module):
    """The Q-network and its exploration rate: `epsilon` is a buffer (no
    gradient, untouched by the optimizer, in the state dict)."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net
        self.register_buffer("epsilon", torch.tensor(1.0))

    def init_weights(self, gen: torch.Generator):
        self.net.init_weights(gen)

    def forward(self, obs):
        return self.net(obs)[0]


class QModule(RLModule):
    """Q-network module: the policy head's outputs ARE the Q-values.

    Its net's state dict is the policy/value net's under "net." plus
    "epsilon" (the reference's `{"net": params, "epsilon": f32}`), so the
    algorithm's schedule reaches every rollout actor through the ordinary
    weight broadcast.
    """

    def __init__(self, spec: SpecDict, hidden: Sequence[int] = (64, 64)):
        self.spec = spec
        self.hidden = tuple(hidden)

    def make_net(self) -> nn.Module:
        spec = self.spec
        if len(spec.shape()) >= 2:
            net = _ConvPolicyValueNet(spec.shape(), spec.n_actions,
                                      **conv_spec_for(spec.shape()[0]))
        else:
            net = _PolicyValueNet(spec.obs_dim, self.hidden, spec.n_actions)
        return _QNet(net)

    @staticmethod
    def params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
        """The state dict from the reference's `{"net": flax tree,
        "epsilon": f32}` weights."""
        out = {f"net.{k}": v
               for k, v in _net_params_from_jax(params_np["net"]).items()}
        out["epsilon"] = torch.tensor(float(params_np["epsilon"]))
        return out

    def q_values(self, net, obs):
        return net(obs)

    # -- rollout interface ----------------------------------------------------

    @torch.no_grad()
    def forward_exploration(self, net, obs, gen):
        q = net(as_device_tensor(obs, net_device(net)))
        greedy = torch.argmax(q, dim=-1)
        u = torch.rand(greedy.shape, generator=gen, device=gen.device)
        random_a = torch.randint(0, self.spec.n_actions, greedy.shape,
                                 generator=gen, device=gen.device)
        explore = u.to(q.device) < net.epsilon
        actions = torch.where(explore, random_a.to(q.device), greedy)
        return {"actions": actions, "logp": torch.zeros_like(q[..., 0]),
                "vf": q.max(dim=-1).values}

    @torch.no_grad()
    def forward_inference(self, net, obs):
        q = net(as_device_tensor(obs, net_device(net)))
        return {"actions": torch.argmax(q, dim=-1),
                "vf": q.max(dim=-1).values}


@dataclass
class DQNConfig:
    env: Any = "CartPole-v1"
    num_rollout_workers: int = 1
    num_envs_per_worker: int = 8
    rollout_fragment_length: int = 16
    buffer_capacity: int = 50_000
    prioritized_replay: bool = True
    prioritized_alpha: float = 0.6
    prioritized_beta: float = 0.4
    learning_starts: int = 1_000
    train_batch_size: int = 64
    updates_per_iteration: int = 16
    target_network_update_freq: int = 500   # env steps between target syncs
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_timesteps: int = 10_000
    gamma: float = 0.99
    lr: float = 5e-4
    grad_clip: float = 10.0
    double_q: bool = True
    hidden: tuple = (64, 64)
    seed: int = 0
    learner_mode: str = "local"
    num_learners: int = 1
    learner_resources: Optional[Dict[str, float]] = None
    num_cpus_per_worker: float = 0.4
    rollout_platform: Optional[str] = "cpu"  # the samplers' device
    connectors: Any = None
    # The learner's device: the card unless "cpu" is asked for.
    device: Optional[str] = "cuda"

    def build(self) -> "DQN":
        return DQN(self)


class DQNLearner(Learner):
    """TD learner with a target network; `update_dqn` returns |TD| per
    sample so the prioritized buffer can reweight what it replays."""

    batch_update_methods = ("update", "update_many", "update_dqn")

    def __init__(self, module: QModule, config, seed: int = 0, **kw):
        super().__init__(module, config, seed=seed, **kw)
        self.target_net = target_copy(self.net)

    def _td_loss(self, net, batch):
        """One TD/Huber loss definition shared by compute_loss (Learner
        interface) and update_dqn (priority-replay path)."""
        cfg = self.config
        q = self.module.q_values(net, batch[sb.OBS])
        q_taken = q.gather(-1, batch[sb.ACTIONS][..., None].long())[..., 0]
        with torch.no_grad():
            q_next_target = self.module.q_values(self.target_net,
                                                 batch["next_obs"])
            if cfg.double_q:
                best = torch.argmax(
                    self.module.q_values(net, batch["next_obs"]), dim=-1)
                q_boot = q_next_target.gather(-1, best[..., None])[..., 0]
            else:
                q_boot = q_next_target.max(dim=-1).values
            not_done = 1.0 - batch[sb.DONES].float()
            targets = batch[sb.REWARDS] + cfg.gamma * not_done * q_boot
        td = q_taken - targets
        weights = batch.get("weights")
        # optax.huber_loss(td, delta=1.0).
        abs_td = td.abs()
        quadratic = torch.clamp(abs_td, max=1.0)
        huber = 0.5 * quadratic ** 2 + (abs_td - quadratic)
        loss = torch.mean(huber if weights is None else weights * huber)
        return loss, td.detach(), q.detach().mean()

    def compute_loss(self, net, batch):
        """Learner-interface loss (reference learner.py:645 keeps one
        update path)."""
        loss, _, q_mean = self._td_loss(net, batch)
        return loss, {"td_loss": loss, "q_mean": q_mean}

    def update_dqn(self, batch: Dict[str, np.ndarray]):
        orig_n = len(next(iter(batch.values())))
        if orig_n == 0:
            return {}, np.zeros(0, np.float32)
        loss, td, q_mean = self._td_loss(self.net, self._to_device(batch))
        norm = self.apply_gradients(loss)
        metrics = self._report({"td_loss": loss.detach(), "q_mean": q_mean,
                                "grad_norm": norm})
        return metrics, td.abs().cpu().numpy()

    def sync_target(self):
        self.target_net.load_state_dict(self.net.state_dict())

    def get_state(self):
        state = super().get_state()
        state["target_net"] = {
            k: v.detach().to("cpu", copy=True)
            for k, v in self.target_net.state_dict().items()}
        return state

    def set_state(self, state):
        super().set_state(state)
        self.target_net.load_state_dict(state["target_net"])


class DQN:
    """The Algorithm: replay-driven off-policy training (reference
    `rllib/algorithms/dqn/dqn.py` training_step)."""

    def __init__(self, config: DQNConfig):
        from ray_tpu_torch.rllib.env import make_env

        self.config = config
        # Probe the env locally for its spec (cheaper than a worker probe).
        probe = make_env(config.env, n_envs=1, seed=config.seed,
                         connectors=config.connectors)
        spec = SpecDict(probe.obs_dim, probe.n_actions,
                        tuple(probe.obs_shape))
        del probe
        module = QModule(spec, hidden=config.hidden)
        self.workers = WorkerSet(
            config.env, num_workers=config.num_rollout_workers,
            n_envs=config.num_envs_per_worker, hidden=config.hidden,
            seed=config.seed,
            num_cpus_per_worker=config.num_cpus_per_worker,
            device=config.rollout_platform,
            connectors=config.connectors,
            module=module)
        self.module = module
        try:
            self.learner_group = make_learner_group(config, module,
                                                    DQNLearner)
        except Exception:
            self.workers.shutdown()
            raise
        if config.prioritized_replay:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_capacity, alpha=config.prioritized_alpha,
                beta=config.prioritized_beta, seed=config.seed)
        else:
            self.buffer = ReplayBuffer(config.buffer_capacity,
                                       seed=config.seed)
        self.iteration = 0
        self._timesteps = 0
        self._last_target_sync = 0
        self._sync_exploration_weights()

    # ------------------------------------------------------------- schedule

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps / max(1, cfg.epsilon_timesteps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def _sync_exploration_weights(self):
        weights = self.learner_group.get_weights()
        weights["epsilon"] = torch.tensor(self._epsilon(), dtype=torch.float32)
        self.workers.sync_weights(weights)

    # ------------------------------------------------------------- training

    def _transitions(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """Trajectory fragment [T*n] -> (s, a, r, s', done) columns.

        next_obs is the time-shifted obs with the fragment tail bootstrapped
        from `_last_obs` and done rows patched with the TRUE final obs (the
        rollout records them before auto-reset). The TD target masks on
        terminateds only: truncated episodes (time limits) still bootstrap
        from their real final state.
        """
        T, n = batch.pop("_shape")
        obs = batch[sb.OBS].reshape((T, n) + batch[sb.OBS].shape[1:])
        next_obs = np.concatenate(
            [obs[1:], batch["_last_obs"][None]],
            axis=0).reshape(batch[sb.OBS].shape)
        fo_at = batch.get("_final_obs_at")
        if fo_at is not None:
            next_obs[fo_at] = batch["_final_obs"]
        terminated = batch[sb.DONES] & ~batch[sb.TRUNCATEDS]
        return {
            sb.OBS: batch[sb.OBS],
            "next_obs": next_obs,
            sb.ACTIONS: batch[sb.ACTIONS],
            sb.REWARDS: batch[sb.REWARDS].astype(np.float32),
            sb.DONES: terminated,
        }

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        for frag in self.workers.sample(cfg.rollout_fragment_length):
            self._timesteps += sb.batch_size(frag)
            self.buffer.add(self._transitions(frag))
        sample_s = time.perf_counter() - t0

        metrics: Dict[str, float] = {}
        updates = 0
        t1 = time.perf_counter()
        if len(self.buffer) >= max(cfg.learning_starts, cfg.train_batch_size):
            for _ in range(cfg.updates_per_iteration):
                replay = self.buffer.sample(cfg.train_batch_size)
                idx = replay.pop("_batch_indices")
                metrics, td_abs = self._learner_update(replay)
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    self.buffer.update_priorities(idx, td_abs)
                updates += 1
        learn_s = time.perf_counter() - t1

        if self._timesteps - self._last_target_sync >= \
                cfg.target_network_update_freq and updates:
            self._learner_sync_target()
            self._last_target_sync = self._timesteps
        self._sync_exploration_weights()
        return {"sample_s": sample_s, "learn_s": learn_s,
                "updates": updates, "epsilon": self._epsilon(),
                "buffer_size": len(self.buffer), **metrics}

    def _learner_update(self, batch):
        # LearnerGroup.call dispatches a learner METHOD by name.
        return self.learner_group.call("update_dqn", batch)

    def _learner_sync_target(self):
        self.learner_group.call("sync_target")

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        step_metrics = self.training_step()
        stats = self.workers.episode_stats()
        rewards = [s["episode_reward_mean"] for s in stats
                   if s["episode_reward_mean"] is not None]
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps,
            "episode_reward_mean": float(np.mean(rewards)) if rewards else None,
            **step_metrics,
        }

    # --------------------------------------------------------- checkpointing

    def save(self, path: str) -> str:
        import os
        import pickle

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm.pkl"), "wb") as f:
            pickle.dump({"learner": self.learner_group.get_state(),
                         "timesteps": self._timesteps,
                         "iteration": self.iteration,
                         "buffer": self.buffer.state(),
                         "last_target_sync": self._last_target_sync}, f)
        return path

    def restore(self, path: str):
        import os
        import pickle

        with open(os.path.join(path, "algorithm.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._timesteps = state["timesteps"]
        self.iteration = state["iteration"]
        if "buffer" in state:
            self.buffer.set_state(state["buffer"])
        self._last_target_sync = state.get("last_target_sync", 0)
        self._sync_exploration_weights()

    def stop(self):
        self.workers.shutdown()
        self.learner_group.shutdown()
