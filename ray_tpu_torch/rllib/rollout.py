"""RolloutWorker / WorkerSet: the sampling half of the algorithm.

The port of `ray_tpu/rllib/rollout.py` (the reference's
`RolloutWorker.sample`, `rllib/evaluation/rollout_worker.py:166,879`, and
`WorkerSet`, `worker_set.py:79`, `sync_weights` :384): each worker steps a
vectorized env with the exploration policy, records [T, n_envs]
trajectories, computes per-step next-state values for GAE bootstrapping,
and returns a flat SampleBatch. A worker's net runs on the card unless
"cpu" is asked for; the algorithms ask for the CPU (their
`rollout_platform`), so their workers are CPU actors (the runtime gives
them `CUDA_VISIBLE_DEVICES=""`) and the card belongs to the learner.
Workers take the learner's weights as a CPU state dict. Sampling fans out
with one task each.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._torch_env import granted_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.rl_module import (build_module_from_env_spec,
                                           make_generator)

logger = logging.getLogger(__name__)


class RolloutWorker:
    """Stateful sampler: keeps env state between sample() calls so rollout
    fragments stitch into full episodes across iterations.

    `device` is where the worker's net runs: the card unless "cpu" is asked
    for. In a process the runtime granted no card, asking for one raises.
    `num_threads` sets torch's intra-op threads for this process (None
    leaves torch's default)."""

    def __init__(self, env: Any, n_envs: int = 8, seed: int = 0,
                 hidden=(64, 64), module: Optional[Any] = None,
                 device: Optional[str] = None, connectors: Any = None,
                 num_threads: Optional[int] = None):
        if num_threads:
            torch.set_num_threads(num_threads)
        self.env = make_env(env, n_envs=n_envs, seed=seed,
                            connectors=connectors)
        self.module = module or build_module_from_env_spec(
            self.env_spec(), hidden=hidden)
        self.net = self.module.build(granted_device(
            device, "rollout worker",
            "sample in a WorkerSet with device='cuda', which grants its "
            "workers GPUs"), seed)
        self._gen = make_generator(next(self.net.parameters()).device,
                                   seed + 1000)
        self._obs = self.env.reset()
        # Episode-return tracking (for episode_reward_mean).
        self._ep_returns = np.zeros(self.env.n_envs, dtype=np.float64)
        self._ep_lens = np.zeros(self.env.n_envs, dtype=np.int64)
        self._completed: List[float] = []
        self._completed_lens: List[int] = []

    def set_weights(self, weights: Dict[str, torch.Tensor]):
        self.net.load_state_dict(weights)

    def env_spec(self) -> Dict[str, Any]:
        return {"obs_dim": self.env.obs_dim, "n_actions": self.env.n_actions,
                "n_envs": self.env.n_envs,
                "obs_shape": tuple(self.env.obs_shape)}

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect `num_steps` env steps (x n_envs transitions), flattened."""
        n = self.env.n_envs
        obs_buf = np.empty((num_steps, n) + tuple(self.env.obs_shape),
                           dtype=self.env.obs_dtype)
        act_buf = np.empty((num_steps, n), dtype=np.int64)
        rew_buf = np.empty((num_steps, n), dtype=np.float32)
        done_buf = np.empty((num_steps, n), dtype=bool)
        trunc_buf = np.empty((num_steps, n), dtype=bool)
        logp_buf = np.empty((num_steps, n), dtype=np.float32)
        vf_buf = np.empty((num_steps, n), dtype=np.float32)
        next_vf_buf = np.empty((num_steps, n), dtype=np.float32)

        obs = self._obs
        final_obs_fixups: List = []  # (t, rows, final_obs[rows])
        for t in range(num_steps):
            out = self.module.forward_exploration(self.net, obs, self._gen)
            # The env needs host actions every step: this copy IS the
            # rollout contract.
            host = {k: v.cpu().numpy() for k, v in out.items()}
            actions = host["actions"]
            next_obs, rewards, dones, infos = self.env.step(actions)
            obs_buf[t] = obs
            act_buf[t] = actions
            rew_buf[t] = rewards
            done_buf[t] = dones
            trunc_buf[t] = infos.get("truncated", np.zeros(n, dtype=bool))
            logp_buf[t] = host["logp"]
            vf_buf[t] = host["vf"]
            self._ep_returns += rewards
            self._ep_lens += 1
            done_rows = np.nonzero(dones)[0]
            if done_rows.size:
                # Auto-reset replaces the episode's true final obs with the
                # new episode's first obs; keep the real one so truncation
                # bootstraps V(final), not V(reset) (reference stores the
                # final obs the same way).
                fo = infos.get("final_obs")
                if fo is not None:
                    final_obs_fixups.append(
                        (t, done_rows, np.asarray(fo)[done_rows]))
                for i in done_rows:
                    self._completed.append(float(self._ep_returns[i]))
                    self._completed_lens.append(int(self._ep_lens[i]))
                    self._ep_returns[i] = 0.0
                    self._ep_lens[i] = 0
            obs = next_obs
        self._obs = obs

        # One batched value pass for all next-state values: V(s_{t+1}) is
        # V(s_t) shifted, with the tail row evaluated on the final obs.
        next_vf_buf[:-1] = vf_buf[1:]
        tail = self.module.forward_inference(self.net, obs)
        next_vf_buf[-1] = tail["vf"].cpu().numpy()
        # Patch done rows with V(true final obs): one batched forward over
        # every done row in the fragment.
        if final_obs_fixups:
            all_fo = np.concatenate([f[2] for f in final_obs_fixups])
            vals = self.module.forward_inference(
                self.net, all_fo)["vf"].cpu().numpy()
            pos = 0
            for t, rows, _ in final_obs_fixups:
                next_vf_buf[t, rows] = vals[pos: pos + rows.size]
                pos += rows.size

        batch = {
            sb.OBS: obs_buf.reshape(
                (num_steps * n,) + tuple(self.env.obs_shape)),
            # Tail observation: lets an off-policy learner (IMPALA) compute
            # its own bootstrap V(x_{T}) with current params.
            "_last_obs": np.asarray(obs, dtype=self.env.obs_dtype),
            sb.ACTIONS: act_buf.reshape(-1),
            sb.REWARDS: rew_buf.reshape(-1),
            sb.DONES: done_buf.reshape(-1),
            sb.TRUNCATEDS: trunc_buf.reshape(-1),
            sb.LOGP: logp_buf.reshape(-1),
            sb.VF_PREDS: vf_buf.reshape(-1),
            "_next_vf": next_vf_buf.reshape(-1),
            "_shape": np.array([num_steps, n]),
        }
        if final_obs_fixups:
            # True final observations for done rows (flat [T*n] indices):
            # off-policy learners bootstrap truncated episodes from the
            # real final state instead of the auto-reset observation.
            batch["_final_obs_at"] = np.concatenate(
                [t * n + rows for t, rows, _ in final_obs_fixups])
            batch["_final_obs"] = np.concatenate(
                [fo for _, _, fo in final_obs_fixups])
        return batch

    def episode_stats(self, clear: bool = True) -> Dict[str, Any]:
        stats = {
            "episodes": len(self._completed),
            "episode_reward_mean": float(np.mean(self._completed))
            if self._completed else None,
            "episode_len_mean": float(np.mean(self._completed_lens))
            if self._completed_lens else None,
        }
        if clear:
            self._completed = self._completed[-100:]
            self._completed_lens = self._completed_lens[-100:]
        return stats

    def cuda_visible_devices(self) -> Optional[str]:
        """What the runtime granted this worker (`""`: no card)."""
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES")


class WorkerSet:
    """N rollout-worker actors + weight broadcast (reference worker_set.py).

    `device` is the workers' net device: the card unless "cpu" is asked for
    (the algorithms pass their `rollout_platform`, "cpu" by default). On the
    card each worker is granted 1 / num_workers GPU (the workers share one
    card); on the CPU the workers are CPU actors. Each worker runs torch on
    max(1, int(num_cpus_per_worker)) threads."""

    def __init__(self, env: Any, num_workers: int = 2, n_envs: int = 8,
                 hidden=(64, 64), seed: int = 0,
                 num_cpus_per_worker: float = 0.5,
                 device: Optional[str] = None,
                 connectors: Any = None, module: Optional[Any] = None):
        num_gpus = 0
        if torch.device("cuda" if device is None else device).type == "cuda":
            import ray_tpu_torch

            num_gpus = 1 / max(1, num_workers)
            if ray_tpu_torch.cluster_resources().get("GPU", 0) < num_gpus:
                raise RuntimeError(
                    "rollout workers on the card need GPU grants and this "
                    "cluster has too few GPUs: pass device='cpu' to sample "
                    "on the CPU")
        self._ctor = dict(env=env, n_envs=n_envs, hidden=tuple(hidden),
                          device=device, seed=seed,
                          num_cpus=num_cpus_per_worker, num_gpus=num_gpus,
                          connectors=connectors, module=module)
        self.workers = [self._make(i) for i in range(num_workers)]
        self.num_workers = num_workers
        self._last_weights_ref = None  # re-sync replacements (see sample)

    def _make(self, idx: int):
        import ray_tpu_torch

        c = self._ctor
        actor_cls = ray_tpu_torch.remote(RolloutWorker)
        opts = {"num_cpus": c["num_cpus"]}
        if c["num_gpus"]:
            opts["num_gpus"] = c["num_gpus"]
        return actor_cls.options(**opts).remote(
            c["env"], n_envs=c["n_envs"], seed=c["seed"] + idx,
            hidden=c["hidden"], device=c["device"],
            connectors=c["connectors"], module=c["module"],
            num_threads=max(1, int(c["num_cpus"])))

    def restart_worker(self, idx: int):
        """Replace a dead worker actor in place (fault tolerance —
        reference `FaultTolerantActorManager`)."""
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(self.workers[idx])
        except Exception:  # noqa: BLE001 — already gone
            pass
        self.workers[idx] = self._make(idx)
        return self.workers[idx]

    def sync_weights(self, weights: Any):
        import ray_tpu_torch

        ref = ray_tpu_torch.put(weights)
        self._last_weights_ref = ref
        refs = [w.set_weights.remote(ref) for w in self.workers]  # fan out
        for r in refs:
            try:
                ray_tpu_torch.get(r)
            except Exception:  # noqa: BLE001 — dead worker: the next
                # sample() replaces it and the following broadcast re-syncs
                # its weights; don't die mid-broadcast.
                logger.warning("sync_weights: a rollout worker is dead")

    def sample(self, steps_per_worker: int) -> List[Dict[str, np.ndarray]]:
        """Fan out one sample task per worker. A dead worker is replaced in
        place and its fragment re-collected from the replacement (reference
        FaultTolerantActorManager) — PPO/DQN iterations survive worker loss
        without their own fault logic."""
        import ray_tpu_torch

        refs = [w.sample.remote(steps_per_worker) for w in self.workers]
        out = []
        for i, r in enumerate(refs):
            try:
                out.append(ray_tpu_torch.get(r))
            except Exception:  # noqa: BLE001 — dead worker
                logger.warning("sample: restarting dead rollout worker %d", i)
                w = self.restart_worker(i)
                if self._last_weights_ref is not None:
                    # The replacement initialized random weights; re-sync
                    # the last broadcast before sampling so its fragment
                    # is on-policy.
                    ray_tpu_torch.get(
                        w.set_weights.remote(self._last_weights_ref))
                out.append(ray_tpu_torch.get(w.sample.remote(steps_per_worker)))
        return out

    def episode_stats(self) -> List[Dict[str, Any]]:
        import ray_tpu_torch

        refs = [w.episode_stats.remote() for w in self.workers]  # fan out
        out = []
        for r in refs:
            try:
                out.append(ray_tpu_torch.get(r))
            except Exception:  # noqa: BLE001 — dead worker: stats are
                # advisory; its replacement reports next iteration.
                pass
        return out

    def env_spec(self) -> Dict[str, int]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.workers[0].env_spec.remote())

    def shutdown(self):
        import ray_tpu_torch

        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — already gone
                pass
