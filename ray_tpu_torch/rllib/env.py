"""Vectorized environments for rollout workers.

Equivalent of the reference's env layer (`rllib/env/vector_env.py`) reduced
to the batch-first protocol the sampler needs:

    reset() -> obs [n_envs, obs_dim]
    step(actions [n_envs]) -> (obs, rewards, dones, infos)

with auto-reset on termination (done envs restart; the returned obs is the
fresh episode's first observation, reference `VectorEnv` semantics).

`CartPoleVectorEnv` is a pure-numpy vectorized CartPole (dynamics per the
classic Barto-Sutton-Anderson formulation) — the sampler hot loop stays in
numpy instead of stepping n Python envs. `GymnasiumVectorEnv` adapts any
gymnasium env id; it imports gymnasium only when one is made.

The port's copy of `ray_tpu/rllib/env.py` (numpy only).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np


class VectorEnv:
    n_envs: int
    obs_dim: int
    n_actions: int
    max_episode_steps: int = 500

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        """Per-env observation shape; (obs_dim,) for flat envs, [H, W] or
        [H, W, C] for image envs."""
        return (self.obs_dim,)

    @property
    def obs_dtype(self):
        return np.float32

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
        raise NotImplementedError


class CartPoleVectorEnv(VectorEnv):
    """Numpy-vectorized CartPole-v1 (same constants as gymnasium's)."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5           # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4

    def __init__(self, n_envs: int = 8, seed: int = 0,
                 max_episode_steps: int = 500):
        self.n_envs = n_envs
        self.obs_dim = 4
        self.n_actions = 2
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((n_envs, 4), dtype=np.float64)
        self._steps = np.zeros(n_envs, dtype=np.int64)
        self._total_mass = self.MASSPOLE + self.MASSCART
        self._polemass_length = self.MASSPOLE * self.LENGTH

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=(self.n_envs, 4))
        self._steps[:] = 0
        return self._state.astype(np.float32)

    def _reset_envs(self, mask: np.ndarray):
        n = int(mask.sum())
        if n:
            self._state[mask] = self._rng.uniform(-0.05, 0.05, size=(n, 4))
            self._steps[mask] = 0

    def step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self._polemass_length * theta_dot ** 2 * sintheta
                ) / self._total_mass
        theta_acc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0
                           - self.MASSPOLE * costheta ** 2 / self._total_mass))
        x_acc = temp - self._polemass_length * theta_acc * costheta \
            / self._total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * theta_acc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1

        terminated = (np.abs(x) > self.X_LIMIT) | \
            (np.abs(theta) > self.THETA_LIMIT)
        truncated = (self._steps >= self.max_episode_steps) & ~terminated
        dones = terminated | truncated
        rewards = np.ones(self.n_envs, dtype=np.float32)
        # Auto-reset finished episodes; the truncated flag marks boundaries
        # where GAE should bootstrap V(next). Termination takes precedence
        # when both land on the same step (gymnasium/RLlib semantics).
        # final_obs carries the TRUE pre-reset state at done rows so value
        # bootstrapping at truncation uses the right state. Only built when
        # an episode actually ended — the hot loop stays allocation-lean.
        infos = {"truncated": truncated.copy()}
        if dones.any():
            infos["final_obs"] = self._state.astype(np.float32)
        self._reset_envs(dones)
        return (self._state.astype(np.float32), rewards, dones, infos)


class GymnasiumVectorEnv(VectorEnv):
    """Adapter over `gymnasium.make_vec` for arbitrary env ids."""

    def __init__(self, env_id: str, n_envs: int = 8, seed: int = 0, **kw):
        import gymnasium as gym

        # SAME_STEP autoreset so the obs returned at a done step is the new
        # episode's first observation (gymnasium 1.x defaults to NEXT_STEP,
        # which would inject a bogus no-op transition after every episode).
        # Native vector entry points reject vector_kwargs, so pin the sync
        # vectorizer, which honors autoreset_mode.
        try:
            kw.setdefault("vectorization_mode", "sync")
            kw.setdefault("vector_kwargs",
                          {"autoreset_mode": gym.vector.AutoresetMode.SAME_STEP})
        except AttributeError:
            pass  # older gymnasium: same-step is already the behavior
        self._env = gym.make_vec(env_id, num_envs=n_envs, **kw)
        self.n_envs = n_envs
        space = self._env.single_observation_space
        self.obs_dim = int(np.prod(space.shape))
        # Image spaces (rank >= 2, e.g. Atari [210, 160, 3] uint8) keep
        # their native shape and dtype for the connector pipeline; flat
        # spaces normalize to [n, obs_dim] float32.
        self._image = len(space.shape) >= 2
        self._shape = tuple(space.shape) if self._image else (self.obs_dim,)
        self._dtype = np.uint8 if (self._image
                                   and space.dtype == np.uint8) else np.float32
        self.n_actions = int(self._env.single_action_space.n)
        self._seed = seed
        spec = getattr(self._env, "spec", None)
        self.max_episode_steps = getattr(spec, "max_episode_steps", 500) or 500

    @property
    def obs_shape(self):
        return self._shape

    @property
    def obs_dtype(self):
        return self._dtype

    def _cast(self, obs: np.ndarray) -> np.ndarray:
        if self._image:
            return np.asarray(obs, dtype=self._dtype)
        return obs.reshape(self.n_envs, -1).astype(np.float32)

    def reset(self) -> np.ndarray:
        obs, _ = self._env.reset(seed=self._seed)
        return self._cast(obs)

    def step(self, actions: np.ndarray):
        obs, rewards, terminated, truncated, infos = self._env.step(actions)
        terminated = np.asarray(terminated)
        truncated = np.asarray(truncated) & ~terminated  # termination wins
        dones = terminated | truncated
        obs = self._cast(obs)
        out_infos = {"truncated": truncated}
        if dones.any():
            # Gymnasium SAME_STEP autoreset reports the pre-reset
            # observation per done env (key name varies across versions);
            # default to the returned obs where absent. Built only on steps
            # with an episode end — the hot loop stays allocation-lean.
            final_obs = obs.copy()
            raw_final = infos.get("final_obs",
                                  infos.get("final_observation"))
            if raw_final is not None:
                for i in np.nonzero(dones)[0]:
                    fo = raw_final[i]
                    if fo is not None:
                        final_obs[i] = np.asarray(
                            fo, final_obs.dtype).reshape(self._shape)
            out_infos["final_obs"] = final_obs
        return (obs, np.asarray(rewards, dtype=np.float32), dones, out_infos)


class CatchVectorEnv(VectorEnv):
    """Synthetic image env (uint8 [H, W] frames): a pellet falls from a
    random column; the agent moves a paddle along the bottom row
    (left/stay/right) and gets +1 for catching it, -1 for missing.

    Serves as the Atari-shaped workload for the image pipeline (CNN module
    + connectors) in environments without ale_py — same dtype, obs rank,
    and reward sparsity class as Pong-like games, but cheap enough for CI.
    """

    def __init__(self, n_envs: int = 8, seed: int = 0, size: int = 21,
                 shaped: bool = False):
        self.n_envs = n_envs
        self.size = size
        self.obs_dim = size * size
        self.n_actions = 3
        self.max_episode_steps = size  # one drop per episode
        # shaped=True adds a small per-step reward for closing the
        # paddle-ball gap — turns the sparse terminal signal into a dense
        # one for quick CI-scale learning checks.
        self.shaped = shaped
        self._rng = np.random.default_rng(seed)
        self._ball_col = np.zeros(n_envs, dtype=np.int64)
        self._ball_row = np.zeros(n_envs, dtype=np.int64)
        self._paddle = np.zeros(n_envs, dtype=np.int64)

    @property
    def obs_shape(self):
        return (self.size, self.size)

    @property
    def obs_dtype(self):
        return np.uint8

    def _render(self) -> np.ndarray:
        frames = np.zeros((self.n_envs, self.size, self.size), dtype=np.uint8)
        idx = np.arange(self.n_envs)
        frames[idx, self._ball_row, self._ball_col] = 255
        frames[idx, self.size - 1, self._paddle] = 128
        return frames

    def _spawn(self, mask: np.ndarray):
        n = int(mask.sum())
        if n:
            self._ball_col[mask] = self._rng.integers(0, self.size, n)
            self._ball_row[mask] = 0
            self._paddle[mask] = self._rng.integers(0, self.size, n)

    def reset(self) -> np.ndarray:
        self._spawn(np.ones(self.n_envs, dtype=bool))
        return self._render()

    def step(self, actions: np.ndarray):
        gap_before = np.abs(self._paddle - self._ball_col)
        self._paddle = np.clip(self._paddle + (actions - 1), 0, self.size - 1)
        self._ball_row += 1
        landed = self._ball_row >= self.size - 1
        caught = landed & (self._paddle == self._ball_col)
        rewards = np.where(caught, 1.0, np.where(landed, -1.0, 0.0)
                           ).astype(np.float32)
        if self.shaped:
            gap_after = np.abs(self._paddle - self._ball_col)
            rewards += 0.1 * np.sign(gap_before - gap_after).astype(np.float32)
        dones = landed.copy()
        infos: Dict[str, Any] = {"truncated": np.zeros(self.n_envs, bool)}
        if dones.any():
            infos["final_obs"] = self._render()
        self._spawn(dones)
        return self._render(), rewards, dones, infos


class ConnectorVectorEnv(VectorEnv):
    """Wraps a VectorEnv with an observation connector pipeline (reference
    agent connectors run in this position inside the rollout worker).

    Handles the stateful FrameStack correctly across auto-resets: done rows
    restart their stacks from the new episode's first frame, and the
    true-final-obs bootstrap gets the stack as it WOULD have continued.
    """

    def __init__(self, inner: VectorEnv, pipeline):
        from ray_tpu_torch.rllib.connectors import FrameStack

        self.inner = inner
        self.pipeline = pipeline
        self._stateless = [c for c in pipeline.connectors
                           if not isinstance(c, FrameStack)]
        stacks = [c for c in pipeline.connectors if isinstance(c, FrameStack)]
        assert len(stacks) <= 1, "at most one FrameStack per pipeline"
        if stacks:
            # Application order is stateless-then-stack; a FrameStack
            # anywhere but last would make the declared output_shape
            # contradict what step() actually emits.
            assert isinstance(pipeline.connectors[-1], FrameStack), \
                "FrameStack must be the LAST connector in the pipeline"
        self._stack = stacks[0] if stacks else None
        self.n_envs = inner.n_envs
        self.n_actions = inner.n_actions
        self.max_episode_steps = inner.max_episode_steps
        self._shape = tuple(pipeline.output_shape(inner.obs_shape))
        self._dtype = pipeline.output_dtype(inner.obs_dtype)
        self.obs_dim = int(np.prod(self._shape))

    @property
    def obs_shape(self):
        return self._shape

    @property
    def obs_dtype(self):
        return self._dtype

    def _pre(self, obs: np.ndarray) -> np.ndarray:
        for c in self._stateless:
            obs = c(obs)
        return obs

    def reset(self) -> np.ndarray:
        x = self._pre(self.inner.reset())
        if self._stack is not None:
            self._stack._stack = None  # fresh episodes everywhere
            x = self._stack(x)
        return x

    def step(self, actions: np.ndarray):
        raw, rewards, dones, infos = self.inner.step(actions)
        x = self._pre(raw)
        out_infos: Dict[str, Any] = {
            "truncated": infos.get("truncated",
                                   np.zeros(self.n_envs, bool))}
        done_rows = np.nonzero(dones)[0]
        raw_final = infos.get("final_obs")
        if self._stack is None:
            if done_rows.size and raw_final is not None:
                out_infos["final_obs"] = self._pre(raw_final)
            return x, rewards, dones, out_infos
        # Stack the final obs BEFORE committing this step's frame: the
        # bootstrap sees frames [..t-k+2, final], not the reset frame.
        if done_rows.size and raw_final is not None:
            out_infos["final_obs"] = self._stack.peek(self._pre(raw_final))
        obs = self._stack(x)
        if done_rows.size:
            # Done rows' x is already the NEW episode's first frame
            # (auto-reset); their stacks restart from it.
            self._stack.reset_rows(done_rows, x)
            obs[done_rows] = self._stack._stack[done_rows]
        return obs, rewards, dones, out_infos


def make_env(env: Any, n_envs: int, seed: int = 0,
             connectors: Any = None) -> VectorEnv:
    """env may be a VectorEnv factory, a VectorEnv, or a gymnasium id
    (Atari "ALE/..." ids get the standard preprocessing pipeline)."""
    if isinstance(env, VectorEnv):
        out = env
    elif callable(env):
        out = env(n_envs=n_envs, seed=seed)
        assert isinstance(out, VectorEnv)
    elif env in ("CartPole-v1", "CartPole"):
        out = CartPoleVectorEnv(n_envs=n_envs, seed=seed)
    elif env in ("Catch-v0", "Catch"):
        out = CatchVectorEnv(n_envs=n_envs, seed=seed)
    else:
        out = GymnasiumVectorEnv(env, n_envs=n_envs, seed=seed)
        if connectors is None and isinstance(env, str) and \
                (env.startswith("ALE/") or "NoFrameskip" in env):
            from ray_tpu_torch.rllib.connectors import atari_connectors

            connectors = atari_connectors()
    if connectors is not None:
        from ray_tpu_torch.rllib.connectors import ConnectorPipeline

        if not isinstance(connectors, ConnectorPipeline):
            connectors = ConnectorPipeline(list(connectors))
        out = ConnectorVectorEnv(out, connectors)
    return out
