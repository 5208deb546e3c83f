"""Tuned configurations with pass/fail thresholds — the learning
north-stars.

The port's copy of `ray_tpu/rllib/tuned_examples.py`: the same registry,
configurations and thresholds, on the port's algorithms (the learner on
the card).

Equivalent of the reference's `rllib/tuned_examples/` YAMLs
(`tuned_examples/ppo/atari-ppo.yaml:1-35`, `impala/atari-impala.yaml:1-21`):
each entry pairs an algorithm config with a reward-vs-timestep threshold
that defines "learns". `run_tuned` drives training until the threshold or
the budget is hit.

Real Atari needs `ale-py` + `gymnasium[atari]` at runtime; environments
without them exercise the identical pipeline (CNN module, Atari
connectors, uint8 transport) on the synthetic Atari-shaped env — see
`atari_available()`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


def atari_available() -> bool:
    try:
        import ale_py  # noqa: F401
        import gymnasium  # noqa: F401

        return True
    except ImportError:
        return False


@dataclass
class TunedExample:
    name: str
    algo: str                       # "PPO" | "IMPALA" | "DQN"
    config_builder: Callable[[], Any]
    stop_reward: float              # threshold defining "learns"
    max_timesteps: int              # sample budget to reach it


def _atari_ppo_config(env_id: str):
    """Mirrors `tuned_examples/ppo/atari-ppo.yaml`: 5e-5 lr, 0.1 clip,
    10 SGD iters over 500-step fragments, vf clip 10."""
    from ray_tpu_torch.rllib import PPOConfig

    return PPOConfig(
        env=env_id,
        num_rollout_workers=4,
        num_envs_per_worker=8,
        rollout_fragment_length=100,
        sgd_minibatch_size=500,
        num_sgd_iter=10,
        lr=5e-5,
        clip_param=0.1,
        vf_clip_param=10.0,
        entropy_coeff=0.01,
        lambda_=0.95,
        seed=0,
    )


def _atari_impala_config(env_id: str):
    """Mirrors `tuned_examples/impala/atari-impala.yaml`."""
    from ray_tpu_torch.rllib import IMPALAConfig

    return IMPALAConfig(
        env=env_id,
        num_rollout_workers=4,
        num_envs_per_worker=8,
        rollout_fragment_length=50,
        lr=6e-4,
        entropy_coeff=0.01,
        seed=0,
    )


# Thresholds from the reference's tuned examples (reward the config must
# reach within the timestep budget on the real environment).
ATARI_PPO = {
    "breakout-ppo": TunedExample(
        "breakout-ppo", "PPO",
        lambda: _atari_ppo_config("ALE/Breakout-v5"),
        stop_reward=30.0, max_timesteps=5_000_000),
    "beamrider-ppo": TunedExample(
        "beamrider-ppo", "PPO",
        lambda: _atari_ppo_config("ALE/BeamRider-v5"),
        stop_reward=500.0, max_timesteps=5_000_000),
    "qbert-ppo": TunedExample(
        "qbert-ppo", "PPO",
        lambda: _atari_ppo_config("ALE/Qbert-v5"),
        stop_reward=1000.0, max_timesteps=5_000_000),
    "spaceinvaders-ppo": TunedExample(
        "spaceinvaders-ppo", "PPO",
        lambda: _atari_ppo_config("ALE/SpaceInvaders-v5"),
        stop_reward=300.0, max_timesteps=5_000_000),
}

ATARI_IMPALA = {
    "breakout-impala": TunedExample(
        "breakout-impala", "IMPALA",
        lambda: _atari_impala_config("ALE/Breakout-v5"),
        stop_reward=40.0, max_timesteps=10_000_000),
}

TUNED_EXAMPLES: Dict[str, TunedExample] = {**ATARI_PPO, **ATARI_IMPALA}


@dataclass
class TunedRunResult:
    passed: bool
    best_reward: float
    timesteps: int
    curve: list = field(default_factory=list)  # (timesteps, reward) pairs


def run_tuned(example: TunedExample,
              max_timesteps: Optional[int] = None,
              max_iters: int = 10_000) -> TunedRunResult:
    """Train the example's config until stop_reward or the budget runs
    out; returns the reward-vs-timesteps curve for the record."""
    from ray_tpu_torch import rllib

    algo_cls = getattr(rllib, example.algo)
    algo = algo_cls(example.config_builder())
    budget = max_timesteps or example.max_timesteps
    best = float("-inf")
    steps = 0
    curve = []
    try:
        for _ in range(max_iters):
            m = algo.train()
            steps = m.get("timesteps_total", steps)
            r = m.get("episode_reward_mean")
            if r is not None:
                best = max(best, r)
                curve.append((steps, float(r)))
            if best >= example.stop_reward or steps >= budget:
                break
    finally:
        algo.stop()
    return TunedRunResult(passed=best >= example.stop_reward,
                          best_reward=best, timesteps=steps, curve=curve)
