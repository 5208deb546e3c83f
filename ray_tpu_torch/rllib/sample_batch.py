"""SampleBatch + advantage estimation.

The port's copy of `ray_tpu/rllib/sample_batch.py` (no device code).
Equivalent of the reference's `rllib/policy/sample_batch.py` and the GAE
postprocessing in `rllib/evaluation/postprocessing.py:compute_advantages`.
Batches are plain dict[str, np.ndarray]; GAE runs vectorized over the
[T, n_envs] rollout layout before flattening for SGD.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
TRUNCATEDS = "truncateds"
LOGP = "logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


def concat_batches(batches: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    keys = batches[0].keys()
    return {k: np.concatenate([b[k] for b in batches]) for k in keys}


def batch_size(batch: Dict[str, np.ndarray]) -> int:
    return len(next(iter(batch.values())))


def shuffle_batch(batch: Dict[str, np.ndarray], rng: np.random.Generator
                  ) -> Dict[str, np.ndarray]:
    perm = rng.permutation(batch_size(batch))
    return {k: v[perm] for k, v in batch.items()}


def minibatches(batch: Dict[str, np.ndarray], minibatch_size: int):
    n = batch_size(batch)
    for start in range(0, n, minibatch_size):
        yield {k: v[start:start + minibatch_size] for k, v in batch.items()}


def stack_minibatches(batch: Dict[str, np.ndarray], minibatch_size: int
                      ) -> tuple:
    """[N, ...] -> ([n_mb, minibatch_size, ...], remainder) for
    `Learner.update_many` epochs (one copy to the learner's device). The
    ragged tail (N mod minibatch_size rows) can't join the stack (unequal
    shape) — it's returned separately so the caller can run it as one
    ordinary update. Stacked dict is {} if N < one batch."""
    n = batch_size(batch)
    n_mb = n // minibatch_size
    keep = n_mb * minibatch_size
    stacked = {} if n_mb == 0 else {
        k: v[:keep].reshape((n_mb, minibatch_size) + v.shape[1:])
        for k, v in batch.items()}
    remainder = {} if keep >= n else {k: v[keep:] for k, v in batch.items()}
    return stacked, remainder


def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                truncateds: np.ndarray, bootstrap_values: np.ndarray,
                gamma: float = 0.99, lam: float = 0.95):
    """Vectorized GAE over a [T, n_envs] rollout.

    `dones` marks episode boundaries (terminated OR truncated — the
    recursion resets either way); `truncateds` marks boundaries where the
    episode continued in principle, so the value bootstraps. `bootstrap_values`
    is V(s_{T}) for the final step plus, per step, V(next_obs) is only needed
    at truncation points — callers pass `next_values` [T, n_envs].
    """
    T, n = rewards.shape
    advantages = np.zeros((T, n), dtype=np.float32)
    last_gae = np.zeros(n, dtype=np.float32)
    for t in range(T - 1, -1, -1):
        # Value of the next state: 0 if terminated, V(next) otherwise.
        next_value = bootstrap_values[t]
        non_terminal = 1.0 - (dones[t] & ~truncateds[t]).astype(np.float32)
        not_done = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_value * non_terminal - values[t]
        last_gae = delta + gamma * lam * not_done * last_gae
        advantages[t] = last_gae
    value_targets = advantages + values
    return advantages, value_targets


def standardize(x: np.ndarray) -> np.ndarray:
    return (x - x.mean()) / (x.std() + 1e-8)
