"""Trial schedulers: FIFO, ASHA, PBT.

Equivalent of the reference's `python/ray/tune/schedulers/`:
`async_hyperband.py` (ASHA — rung-quantile early stopping without
synchronized brackets) and `pbt.py` (exploit top quantile's checkpoint +
perturb config). Decisions are returned from `on_trial_result`; the
controller enforces them.

The port's copy of `ray_tpu/tune/schedulers.py`: host code (numpy for
PB2's GP), with the same random streams, so that one seed and one stream
of results make the same decisions in both packages.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.trial import Trial


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        return self.CONTINUE

    def on_trial_complete(self, trial: Trial):
        pass

    def choose_trial_to_run(self, pending: List[Trial]) -> Optional[Trial]:
        return pending[0] if pending else None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Async successive halving (reference `async_hyperband.py`).

    Rungs at r, r*eta, r*eta^2, ... up to max_t; a trial reaching a rung is
    stopped unless it is in the top 1/eta of results recorded at that rung.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.eta = reduction_factor
        # rung value -> list of recorded metric values
        self.rungs: Dict[int, List[float]] = {}
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(int(t))
            t *= self.eta
        self.milestones = milestones

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, trial.num_results)
        value = result.get(self.metric)
        if value is None:
            return self.CONTINUE
        if t >= self.max_t:
            return self.STOP
        for rung in self.milestones:
            if t == rung or (t > rung and not self._recorded(trial, rung)):
                recorded = self.rungs.setdefault(rung, [])
                recorded.append(float(value))
                trial.last_result.setdefault("_asha_rungs", []).append(rung)
                if not self._in_top_fraction(float(value), recorded):
                    return self.STOP
        return self.CONTINUE

    def _recorded(self, trial: Trial, rung: int) -> bool:
        return rung in trial.last_result.get("_asha_rungs", [])

    def _in_top_fraction(self, value: float, recorded: List[float]) -> bool:
        if len(recorded) < self.eta:
            return True  # not enough data to cut
        ranked = sorted(recorded, reverse=(self.mode == "max"))
        k = max(1, int(len(ranked) / self.eta))
        cutoff = ranked[k - 1]
        return value >= cutoff if self.mode == "max" else value <= cutoff


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of
    the other trials' running averages at the same point (reference
    `schedulers/median_stopping_rule.py`)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        # trial_id -> list of metric values (one per result)
        self._histories: Dict[str, List[float]] = {}

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        value = result.get(self.metric)
        if value is None:
            return self.CONTINUE
        hist = self._histories.setdefault(trial.trial_id, [])
        hist.append(float(value))
        t = result.get(self.time_attr, trial.num_results)
        if t < self.grace_period:
            return self.CONTINUE
        # Running average of every OTHER trial up to this step count.
        others = []
        for tid, h in self._histories.items():
            if tid == trial.trial_id or not h:
                continue
            others.append(sum(h[:len(hist)]) / min(len(h), len(hist)))
        if len(others) < self.min_samples:
            return self.CONTINUE
        median = sorted(others)[len(others) // 2]
        best = max(hist) if self.mode == "max" else min(hist)
        worse = best < median if self.mode == "max" else best > median
        return self.STOP if worse else self.CONTINUE


class HyperBandScheduler(TrialScheduler):
    """Synchronized HyperBand (reference `schedulers/hyperband.py`):
    brackets of successive halving with different (n, r) trade-offs; each
    bracket halves its cohort at its milestones, keeping the top 1/eta.

    Trials are assigned to brackets round-robin at first result; within a
    bracket, halving is enforced asynchronously at each milestone (a trial
    past a milestone stops unless in the bracket's top 1/eta there) — the
    asynchronous-cutoff variant of the synchronized algorithm, which never
    idles a chip waiting for bracket stragglers.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: float = 3):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        s_max = int(math.log(max_t) / math.log(reduction_factor))
        # Bracket s starts at r0 = max_t * eta^-s with milestones up to max_t.
        self._brackets: List[Dict[str, Any]] = []
        for s in range(s_max, -1, -1):
            r0 = max(1, int(max_t * self.eta ** (-s)))
            milestones = []
            t = r0
            while t < max_t:
                milestones.append(int(t))
                t *= self.eta
            self._brackets.append({"milestones": milestones, "rungs": {}})
        self._assignment: Dict[str, int] = {}
        self._next_bracket = 0

    def _bracket_for(self, trial: Trial) -> Dict[str, Any]:
        b = self._assignment.get(trial.trial_id)
        if b is None:
            b = self._next_bracket
            self._assignment[trial.trial_id] = b
            self._next_bracket = (self._next_bracket + 1) % len(self._brackets)
        return self._brackets[b]

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        value = result.get(self.metric)
        if value is None:
            return self.CONTINUE
        t = result.get(self.time_attr, trial.num_results)
        if t >= self.max_t:
            return self.STOP
        bracket = self._bracket_for(trial)
        seen = trial.last_result.setdefault("_hb_rungs", [])
        # Record only at the HIGHEST newly-crossed milestone: appending one
        # late value to every skipped rung would compare it against peers'
        # genuinely-early values and systematically favor coarse reporters.
        crossed = [r for r in bracket["milestones"]
                   if t >= r and r not in seen]
        if crossed:
            rung = crossed[-1]
            recorded = bracket["rungs"].setdefault(rung, [])
            recorded.append(float(value))
            seen.extend(crossed)  # skipped rungs count as passed, unscored
            if len(recorded) >= self.eta and \
                    not self._in_top_fraction(float(value), recorded):
                return self.STOP
        return self.CONTINUE

    def _in_top_fraction(self, value: float, recorded: List[float]) -> bool:
        ranked = sorted(recorded, reverse=(self.mode == "max"))
        k = max(1, int(len(ranked) / self.eta))
        cutoff = ranked[k - 1]
        return value >= cutoff if self.mode == "max" else value <= cutoff


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference `pbt.py`): every `perturbation_interval` results, a
    bottom-quantile trial is stopped and respawned from a top-quantile
    trial's checkpoint with a perturbed config. The controller performs the
    respawn when it sees the EXPLOIT decision."""

    EXPLOIT = "EXPLOIT"

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self._rng = random.Random(seed)
        self._trials: Dict[str, Trial] = {}

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        self._trials[trial.trial_id] = trial
        if trial.num_results % self.interval != 0:
            return self.CONTINUE
        value = result.get(self.metric)
        if value is None:
            return self.CONTINUE
        scored = [(t.last_result.get(self.metric), t)
                  for t in self._trials.values()
                  if t.last_result.get(self.metric) is not None]
        if len(scored) < 2:
            return self.CONTINUE
        scored.sort(key=lambda x: x[0], reverse=(self.mode == "max"))
        k = max(1, int(len(scored) * self.quantile))
        bottom_ids = {t.trial_id for _, t in scored[-k:]}
        if trial.trial_id in bottom_ids:
            return self.EXPLOIT
        return self.CONTINUE

    def exploit_target(self, trial: Trial) -> Optional[Trial]:
        scored = [(t.last_result.get(self.metric), t)
                  for t in self._trials.values()
                  if t.last_result.get(self.metric) is not None
                  and t.trial_id != trial.trial_id]
        if not scored:
            return None
        scored.sort(key=lambda x: x[0], reverse=(self.mode == "max"))
        k = max(1, int(len(scored) * self.quantile))
        return self._rng.choice([t for _, t in scored[:k]])

    def perturb(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, mutation in self.mutations.items():
            if isinstance(mutation, list):
                out[key] = self._rng.choice(mutation)
            elif isinstance(mutation, Domain):
                out[key] = mutation.sample(self._rng)
            elif callable(mutation):
                out[key] = mutation()
            elif key in out and isinstance(out[key], (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                out[key] = out[key] * factor
        return out


class _GP:
    """Minimal squared-exponential Gaussian process (numpy only) — the
    reference's PB2 leans on the external GPy package
    (`tune/schedulers/pb2_utils.py`); this is the self-contained core it
    actually needs: fit on normalized inputs, predict mean/std."""

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-3):
        self.ls = lengthscale
        self.noise = noise
        self._X = self._alpha = self._L = None
        self._y_mean = 0.0
        self._y_std = 1.0

    @staticmethod
    def _sq_dists(A, B):
        import numpy as np

        return ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)

    def _k(self, A, B):
        import numpy as np

        return np.exp(-0.5 * self._sq_dists(A, B) / self.ls ** 2)

    def fit(self, X, y):
        import numpy as np

        X = np.asarray(X, float)
        y = np.asarray(y, float)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yn))
        self._X = X
        return self

    def predict(self, Xs):
        import numpy as np

        Xs = np.asarray(Xs, float)
        Ks = self._k(Xs, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return (mu * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference `tune/schedulers/pb2.py`):
    PBT where the explore step is a GP-UCB suggestion over continuous
    hyperparameter bounds instead of a random perturbation — markedly
    more sample-efficient with small populations.

    ``hyperparam_bounds`` maps each tuned key to ``(lower, upper)``.
    Each perturbation interval records (current hyperparams -> score
    improvement over the interval); exploit-triggered explores fit the
    GP on that data and pick the candidate maximizing mean + kappa * std
    within bounds.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 kappa: float = 1.5,
                 seed: Optional[int] = None):
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds: "
                             "{key: (lower, upper), ...}")
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = kappa
        # (normalized hyperparam vector, score delta over one interval)
        self._data: List[Any] = []
        self._last_score: Dict[str, float] = {}

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        decision = super().on_trial_result(trial, result)
        if trial.num_results % self.interval == 0:
            value = result.get(self.metric)
            if value is not None:
                prev = self._last_score.get(trial.trial_id)
                if prev is not None:
                    delta = (value - prev if self.mode == "max"
                             else prev - value)
                    self._data.append(
                        (self._normalize(trial.config), float(delta)))
                self._last_score[trial.trial_id] = float(value)
        if decision == self.EXPLOIT:
            # The trial is about to adopt a top trial's checkpoint: the
            # next interval's score jump measures the weight copy, not
            # the new hyperparams — dropping the baseline keeps that
            # contaminated delta out of the GP's training data.
            self._last_score.pop(trial.trial_id, None)
        return decision

    def _normalize(self, config: Dict[str, Any]) -> List[float]:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return out

    def perturb(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        out = dict(config)
        keys = list(self.bounds)
        if len(self._data) < 4:
            # Cold start: uniform exploration inside bounds.
            for k in keys:
                lo, hi = self.bounds[k]
                out[k] = self._rng.uniform(lo, hi)
            return out
        X = [x for x, _ in self._data[-64:]]
        y = [d for _, d in self._data[-64:]]
        try:
            gp = _GP().fit(X, y)
        except np.linalg.LinAlgError:
            for k in keys:
                lo, hi = self.bounds[k]
                out[k] = self._rng.uniform(lo, hi)
            return out
        rng = np.random.default_rng(self._rng.randrange(1 << 30))
        cands = rng.random((64, len(keys)))
        mu, sd = gp.predict(cands)
        best = cands[int(np.argmax(mu + self.kappa * sd))]
        for k, x in zip(keys, best):
            lo, hi = self.bounds[k]
            out[k] = lo + float(x) * (hi - lo)
        return out
