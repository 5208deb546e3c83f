"""Search spaces + trial variant generation.

Equivalent of the reference's `python/ray/tune/search/sample.py` domains and
`BasicVariantGenerator` (`tune/search/basic_variant.py`): grid_search entries
are expanded into the cross product; sampling domains draw per trial.

The port's copy of `ray_tpu/tune/search.py`, host code with the same
random streams (`random.Random(seed)`), so that one seed draws the same
configs and suggestions in both packages.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Categorical(Domain):
    categories: List[Any]

    def sample(self, rng):
        return rng.choice(self.categories)


@dataclass
class Uniform(Domain):
    lower: float
    upper: float

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)


@dataclass
class LogUniform(Domain):
    lower: float
    upper: float

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))


@dataclass
class Randint(Domain):
    lower: int
    upper: int

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


@dataclass
class QUniform(Domain):
    lower: float
    upper: float
    q: float

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        return round(v / self.q) * self.q


@dataclass
class FunctionDomain(Domain):
    fn: Callable[[], Any]

    def sample(self, rng):
        return self.fn()


class GridSearch:
    def __init__(self, values: List[Any]):
        self.values = list(values)


# Public constructors (reference `tune.grid_search`, `tune.choice`, ...)

def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(values)


def choice(categories: List[Any]) -> Categorical:
    return Categorical(list(categories))


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def loguniform(lower: float, upper: float) -> LogUniform:
    return LogUniform(lower, upper)


def randint(lower: int, upper: int) -> Randint:
    return Randint(lower, upper)


def quniform(lower: float, upper: float, q: float) -> QUniform:
    return QUniform(lower, upper, q)


def sample_from(fn: Callable[[], Any]) -> FunctionDomain:
    return FunctionDomain(fn)


class Searcher:
    """Adaptive search algorithm: suggests configs one at a time as trial
    results arrive (reference `tune/search/searcher.py` Searcher)."""

    def suggest(self) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, config: Dict[str, Any],
                          score: Optional[float]) -> None:
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator over independent dimensions
    (reference's HyperOpt/Optuna integration niche, self-contained: the
    external libraries aren't available here).

    After `n_initial` random trials, observations split into good (top
    `gamma` fraction) and bad; numeric dimensions sample candidates from a
    kernel density over the good values and keep the candidate maximizing
    the good/bad density ratio; categorical dimensions sample
    proportionally to smoothed good-counts.
    """

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: str = "min", n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, exploration: float = 0.1,
                 seed: Optional[int] = None):
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    f"TPESearcher does not accept grid_search ({k!r}); "
                    "use BasicVariantGenerator for grids")
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        # Fraction of suggestions drawn uniformly even after the model
        # kicks in: pure exploitation of a sparse KDE can fixate on a
        # boundary and starve the model of fresh observations.
        self.exploration = exploration
        self._rng = random.Random(seed)
        self._history: List[Any] = []  # (config, score) with score not None

    # ------------------------------------------------------------ feedback

    def on_trial_complete(self, config, score):
        if score is None:
            return
        self._history.append((config, float(score)))

    # ----------------------------------------------------------- suggestion

    def _model_history(self) -> List[Any]:
        """Observations the KDE models (subclasses pick a fidelity)."""
        return self._history

    def suggest(self) -> Dict[str, Any]:
        hist = self._model_history()
        if len(hist) < self.n_initial \
                or self._rng.random() < self.exploration:
            return {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                    for k, v in self.param_space.items()}
        ordered = sorted(hist, key=lambda cs: cs[1],
                         reverse=(self.mode == "max"))
        # At least two good points once possible: a single-point "good"
        # KDE gets bandwidth = the whole span and models nothing.
        n_good = max(2 if len(ordered) >= 4 else 1,
                     int(len(ordered) * self.gamma))
        good = [c for c, _ in ordered[:n_good]]
        bad = [c for c, _ in ordered[n_good:]] or good
        out: Dict[str, Any] = {}
        for k, dom in self.param_space.items():
            if not isinstance(dom, Domain):
                out[k] = dom
            elif isinstance(dom, Categorical):
                out[k] = self._suggest_categorical(k, dom, good)
            elif isinstance(dom, FunctionDomain):
                out[k] = dom.sample(self._rng)  # opaque: no model possible
            else:
                out[k] = self._suggest_numeric(k, dom, good, bad)
        return out

    def _suggest_categorical(self, key, dom: Categorical, good):
        counts = {c: 1.0 for c in dom.categories}  # +1 smoothing prior
        for cfg in good:
            if cfg.get(key) in counts:
                counts[cfg[key]] += 1.0
        total = sum(counts.values())
        r = self._rng.uniform(0, total)
        acc = 0.0
        for c, w in counts.items():
            acc += w
            if r <= acc:
                return c
        return dom.categories[-1]

    def _suggest_numeric(self, key, dom: Domain, good, bad):
        import math

        log_scale = isinstance(dom, LogUniform)

        def to_x(v):
            return math.log(v) if log_scale else float(v)

        lo, hi = to_x(dom.lower), to_x(dom.upper)
        span = hi - lo
        gx = [to_x(c[key]) for c in good if key in c]
        bx = [to_x(c[key]) for c in bad if key in c]
        if not gx:
            return dom.sample(self._rng)
        bw = max(span / max(len(gx), 1) ** 0.5, 1e-12)

        def density(x, pts):
            if not pts:
                return 1.0 / span
            return sum(math.exp(-0.5 * ((x - p) / bw) ** 2)
                       for p in pts) / (len(pts) * bw)

        best_x, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            center = self._rng.choice(gx)
            x = min(max(self._rng.gauss(center, bw), lo), hi)
            ratio = density(x, gx) / (density(x, bx) + 1e-12)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        v = math.exp(best_x) if log_scale else best_x
        if isinstance(dom, Randint):
            return min(max(int(round(v)), dom.lower), dom.upper - 1)
        if isinstance(dom, QUniform):
            return round(v / dom.q) * dom.q
        return v


class BOHBSearcher(TPESearcher):
    """BOHB's Bayesian half, self-contained (reference wraps the external
    `hpbandster` package via `tune/search/bohb/bohb_search.py`; that
    library isn't available here).

    Observations are kept per fidelity (the result's
    ``training_iteration``, fed through ``on_result``); the KDE models
    the LARGEST budget that has at least ``n_initial`` observations —
    BOHB's rule — so early low-fidelity scores guide sampling until
    enough full-budget results exist, then the model sharpens. Pair with
    ``HyperBandScheduler`` for the bracketed early stopping half
    (reference pairs TuneBOHB with HyperBandForBOHB).
    """

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: str = "min", n_initial: int = 6, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(param_space, metric, mode, n_initial=n_initial,
                         gamma=gamma, n_candidates=n_candidates, seed=seed)
        # budget -> {config key -> (config, score)}: one entry per
        # distinct config per budget, latest score wins — replayed
        # iterations (checkpoint restores, exploit restarts) must not
        # double-weight a config in the KDE or inflate a budget past
        # n_initial with duplicates.
        self._by_budget: Dict[int, Dict[str, Any]] = {}

    def on_result(self, config: Dict[str, Any], result: Dict[str, Any]):
        score = result.get(self.metric)
        if score is None:
            return
        budget = int(result.get("training_iteration", 1))
        key = repr(sorted(config.items(), key=lambda kv: kv[0]))
        self._by_budget.setdefault(budget, {})[key] = (
            dict(config), float(score))

    def _model_history(self) -> List[Any]:
        for budget in sorted(self._by_budget, reverse=True):
            obs = list(self._by_budget[budget].values())
            if len(obs) >= self.n_initial:
                return obs
        return self._history


class BasicVariantGenerator:
    """Expands grid_search cross products x num_samples; samples domains."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self._rng = random.Random(seed)

    def generate(self) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, GridSearch)]
        grid_values = [self.param_space[k].values for k in grid_keys]
        combos = list(itertools.product(*grid_values)) if grid_keys else [()]
        configs: List[Dict[str, Any]] = []
        for _ in range(self.num_samples):
            for combo in combos:
                cfg: Dict[str, Any] = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self._rng)
                    else:
                        cfg[k] = v
                configs.append(cfg)
        return configs
