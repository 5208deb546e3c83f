"""The port's Tune (`ray_tpu_torch.tune`) on the CPU.

Three parts. The searchers and schedulers are host code with the
reference's random streams, so for seeds 0-2 they are held equal to the JAX
package's `ray_tpu.tune` on the same inputs: the variant generator over
every domain, ASHA, the median rule and HyperBand on one seeded stream of
results, PBT's exploit and perturb, PB2's GP (to 1e-12) and perturb, and
TPE's and BOHB's suggestions after the same completed trials. Then the 18
cases of tests/test_tune.py and test_tune_search_adv.py, each under the
name of the reference test it mirrors, through `Tuner` on one
module-scoped port runtime; where the reference marks a case slow (its
trials through the 50 ms controller poll loop), the port keeps its
property at fewer trials or steps. Last, what the port adds: a stopped
trial leaves no live worker of its trainer, a GPU trainer's device check
runs in its worker and not in the trial actor, and RLlib's PPO and IMPALA
trainables run through `Tuner`.

The runtime advertises one GPU, which without a card is a grant only: a
GPU trainer's worker is granted it and then finds no CUDA.
"""

import functools
import os
import random

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import (Checkpoint, RunConfig, ScalingConfig,
                                 TorchTrainer)
from ray_tpu_torch.tune.trial import Trial

SEEDS = [0, 1, 2]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's Tune, imported here rather than at module level:
    trial actors import this module for its trainables, and need none of
    it."""
    from types import SimpleNamespace

    from ray_tpu import tune
    from ray_tpu.tune import schedulers, search
    from ray_tpu.tune.trial import Trial as RefTrial

    return SimpleNamespace(tune=tune, sched=schedulers, search=search,
                           Trial=RefTrial)


def _one_report(config):
    tune.report({"loss": 0.0})


@pytest.fixture(scope="module", autouse=True)
def runtime(tmp_path_factory):
    # Workers fork from a template that preimports torch (TorchTrainer and
    # RLlib trials).
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, _system_config={
        "worker_forge_preimports": "ray_tpu_torch.core.worker,numpy,torch"})
    # The session's first trial actor takes seconds longer to start than
    # the next ones: pay that here, not in the first test.
    tune.Tuner(_one_report, run_config=RunConfig(
        name="warm", storage_path=str(tmp_path_factory.mktemp("warm")))).fit()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ray_tpu_torch.shutdown()


def _run(name, tmp_path, **kw):
    return RunConfig(name=name, storage_path=str(tmp_path), **kw)


# --------------------------------------------------------------------------- #
# Parity with the JAX package, seeds 0-2
# --------------------------------------------------------------------------- #


def _space(t):
    """Every domain of module `t` (the port's tune or the reference's)."""
    return {"g": t.grid_search([1, 2, 3]), "h": t.grid_search(["a", "b"]),
            "c": t.choice([10, 20, 30]), "u": t.uniform(-1.0, 2.0),
            "lu": t.loguniform(1e-5, 1e-1), "ri": t.randint(3, 9),
            "q": t.quniform(0.0, 5.0, 0.25), "f": t.sample_from(lambda: 7),
            "k": "fixed"}


@pytest.mark.parametrize("seed", SEEDS)
def test_variant_generator_matches_reference(ref, seed):
    got = tune.BasicVariantGenerator(_space(tune), num_samples=3,
                                     seed=seed).generate()
    want = ref.search.BasicVariantGenerator(_space(ref.tune), num_samples=3,
                                            seed=seed).generate()
    assert len(got) == 18 and got == want


def _result_stream(seed, n_trials=8, steps=12):
    """(trial index, step, loss) in a seeded interleaving: each trial's
    steps in order, the trials' turns drawn from the seed."""
    rng = random.Random(seed)
    level = [rng.uniform(0.5, 5.0) for _ in range(n_trials)]
    nxt = [1] * n_trials
    out = []
    while any(s <= steps for s in nxt):
        i = rng.choice([j for j in range(n_trials) if nxt[j] <= steps])
        out.append((i, nxt[i],
                    level[i] * (1 + 1 / nxt[i]) + rng.uniform(0, 0.3)))
        nxt[i] += 1
    return out


def _decisions(sched, trial_cls, stream, metric="loss"):
    """Feed `stream` as the controller does (a stopped trial sends no more
    results); returns every (trial, step, decision)."""
    trials = {}
    stopped = set()
    out = []
    for i, step, value in stream:
        if i in stopped:
            continue
        trial = trials.setdefault(i, trial_cls(config={"i": i},
                                               trial_id=f"t{i}"))
        trial.num_results += 1
        result = {metric: value, "training_iteration": step}
        d = sched.on_trial_result(trial, result)
        trial.last_result.update(result)
        out.append((i, step, d))
        if d == "STOP":
            stopped.add(i)
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ["asha", "median", "hyperband"])
def test_schedulers_match_reference(ref, seed, which):
    def make(mod):
        if which == "asha":
            return mod.ASHAScheduler(metric="loss", mode="min", max_t=10,
                                     grace_period=1, reduction_factor=2)
        if which == "median":
            return mod.MedianStoppingRule(metric="loss", mode="min",
                                          grace_period=2,
                                          min_samples_required=2)
        return mod.HyperBandScheduler(metric="loss", mode="min", max_t=9,
                                      reduction_factor=3)

    from ray_tpu_torch.tune import schedulers as port_sched

    stream = _result_stream(seed)
    got = _decisions(make(port_sched), Trial, stream)
    want = _decisions(make(ref.sched), ref.Trial, stream)
    assert got == want
    assert any(d == "STOP" for _, _, d in got)


def _pbt_run(mod, trial_cls, seed, pb2):
    """A population through PBT (or PB2) as the controller drives it:
    EXPLOIT adopts the target's config, perturbed. Returns the log of
    decisions, exploit targets and new configs."""
    if pb2:
        sched = mod.PB2(metric="score", mode="max", perturbation_interval=2,
                        hyperparam_bounds={"lr": (0.0, 1.0)}, seed=seed)
    else:
        sched = mod.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": [0.1, 0.5, 1.0], "wd": None,
                                  "m": mod.uniform(0.5, 2.0)},
            quantile_fraction=0.25, seed=seed)
    rng = random.Random(seed + 100)
    trials = [trial_cls(config={"lr": rng.random(), "wd": 0.01, "m": 1.0},
                        trial_id=f"t{i}") for i in range(6)]
    score = {t.trial_id: 0.0 for t in trials}
    log = []
    for step in range(1, 9):
        for t in trials:
            score[t.trial_id] += t.config["lr"] + rng.uniform(0, 0.1)
            t.num_results += 1
            result = {"score": score[t.trial_id]}
            t.last_result.update(result)
            d = sched.on_trial_result(t, result)
            log.append((t.trial_id, step, d))
            if d == "EXPLOIT":
                target = sched.exploit_target(t)
                log.append(("target", target.trial_id if target else None))
                if target is not None:
                    t.config = sched.perturb(target.config)
                    log.append(("config", dict(t.config)))
    return log


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pb2", [False, True], ids=["pbt", "pb2"])
def test_pbt_and_pb2_exploit_and_perturb_match_reference(ref, seed, pb2):
    got = _pbt_run(tune, Trial, seed, pb2)
    want = _pbt_run(ref.tune, ref.Trial, seed, pb2)
    assert got == want
    assert any(entry[0] == "config" for entry in got)


@pytest.mark.parametrize("seed", SEEDS)
def test_pb2_gp_matches_reference(ref, seed):
    from ray_tpu_torch.tune.schedulers import _GP

    rng = np.random.default_rng(seed)
    X = rng.random((25, 3))
    y = np.sin(3 * X[:, 0]) + X[:, 1] * X[:, 2]
    Xs = rng.random((40, 3)) * 1.5
    mu, sd = _GP(lengthscale=0.3).fit(X, y).predict(Xs)
    ref_mu, ref_sd = ref.sched._GP(lengthscale=0.3).fit(X, y).predict(Xs)
    np.testing.assert_allclose(mu, ref_mu, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sd, ref_sd, rtol=0, atol=1e-12)


def _searcher_history(seed):
    rng = random.Random(seed)
    out = []
    for _ in range(14):
        cfg = {"x": rng.uniform(0, 1), "lr": 10 ** rng.uniform(-4, -1),
               "c": rng.choice(["a", "b", "c"]), "n": rng.randrange(2, 9)}
        loss = (cfg["x"] - 0.3) ** 2 + abs(np.log10(cfg["lr"]) + 2.5) * 0.1
        out.append((cfg, loss, rng.choice([1, 2, 4])))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ["tpe", "bohb"])
def test_tpe_and_bohb_suggestions_match_reference(ref, seed, which):
    def make(mod, t):
        space = {"x": t.uniform(0.0, 1.0), "lr": t.loguniform(1e-4, 1e-1),
                 "c": t.choice(["a", "b", "c"]), "n": t.randint(2, 9),
                 "q": t.quniform(0.0, 1.0, 0.1), "k": 3}
        cls = mod.TPESearcher if which == "tpe" else mod.BOHBSearcher
        return cls(space, metric="loss", mode="min", n_initial=4, seed=seed)

    from ray_tpu_torch.tune import search as port_search

    searchers = [make(port_search, tune), make(ref.search, ref.tune)]
    suggestions = [[], []]
    for cfg, loss, budget in _searcher_history(seed):
        for s, out in zip(searchers, suggestions):
            if which == "bohb":
                s.on_result(cfg, {"loss": loss, "training_iteration": budget})
            s.on_trial_complete(cfg, loss)
            out.append(s.suggest())
    assert suggestions[0] == suggestions[1]


# --------------------------------------------------------------------------- #
# tests/test_tune.py
# --------------------------------------------------------------------------- #


def test_variant_generator_grid_and_samples():
    from ray_tpu_torch.tune.search import BasicVariantGenerator

    configs = BasicVariantGenerator(
        {"a": tune.grid_search([1, 2, 3]), "b": tune.choice([10]),
         "c": "fixed"},
        num_samples=2, seed=0).generate()
    assert len(configs) == 6
    assert {c["a"] for c in configs} == {1, 2, 3}
    assert all(c["b"] == 10 and c["c"] == "fixed" for c in configs)


def test_domains_sample_in_range():
    rng = random.Random(0)
    for _ in range(20):
        assert 1e-4 <= tune.loguniform(1e-4, 1e-1).sample(rng) <= 1e-1
        assert 0 <= tune.uniform(0, 5).sample(rng) <= 5
        assert tune.randint(3, 7).sample(rng) in (3, 4, 5, 6)


def test_asha_stops_bad_trials_unit():
    from ray_tpu_torch.tune.schedulers import ASHAScheduler

    sched = ASHAScheduler(metric="loss", mode="min", max_t=16,
                          grace_period=2, reduction_factor=2)
    good, bad = Trial(config={}), Trial(config={})
    decisions = []
    for t in range(1, 17):
        for trial, loss in ((good, 0.1 / t), (bad, 5.0)):
            trial.num_results += 1
            d = sched.on_trial_result(trial, {"loss": loss,
                                              "training_iteration": t})
            decisions.append((trial is bad, t, d))
    bad_stopped = any(is_bad and d == "STOP" for is_bad, _, d in decisions)
    good_stopped = any((not is_bad) and d == "STOP" and t < 16
                       for is_bad, t, d in decisions)
    assert bad_stopped and not good_stopped


def _trainable(config):
    for step in range(1, config.get("steps", 8) + 1):
        loss = config["lr"] * 100 + 1.0 / step
        tune.report({"loss": loss, "training_iteration": step})


def test_tuner_fit_random_search(tmp_path):
    tuner = tune.Tuner(
        _trainable,
        param_space={"lr": tune.grid_search([0.001, 0.1]), "steps": 3},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=_run("grid", tmp_path),
    )
    results = tuner.fit()
    assert len(results) == 2
    assert not results.errors
    best = results.get_best_result()
    assert best.config["lr"] == 0.001
    pd = pytest.importorskip("pandas")
    df = results.get_dataframe()
    assert isinstance(df, pd.DataFrame)
    assert "config/lr" in df.columns and len(df) == 2


def test_tuner_asha_10_trials(tmp_path):
    # The reference runs 10 trials of 8 steps (slow); 6 of 6 keep its
    # property: ASHA stops at least one trial early.
    tuner = tune.Tuner(
        _trainable,
        param_space={"lr": tune.loguniform(1e-4, 1e0), "steps": 6},
        tune_config=tune.TuneConfig(
            num_samples=6, metric="loss", mode="min", seed=42,
            scheduler=tune.ASHAScheduler(metric="loss", mode="min",
                                         max_t=6, grace_period=2,
                                         reduction_factor=2)),
        run_config=_run("asha", tmp_path),
    )
    results = tuner.fit()
    assert len(results) == 6
    assert not results.errors
    iters = [len(r.metrics_history) for r in results]
    assert min(iters) < max(iters)
    best = results.get_best_result()
    assert best.metrics["loss"] == min(r.metrics["loss"] for r in results
                                       if "loss" in r.metrics)


def _ckpt_trainable(config):
    start = 0
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"] + 1
    for step in range(start, 4):
        tune.report({"loss": 1.0 / (step + 1), "step": step},
                    checkpoint=Checkpoint.from_dict({"step": step}))


def test_tuner_checkpoint_and_restore(tmp_path):
    exp = str(tmp_path / "resume_exp")
    tuner = tune.Tuner(_ckpt_trainable,
                       param_space={"x": tune.grid_search([1, 2])},
                       tune_config=tune.TuneConfig(metric="loss", mode="min"),
                       run_config=_run("resume_exp", tmp_path))
    results = tuner.fit()
    assert not results.errors
    assert tune.Tuner.can_restore(exp)

    # Restore: finished trials stay finished; no errors on refit.
    restored = tune.Tuner.restore(exp, _ckpt_trainable)
    results2 = restored.fit()
    assert len(results2) == 2
    assert not results2.errors
    for r in results2:
        assert r.checkpoint is not None
        assert r.checkpoint.to_dict()["step"] == 3


def _lr_loop(config):
    from ray_tpu_torch.train import session

    session.report({"loss": config.get("lr", 1.0)})


def test_trainer_as_trainable_through_tuner(tmp_path):
    """Train -> Tune: a TorchTrainer's workers on the CPU through a grid."""
    trainer = TorchTrainer(
        _lr_loop, device="cpu",
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="tt", storage_path=str(tmp_path / "inner")),
    )
    tuner = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([0.3, 0.7])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=_run("tt_exp", tmp_path),
    )
    results = tuner.fit()
    assert not results.errors, results.errors
    assert results.get_best_result().config["lr"] == 0.3
    # The worker's report reached the trial as it came, and once.
    assert [len(r.metrics_history) for r in results] == [1, 1]


def _pbt_trainable(config):
    ckpt = tune.get_checkpoint()
    score = ckpt.to_dict()["score"] if ckpt else 0.0
    for _ in range(4):
        score += config["rate"]
        tune.report({"score": score},
                    checkpoint=Checkpoint.from_dict({"score": score}))


def test_pbt_exploits(tmp_path):
    # The reference's 4 trials of 8 steps, here of 4.
    sched = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"rate": [0.1, 1.0]}, seed=0)
    results = tune.Tuner(
        _pbt_trainable,
        param_space={"rate": tune.grid_search([0.1, 0.1, 1.0, 1.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched),
        run_config=_run("pbt", tmp_path),
    ).fit()
    assert not results.errors, results.errors
    best = results.get_best_result()
    assert best.metrics["score"] > 0


def _level_trainable(config):
    for step in range(8):
        tune.report({"score": config["level"] + step * 0.01})


def test_median_stopping_rule_stops_laggard(tmp_path):
    """Trials well under the field's median stop early (reference
    median_stopping_rule.py; its 12 steps here 8)."""
    tuner = tune.Tuner(
        _level_trainable,
        param_space={"level": tune.grid_search([0.0, 0.0, 10.0, 10.0,
                                                10.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.MedianStoppingRule(
                metric="score", mode="max", grace_period=2,
                min_samples_required=2)),
        run_config=tune.RunConfig(name="median", storage_path=str(tmp_path)),
    )
    results = tuner.fit()
    by_level = {}
    for r in results:
        by_level.setdefault(r.config["level"], []).append(
            r.metrics.get("training_iteration", 0))
    # The high-level trials run to completion; low-level ones cut early.
    assert max(by_level[10.0]) == 8
    assert min(by_level[0.0]) < 8


def _quality_trainable(config):
    for step in range(4):
        tune.report({"loss": config["quality"] / (step + 1)})


def test_hyperband_scheduler_halves(tmp_path):
    """HyperBand brackets cut under-performers at their milestones while
    the best survive to max_t. The reference runs 8 trials of 9 steps
    (max_t 9, factor 3) through the poll loop (slow); here 4 of 4 (max_t
    4, factor 2), one at a time, so that brackets are dealt in grid order:
    the worst is the second of the first bracket, which cuts from rung
    1."""
    tuner = tune.Tuner(
        _quality_trainable,
        param_space={"quality": tune.grid_search([1.0, 2.0, 4.0, 128.0])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.HyperBandScheduler(
                metric="loss", mode="min", max_t=4, reduction_factor=2)),
        run_config=tune.RunConfig(name="hb", storage_path=str(tmp_path)),
    )
    results = tuner.fit()
    iters = {r.config["quality"]: r.metrics.get("training_iteration", 0)
             for r in results}
    # The best config survives to the end; the worst is cut before max_t.
    assert iters[1.0] == 4
    assert iters[128.0] < 4
    best = results.get_best_result()
    assert best.config["quality"] == 1.0


# --------------------------------------------------------------------------- #
# tests/test_tune_search_adv.py
# --------------------------------------------------------------------------- #


def test_gp_fits_and_predicts():
    from ray_tpu_torch.tune.schedulers import _GP

    rng = np.random.default_rng(0)
    X = rng.random((30, 2))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1]
    gp = _GP(lengthscale=0.3).fit(X, y)
    mu, sd = gp.predict(X)
    # Interpolates training points closely, with small uncertainty there.
    assert float(np.abs(mu - y).mean()) < 0.05
    far = np.full((1, 2), 5.0)
    _, sd_far = gp.predict(far)
    assert sd_far[0] > sd.mean()  # uncertainty grows away from data


def test_pb2_perturb_respects_bounds_and_uses_gp():
    from ray_tpu_torch.tune.schedulers import PB2

    pb2 = PB2(metric="score", mode="max", perturbation_interval=1,
              hyperparam_bounds={"lr": (0.0, 1.0)}, seed=0)
    # Feed interval deltas: reward improves in proportion to lr (the GP
    # should steer suggestions toward high lr).
    trials = [Trial(config={"lr": v}) for v in
              (0.05, 0.2, 0.4, 0.6, 0.8, 0.95)]
    for step in range(1, 5):
        for t in trials:
            t.num_results += 1
            score = step * t.config["lr"]  # higher lr -> faster growth
            pb2.on_trial_result(t, {"score": score})
    assert len(pb2._data) >= 4
    suggestions = [pb2.perturb({"lr": 0.5})["lr"] for _ in range(5)]
    assert all(0.0 <= s <= 1.0 for s in suggestions)
    assert np.mean(suggestions) > 0.6, (
        f"GP-UCB should prefer high lr, got {suggestions}")


def test_pb2_requires_bounds():
    from ray_tpu_torch.tune.schedulers import PB2

    with pytest.raises(ValueError, match="hyperparam_bounds"):
        PB2(metric="score", mode="max")


def test_pb2_cold_start_uniform():
    from ray_tpu_torch.tune.schedulers import PB2

    pb2 = PB2(metric="score", mode="max",
              hyperparam_bounds={"lr": (0.1, 0.2)}, seed=1)
    for _ in range(10):
        v = pb2.perturb({"lr": 0.15})["lr"]
        assert 0.1 <= v <= 0.2


def test_bohb_models_largest_informative_budget():
    from ray_tpu_torch.tune.search import BOHBSearcher

    s = BOHBSearcher({"x": tune.uniform(0, 1)}, metric="loss", mode="min",
                     n_initial=3, seed=0)
    # 5 observations at budget 1, only 2 at budget 4 -> model budget 1.
    for i in range(5):
        s.on_result({"x": i / 5}, {"loss": i, "training_iteration": 1})
    for i in range(2):
        s.on_result({"x": i / 2}, {"loss": i, "training_iteration": 4})
    assert s._model_history() == list(s._by_budget[1].values())
    # Replaying an iteration must not duplicate (restore/exploit replay).
    s.on_result({"x": 0.0}, {"loss": 5.0, "training_iteration": 4})
    assert len(s._by_budget[4]) == 2
    assert dict(s._by_budget[4])[repr(sorted({"x": 0.0}.items()))][1] == 5.0
    # Third DISTINCT budget-4 observation flips to the higher fidelity.
    s.on_result({"x": 0.9}, {"loss": 0.1, "training_iteration": 4})
    assert s._model_history() == list(s._by_budget[4].values())


def test_bohb_converges_on_quadratic():
    """After seeding, suggestions should concentrate near the optimum of
    a 1-d quadratic (score = (x - 0.7)^2, minimized)."""
    from ray_tpu_torch.tune.search import BOHBSearcher

    s = BOHBSearcher({"x": tune.uniform(0, 1)}, metric="loss", mode="min",
                     n_initial=6, seed=3)
    for _ in range(30):
        cfg = s.suggest()
        loss = (cfg["x"] - 0.7) ** 2
        s.on_result(cfg, {"loss": loss, "training_iteration": 1})
        s.on_trial_complete(cfg, loss)
    tail = [s.suggest()["x"] for _ in range(10)]
    assert abs(float(np.median(tail)) - 0.7) < 0.2, tail


def _bohb_trainable(config):
    for step in range(1, 5):
        loss = (config["lr"] - 0.3) ** 2 + 0.1 / step
        tune.report({"loss": loss, "training_iteration": step})


def test_bohb_with_hyperband_tuner(tmp_path):
    """BOHB proposes, HyperBand prunes, the best configs cluster near the
    optimum (the reference's 12 samples, here 8)."""
    from ray_tpu_torch.tune.schedulers import HyperBandScheduler

    searcher = tune.BOHBSearcher({"lr": tune.uniform(0.0, 1.0)},
                                 metric="loss", mode="min", n_initial=4,
                                 seed=0)
    tuner = tune.Tuner(
        _bohb_trainable,
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=8,
            search_alg=searcher,
            scheduler=HyperBandScheduler(metric="loss", mode="min",
                                         max_t=4)),
        run_config=_run("bohb", tmp_path),
    )
    results = tuner.fit()
    assert not results.errors
    assert len(results) == 8
    best = results.get_best_result()
    assert abs(best.config["lr"] - 0.3) < 0.25


def _pb2_trainable(config):
    lr = config["lr"]
    for step in range(1, 9):
        loss = (lr - 0.6) ** 2 + 1.0 / (step + 1)
        tune.report({"loss": loss, "training_iteration": step})


def test_pb2_with_tuner(tmp_path):
    """PB2 end-to-end: exploit/explore cycles run, mutated lrs stay in
    bounds, and the run finds a low loss."""
    tuner = tune.Tuner(
        _pb2_trainable,
        param_space={"lr": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=4,
            scheduler=tune.PB2(metric="loss", mode="min",
                               perturbation_interval=2,
                               hyperparam_bounds={"lr": (0.0, 1.0)},
                               seed=0)),
        run_config=_run("pb2", tmp_path),
    )
    results = tuner.fit()
    assert not results.errors
    best = results.get_best_result()
    assert best.metrics["loss"] < 0.5
    for r in results:
        assert 0.0 <= r.config["lr"] <= 1.0


# --------------------------------------------------------------------------- #
# What the port adds
# --------------------------------------------------------------------------- #


def test_tune_and_collective_import_no_torch_jax_or_ray_tpu():
    """Tune and the host collective plane are host code: no file of
    `tune/` or `collective/` imports torch, jax or the JAX package, and
    importing both loads none of them."""
    import ast
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ray_tpu_torch")
    files = [os.path.join(root, d, f) for d in ("tune", "collective")
             for f in sorted(os.listdir(os.path.join(root, d)))
             if f.endswith(".py")]
    files.append(os.path.join(root, "util", "collective.py"))
    assert len(files) == 9
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("torch", "jax",
                                                  "ray_tpu"), (path, name)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, ray_tpu_torch.tune, ray_tpu_torch.collective, "
         "ray_tpu_torch.util.collective; print(sorted(m for m in "
         "('torch', 'jax', 'ray_tpu') if m in sys.modules))"],
        capture_output=True, text=True, check=True,
        cwd=os.path.dirname(root))
    assert out.stdout.strip() == "[]", out


def _exited(pid):
    from ray_tpu_torch.train.worker_group import process_exited

    return process_exited(pid)


def _forever_loop(config):
    """Reports until the trial is stopped. At its start it records which
    workers of earlier trials are still alive."""
    import time

    from ray_tpu_torch.train import session

    pids_file = config["pids_file"]
    earlier = []
    if os.path.exists(pids_file):
        with open(pids_file) as f:
            earlier = [int(x) for x in f.read().split()]
    alive = [p for p in earlier if not _exited(p)]
    with open(pids_file, "a") as f:
        f.write(f"{os.getpid()}\n")
    step = 0
    while True:
        step += 1
        session.report({"loss": config["lr"] + 1.0 / step,
                        "pid": os.getpid(), "earlier_alive": alive})
        time.sleep(0.01)  # paces the reports; the trial ends by a stop


def test_stopped_trial_leaves_no_worker_of_its_trainer(tmp_path):
    """Every trial here ends by a scheduler's STOP (ASHA's rungs, or
    max_t) while its worker still loops: each stopped trial's worker has
    exited before the next trial's worker starts, and none is alive
    after the sweep."""
    trainer = TorchTrainer(
        _forever_loop, device="cpu",
        train_loop_config={"pids_file": str(tmp_path / "pids")},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="inner", storage_path=str(tmp_path)))
    results = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([0.1, 2.0, 0.2])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(metric="loss", mode="min", max_t=4,
                                         grace_period=2,
                                         reduction_factor=2)),
        run_config=_run("stopped", tmp_path)).fit()
    assert not results.errors, results.errors
    steps = [len(r.metrics_history) for r in results]
    assert steps[0] == 4 and min(steps) == 2, steps   # max_t and a rung
    pids = [r.metrics["pid"] for r in results]
    assert len(set(pids)) == 3
    for r in results:
        assert r.metrics["earlier_alive"] == [], r.metrics
    assert all(_exited(p) for p in pids)


def test_worker_group_shutdown_raises_while_a_worker_lives(monkeypatch):
    """`wait_exited` returns the pids still alive at its timeout, and
    `WorkerGroup.shutdown` raises naming them, so no caller takes a card
    that a live worker process still holds."""
    import socket
    import subprocess
    import sys

    from ray_tpu_torch.train import worker_group

    host = socket.gethostname()
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        live = [{"hostname": host, "pid": proc.pid}]
        assert worker_group.wait_exited(live, timeout=0.2) == [proc.pid]
        elsewhere = [{"hostname": host + "-other", "pid": proc.pid}]
        assert worker_group.wait_exited(elsewhere, timeout=0.2) == []
        group = worker_group.WorkerGroup(num_workers=1)
        group.procs = live
        monkeypatch.setattr(group, "_abort_gang", lambda: None)
        monkeypatch.setattr(
            worker_group, "wait_exited",
            functools.partial(worker_group.wait_exited, timeout=0.2))
        with pytest.raises(RuntimeError, match=str(proc.pid)):
            group.shutdown()
    finally:
        proc.kill()
        proc.wait()
    assert worker_group.wait_exited(live, timeout=5) == []


def _card_loop(config):
    from ray_tpu_torch.train import session

    session.report({"loss": 1.0, "device": str(session.get_device())})


def test_gpu_trainable_checks_the_card_in_its_worker(tmp_path):
    """A TorchTrainer on the card, run as a trial: the trial actor (a CPU
    actor, which sees no card) asks nothing of CUDA; the worker granted
    the runtime's GPU is where the check runs, and without a card it
    fails there, naming itself."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour where CUDA is absent")
    trainer = TorchTrainer(
        _card_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="card", storage_path=str(tmp_path)))
    trainable = trainer.as_trainable()
    assert trainable.tune_gpus == 1
    results = tune.Tuner(
        trainable, param_space={"lr": tune.grid_search([0.1])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=_run("card_exp", tmp_path)).fit()
    assert len(results.errors) == 1
    for err in results.errors:
        err = err.replace("\\'", "'")  # the error's repr escapes quotes
        assert "train worker rank 0" in err, err
        assert "CUDA_VISIBLE_DEVICES='0'" in err, err
        assert "CUDA is not available" in err, err


def _rl_sweep(trainable, tmp_path, name):
    return tune.Tuner(
        trainable, param_space={"lr": tune.grid_search([1e-3])},
        tune_config=tune.TuneConfig(metric="episode_reward_mean",
                                    mode="max"),
        run_config=_run(name, tmp_path,
                        stop={"training_iteration": 2})).fit()


@pytest.mark.parametrize("name", ["ppo", "impala"])
def test_ppo_and_impala_as_trainable(tmp_path, name):
    from ray_tpu_torch.rllib import IMPALA, PPO, IMPALAConfig, PPOConfig

    small = dict(num_rollout_workers=1, num_envs_per_worker=4,
                 rollout_fragment_length=32, hidden=(16, 16), device="cpu")
    if name == "ppo":
        trainable = PPO.as_trainable(PPOConfig(
            num_sgd_iter=1, sgd_minibatch_size=64, lambda_=0.9, **small))
    else:
        trainable = IMPALA.as_trainable(IMPALAConfig(
            fragments_per_batch=1, replay_fragments=1,
            updates_per_iteration=2, **small))
    results = _rl_sweep(trainable, tmp_path, name)
    assert not results.errors, results.errors
    (r,) = list(results)
    assert r.config == {"lr": 1e-3}
    assert [m["training_iteration"] for m in r.metrics_history] == [1, 2]
    assert all(np.isfinite(m["total_loss"]) for m in r.metrics_history)
