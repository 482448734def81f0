"""The port's study engine against the JAX package's: distribution
strings, TPE proposals, pruner decisions and the SQLite study database,
each exact."""

import math

import numpy as np
import pytest

from irp_tpu import hyperopt as jh
from irp_tpu.hyperopt import distributions as jdist
from irp_tpu_torch import hyperopt as th
from irp_tpu_torch.hyperopt import distributions as tdist

PKGS = {"jax": jh, "torch": th}


@pytest.mark.parametrize("make", [
    lambda m: m.FloatDistribution(1e-5, 1e-2, log=True),
    lambda m: m.FloatDistribution(0.0, 0.5, step=0.1),
    lambda m: m.IntDistribution(3, 6),
    lambda m: m.IntDistribution(1, 64, log=True, step=1),
    lambda m: m.CategoricalDistribution([8, 16, 32]),
    lambda m: m.CategoricalDistribution(["low", "medium", "high"]),
])
def test_dump_distribution_strings_are_equal(make):
    got = tdist.dump_distribution(make(tdist))
    assert got == jdist.dump_distribution(make(jdist))
    assert jdist.load_distribution(got) == make(jdist)
    assert tdist.load_distribution(got) == make(tdist)


def _space(trial):
    return {
        "learning_rate": trial.suggest_float("learning_rate", 1e-5, 1e-2,
                                             log=True),
        "batch_size": trial.suggest_categorical("batch_size", [8, 16, 32]),
        "dropout_rate": trial.suggest_float("dropout_rate", 0.0, 0.5),
        "patience": trial.suggest_int("patience", 3, 6),
        "aug": trial.suggest_categorical("aug", ["low", "medium", "high"]),
    }


def _score(hp):
    """A deterministic function of the parameters alone."""
    return (-(math.log10(hp["learning_rate"]) + 3.2) ** 2
            - 4 * (hp["dropout_rate"] - 0.2) ** 2
            + 0.1 * hp["patience"] + {8: 0.0, 16: 0.3, 32: 0.1}[
                hp["batch_size"]] + {"low": 0, "medium": 0.2,
                                     "high": -0.1}[hp["aug"]])


def _tpe_params(pkg, seed):
    study = pkg.create_study("tpe", ":memory:",
                             sampler=pkg.TPESampler(seed=seed))
    study.optimize(lambda t: _score(_space(t)), n_trials=30)
    return [t.params for t in study.get_trials()], study.best_value


@pytest.mark.parametrize("seed", [0, 42])
def test_tpe_proposes_equal_parameters_for_30_trials(seed):
    got, best = _tpe_params(th, seed)
    want, jbest = _tpe_params(jh, seed)
    assert len(got) == 30 and got == want
    assert best == jbest


def _recorded_study(pkg, path, values):
    """A study holding the recorded trials: (state, value, intermediates
    by step) each."""
    study = pkg.create_study("rec", str(path))
    for state, value, inter in values:
        trial = study.ask()
        trial.suggest_float("x", 0.0, 1.0)
        for step, v in inter.items():
            trial.report(v, step)
        study.tell(trial, state, value)
    return study


RECORDED = [
    ("COMPLETE", 80.0, {0: 60.0, 1: 70.0, 2: 80.0, 3: 79.0}),
    ("COMPLETE", 70.0, {0: 50.0, 1: 65.0, 2: 70.0, 3: 69.0}),
    ("PRUNED", None, {0: 20.0, 1: 25.0}),
    ("COMPLETE", 90.0, {0: 75.0, 1: 85.0, 2: 88.0, 3: 90.0}),
    ("COMPLETE", 60.0, {0: 40.0, 1: 55.0, 2: 58.0}),
]
CANDIDATES = [
    {0: 10.0}, {0: 55.0}, {0: 80.0}, {0: 55.0, 1: 60.0},
    {0: 70.0, 1: 60.0}, {0: 30.0, 1: 40.0, 2: 71.0},
    {0: 30.0, 1: 40.0, 2: 50.0, 3: 60.0}, {0: 90.0, 1: 91.0, 2: 92.0},
]


@pytest.mark.parametrize("make_pruner,prunes", [
    (lambda m: m.MedianPruner(n_startup_trials=2, n_warmup_steps=0), True),
    (lambda m: m.MedianPruner(n_startup_trials=3, n_warmup_steps=1,
                              interval_steps=2), True),
    (lambda m: m.MedianPruner(n_startup_trials=9), False),
    (lambda m: m.SuccessiveHalvingPruner(min_resource=1,
                                         reduction_factor=2), True),
    (lambda m: m.SuccessiveHalvingPruner(min_resource=2,
                                         reduction_factor=3), True),
])
def test_pruners_decide_equally_on_recorded_intermediates(tmp_path,
                                                          make_pruner,
                                                          prunes):
    decisions = {}
    for name, pkg in PKGS.items():
        study = _recorded_study(pkg, tmp_path / f"{name}.db", RECORDED)
        study.pruner = make_pruner(pkg)
        out = []
        for inter in CANDIDATES:
            trial = study.ask()
            for step, v in inter.items():
                trial.report(v, step)
                out.append(trial.should_prune())
            study.tell(trial, "FAILED")
        decisions[name] = out
    assert decisions["torch"] == decisions["jax"]
    assert any(decisions["torch"]) == prunes
    assert not all(decisions["torch"])


def _trial_view(t, dist_mod):
    return (t.number, t.state, t.value, t.params,
            {k: dist_mod.dump_distribution(v) for k, v in
             t.distributions.items()},
            t.intermediate_values, t.user_attrs)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_study_database_resumes_in_the_other_package(tmp_path, writer):
    reader = "torch" if writer == "jax" else "jax"
    db = str(tmp_path / "study.db")
    w = PKGS[writer].create_study("shared", f"sqlite:///{db}",
                                  sampler=PKGS[writer].TPESampler(seed=1))
    w.optimize(lambda t: _score(_space(t)), n_trials=3)
    trial = w.ask()  # left RUNNING: an orphan of a dead process
    trial.report(12.5, 0)
    trial.set_user_attr("tracking_run_id", "abc")
    dists = {"jax": jdist, "torch": tdist}
    written = [_trial_view(t, dists[writer]) for t in w.get_trials()]
    w.storage.close()

    r = PKGS[reader].create_study("shared", db,
                                  sampler=PKGS[reader].TPESampler(seed=1))
    loaded = [_trial_view(t, dists[reader]) for t in r.get_trials()]
    assert loaded[:3] == written[:3]
    assert loaded[3][1] == "FAILED"  # the orphan, failed on load
    assert loaded[3][5] == {0: 12.5} and loaded[3][6] == {
        "tracking_run_id": "abc"}
    r.optimize(lambda t: _score(_space(t)), n_trials=1)
    assert r.best_value == max(v[2] for v in written[:3] + [
        _trial_view(r.get_trials()[4], dists[reader])])
    r.storage.close()

    back = PKGS[writer].create_study("shared", db)
    assert [t.number for t in back.get_trials()] == [0, 1, 2, 3, 4]
    assert np.isfinite(back.get_trials()[4].value)
