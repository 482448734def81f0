"""The port's terminal dashboard (``irp_tpu_torch/cli/dashboard_cli.py``)
against the JAX package's: the ``study``, ``runs`` and ``run`` views
print the same text over a study and a tracking store that the JAX
package wrote, exit with the same codes and messages where there is
nothing to show, and leave both stores as they were."""

import contextlib
import hashlib
import os
import sqlite3
import time

import pytest

from irp_tpu import hyperopt as jax_hyperopt
from irp_tpu import tracking as jax_tracking
from irp_tpu.cli import dashboard_cli as jax_dashboard
from irp_tpu_torch import tracking
from irp_tpu_torch.cli import dashboard_cli


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A study of 7 trials (5 COMPLETE, one PRUNED, one FAILED) and a
    tracking store of 3 runs with params, metric histories, tags and
    artifacts, all written by the JAX package."""
    root = tmp_path_factory.mktemp("dashboard")
    db = str(root / "study.db")
    study = jax_hyperopt.create_study("dash", db,
                                      sampler=jax_hyperopt.RandomSampler(
                                          seed=0))
    for i in range(7):
        trial = study.ask()
        lr = trial.suggest_float("learning_rate", 1e-5, 1e-2, log=True)
        bs = trial.suggest_categorical("batch_size", [8, 16, 32])
        dr = trial.suggest_float("dropout_rate", 0.0, 0.5)
        if i == 3:
            trial.report(12.5, 0)
            study.tell(trial, "PRUNED")
        elif i == 5:
            study.tell(trial, "FAILED")
        else:
            study.tell(trial, "COMPLETE",
                       90.0 + 1000 * lr + bs / 8 - 4 * dr)
    uri = str(root / "mlruns")
    jax_tracking.set_tracking_uri(uri)
    jax_tracking.set_experiment("animals10")
    run_ids = []
    for r in range(3):
        with jax_tracking.start_run(
                run_name=f"optuna_trial_{r}_kfold") as run:
            run.log_params({"learning_rate": 10.0 ** -(r + 2),
                            "recommended_epochs": r + 2})
            for step in range(6):
                run.log_metrics({"epoch_avg_val_acc": 50.0 + 7 * step - r,
                                 "train_loss": 2.0 / (step + 1)}, step=step)
            run.log_text(f"run {r}\n", "notes/summary.txt")
            run.set_tags({"stage": "hyperopt"})
            run_ids.append(run.info.run_id)
        time.sleep(0.01)  # distinct start times: the runs view sorts on them
    return {"db": db, "uri": uri, "run_ids": run_ids, "root": str(root)}


def _digest(root):
    """Every tracking file's bytes and the study database's rows (its
    files' bytes move when SQLite folds its write-ahead log in)."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            if ".db" in name:
                if name.endswith(".db"):
                    with contextlib.closing(sqlite3.connect(path)) as con:
                        out[name] = list(con.iterdump())
                continue
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def _both(argv, stores, capsys):
    """(rc, stdout, stderr) of the JAX CLI and of the port's."""
    out = []
    for main, trk in ((jax_dashboard.main, jax_tracking),
                      (dashboard_cli.main, tracking)):
        trk.set_tracking_uri(stores["uri"])
        capsys.readouterr()
        rc = main(argv)
        printed = capsys.readouterr()
        out.append((rc, printed.out, printed.err))
    return out


@pytest.mark.parametrize("view", ["study", "runs", "run"])
def test_views_print_what_the_jax_cli_prints(stores, capsys, view):
    argv = {"study": ["study", "--storage", stores["db"], "--study-name",
                      "dash", "--top", "4"],
            "runs": ["runs", "--experiment", "animals10", "--limit", "2"],
            "run": ["run", stores["run_ids"][1]]}[view]
    before = _digest(stores["root"])
    want, got = _both(argv, stores, capsys)
    assert got == want
    assert got[0] == 0 and got[1]
    assert _digest(stores["root"]) == before  # read-only
    if view == "study":
        assert "trials: 7  complete: 5  pruned: 1  failed: 1" in got[1]
        assert "param importances:" in got[1]
    elif view == "runs":
        assert got[1].count("optuna_trial_") == 2
    else:
        assert "notes/summary.txt" in got[1]
        assert "epoch_avg_val_acc" in got[1]


@pytest.mark.parametrize("case", ["no_storage", "no_study", "no_experiment",
                                  "no_run"])
def test_nothing_to_show_exits_2_as_in_jax(stores, capsys, tmp_path, case):
    argv = {"no_storage": ["study", "--storage", str(tmp_path / "x.db")],
            "no_study": ["study", "--storage", stores["db"],
                         "--study-name", "typo"],
            "no_experiment": ["runs", "--experiment", "nothing"],
            "no_run": ["run", "0123456789abcdef"]}[case]
    before = _digest(stores["root"])
    want, got = _both(argv, stores, capsys)
    assert got == want and got[0] == 2 and got[2]
    assert _digest(stores["root"]) == before
    assert not os.path.exists(tmp_path / "x.db")
