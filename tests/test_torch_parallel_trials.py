"""Concurrent trials (``irp_tpu_torch/hyperopt/parallel.py``, the runner's
``parallel_workers`` and ``hyperopt_cli --parallel-workers``) on
``[cpu, cpu]``, porting tests/test_parallel_trials.py: every trial told,
failures FAILED, every ``ask``/``tell`` failure caught as in the JAX
package, and the k-fold runner's pools freed; a real ResNet18/56 sweep
on two workers, and the CLI's flag.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from irp_tpu.hyperopt import RandomSampler as JaxRandomSampler
from irp_tpu.hyperopt import create_study as jax_create_study
from irp_tpu.hyperopt.parallel import \
    run_parallel_trials as jax_run_parallel_trials
from irp_tpu_torch import tracking
from irp_tpu_torch.cli import hyperopt_cli
from irp_tpu_torch.config import HyperoptConfig, ModelConfig
from irp_tpu_torch.data.analyze import analyze_webdataset
from irp_tpu_torch.data.pipeline import build_cache
from irp_tpu_torch.hyperopt import objective, runner
from irp_tpu_torch.hyperopt.parallel import run_parallel_trials
from irp_tpu_torch.hyperopt.samplers import RandomSampler
from irp_tpu_torch.hyperopt.study import TrialPruned, create_study
from tests.synth import make_synthetic_shards

torch.set_num_threads(1)
CPU2 = ["cpu", "cpu"]
SIZE = 64


def test_parallel_trials_across_workers(tmp_path):
    """2 workers on [cpu, cpu]: all 12 trials complete, both workers ran
    trials, each on its own one-device mesh."""
    study = create_study("par", str(tmp_path / "p.db"),
                         sampler=RandomSampler(0))
    seen, lock = {}, threading.Lock()

    def objective_fn(trial, mesh):
        x = trial.suggest_float("x", -5, 5)
        with lock:
            seen[threading.get_ident()] = mesh
        time.sleep(0.02)  # let the other worker take trials too
        val = torch.tensor(x, device=mesh.device)
        return float(-(val - 1.0) ** 2)

    run_parallel_trials(study, objective_fn, n_trials=12, max_workers=4,
                        devices=CPU2)
    trials = study.get_trials()
    assert len(trials) == 12
    assert all(t.state == "COMPLETE" for t in trials)
    assert len(seen) == 2  # two workers: one per device of the list
    assert all(m.size == 1 and not m.is_process for m in seen.values())
    assert study.best_value <= 0.0


def test_parallel_trials_handle_failures_as_jax(tmp_path):
    """Odd trials raise, as in the JAX package's test: 3 FAILED and 3
    COMPLETE in both packages; a pruned trial is PRUNED and a NaN is
    FAILED."""
    def objective_fn(trial, mesh):
        trial.suggest_float("x", 0, 1)
        if trial.number % 2 == 0:
            raise RuntimeError("boom")
        return 1.0

    study = create_study("parf", str(tmp_path / "pf.db"),
                         sampler=RandomSampler(0))
    run_parallel_trials(study, objective_fn, n_trials=6, max_workers=2,
                        devices=CPU2)
    jstudy = jax_create_study("parf", str(tmp_path / "jpf.db"),
                              sampler=JaxRandomSampler(0))
    jax_run_parallel_trials(jstudy, objective_fn, n_trials=6,
                            max_workers=2)
    for s in (study, jstudy):
        states = sorted(t.state for t in s.get_trials())
        assert states.count("FAILED") == 3 and states.count("COMPLETE") == 3

    def pruned_or_nan(trial, mesh):
        if trial.number == 0:
            raise TrialPruned("low")
        return float("nan")

    study = create_study("parp", str(tmp_path / "pp.db"),
                         sampler=RandomSampler(0))
    run_parallel_trials(study, pruned_or_nan, n_trials=2, max_workers=1,
                        devices=CPU2)
    assert [t.state for t in study.get_trials()] == ["PRUNED", "FAILED"]


def test_ask_and_tell_failures_are_caught(tmp_path, capsys):
    """A failed ask spends its trial of the budget and the worker goes
    on; a failed tell leaves its trial RUNNING (an orphan), as in the
    JAX package."""
    study = create_study("part", str(tmp_path / "pt.db"),
                         sampler=RandomSampler(0))
    real_ask, real_tell = study.ask, study.tell
    calls = {"ask": 0, "tell": 0}

    def ask():
        calls["ask"] += 1
        if calls["ask"] == 1:
            raise RuntimeError("database is locked")
        return real_ask()

    def tell(trial, state, value=None):
        calls["tell"] += 1
        if calls["tell"] == 1:
            raise RuntimeError("database is locked")
        return real_tell(trial, state, value)

    study.ask, study.tell = ask, tell
    run_parallel_trials(study, lambda t, m: 1.0, n_trials=4, max_workers=2,
                        devices=CPU2, verbose=True)
    states = sorted(t.state for t in study.get_trials())
    assert states == ["COMPLETE", "COMPLETE", "RUNNING"]
    assert "study.ask() failed" in capsys.readouterr().out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("par_shards")
    meta = make_synthetic_shards(str(root), num_classes=2, per_class=24,
                                 samples_per_shard=24, seed=6, size=SIZE)
    info = analyze_webdataset(meta["shards"])
    cached = build_cache(meta["shards"], info.class_names, size=SIZE)
    return root, meta["shards"], info, cached


def _tiny_space(trial):
    return {
        "learning_rate": trial.suggest_float("learning_rate", 1e-3, 5e-3,
                                             log=True),
        "batch_size": trial.suggest_categorical("batch_size", [16]),
        "weight_decay": trial.suggest_float("weight_decay", 1e-6, 1e-4,
                                            log=True),
        "dropout_rate": trial.suggest_float("dropout_rate", 0.0, 0.2),
        "augmentation_intensity": trial.suggest_categorical(
            "augmentation_intensity", ["low"]),
        "patience": trial.suggest_int("patience", 3, 3),
        "max_epochs": trial.suggest_int("max_epochs", 2, 2),
    }


def test_parallel_kfold_runner(data, tmp_path):
    """run_kfold_optimization(parallel_workers=2): real k-fold trials
    (ResNet18/56, k = 2) on two CPU workers, the workers' pools released
    and their sizes summed onto the caller's context."""
    _, _, info, cached = data
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    tracking.set_experiment("par_kfold")
    hcfg = HyperoptConfig(n_trials=2, k_folds=2, first_fold_min_acc=0.0,
                          median_startup_trials=50,
                          storage=str(tmp_path / "s.db"),
                          study_name="par_kfold", seed=0)
    ctx = objective.HyperoptContext(
        cached=cached, info=info, hcfg=hcfg,
        model_base=ModelConfig(depth=18, num_classes=2, image_size=56,
                               compute_dtype="float32"),
        device="cpu", train_samples_per_epoch=48, eval_samples=24,
        space_fn=_tiny_space)
    study = runner.run_kfold_optimization(ctx, n_trials=2, verbose=False,
                                          parallel_workers=2, devices=CPU2)
    trials = study.get_trials()
    assert len(trials) == 2
    assert all(t.state == "COMPLETE" and np.isfinite(t.value)
               for t in trials)
    assert ctx._hbm_pool is None
    assert ctx.hbm_pool_stats["upload_bytes"] >= 48 * SIZE * SIZE * 3
    assert 1 <= ctx.hbm_pool_stats["n_worker_pools"] <= 2


def test_the_cli_runs_parallel_workers(data, tmp_path, monkeypatch, capsys):
    """hyperopt_cli --parallel-workers 2 --cpu: two CPU workers sweep two
    quick trials (fit stubbed) to COMPLETE."""
    root, shards, _, _ = data
    workers = set()

    class _Result:
        best_val_acc = 60.0

    def fit(*args, on_epoch_end=None, mesh=None, **kw):
        workers.add(threading.get_ident())
        assert mesh is not None and mesh.device.type == "cpu"
        time.sleep(0.05)
        on_epoch_end(0, 60.0)
        return _Result()

    monkeypatch.setattr(objective, "fit", fit)
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    db = str(tmp_path / "cli.db")
    assert hyperopt_cli.main([
        "--data-dir", os.path.dirname(shards[0]), "--cpu", "--quick",
        "--n-trials", "2", "--k-folds", "2", "--storage", db,
        "--study-name", "cli", "--cache-dir", str(root / "cache"),
        "--parallel-workers", "2", "--seed", "0"]) == 0
    trials = create_study("cli", db).get_trials()
    assert [t.state for t in trials] == ["COMPLETE", "COMPLETE"]
    assert len(workers) == 2
    assert "K-Fold Study statistics" in capsys.readouterr().out
