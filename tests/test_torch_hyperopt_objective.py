"""The port's k-fold objective against the JAX package's, and the sweep
end to end on the CPU.

- With ``fit`` replaced in both packages' objective modules by the same
  scripted per-epoch accuracies, a sweep gives equal trial states (each
  pruning tier hit), values (to 1e-9), ``recommended_epochs`` and
  tracking metrics.  This holds the deterministic part of the slice as
  a whole to the JAX package: the folds, the ladder, the aggregation,
  the study and the tracking layout.  (The fits themselves draw from
  other random streams in the two packages.)
- A real tiny sweep of the port (ResNet18/56, k=2, two trials) writes its
  study database, and the CLI resumes it to a third trial.
"""

import math
import os

import numpy as np
import pytest
import torch

from irp_tpu import tracking as jax_tracking
from irp_tpu.config import HyperoptConfig as JaxHyperoptConfig
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.data.pipeline import build_cache as jax_build_cache
from irp_tpu.hyperopt import objective as jax_objective
from irp_tpu.hyperopt import runner as jax_runner
from irp_tpu_torch import tracking
from irp_tpu_torch.cli import hyperopt_cli
from irp_tpu_torch.config import HyperoptConfig, ModelConfig
from irp_tpu_torch.data.analyze import analyze_webdataset
from irp_tpu_torch.data.pipeline import build_cache
from irp_tpu_torch.hyperopt import objective, runner
from tests.synth import make_synthetic_shards

torch.set_num_threads(1)
SIZE = 64

# per trial, per fold, the accuracy of each epoch; None: the fit runs out
# of device memory
SCRIPT = [
    [[20.0, 30.0, 40.0]],                                  # tier 2
    [[60.0, 70.0, 80.0], [62.0, 72.0, 81.0], [58.0, 69.0, 78.0]],
    [[65.0, 75.0, 85.0], [60.0, 71.0, 80.0], [64.0, 74.0, 79.0]],
    [[10.0, 20.0, 30.0]],                                  # tier 1
    [[70.0, 80.0, 90.0], [5.0, 5.0, 5.0]],                 # tier 3
    [[70.0, 85.0, 80.0], [72.0, 86.0, 79.0], [71.0, 84.0, 81.0]],
    None,                                                  # OOM: -inf
]
STATES = ["PRUNED", "COMPLETE", "COMPLETE", "PRUNED", "PRUNED", "COMPLETE",
          "COMPLETE"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("hpo_shards")
    meta = make_synthetic_shards(str(root), num_classes=3, per_class=32,
                                 samples_per_shard=16, seed=2, size=SIZE)
    info = analyze_webdataset(meta["shards"])
    cached = build_cache(meta["shards"], info.class_names,
                         cache_dir=str(root / "cache"), size=SIZE)
    return root, meta["shards"], info, cached


class _Result:
    def __init__(self, acc):
        self.best_val_acc = acc


def _scripted(oom: Exception):
    at = {"trial": -1, "fold": 0}

    def space(trial):
        at["trial"], at["fold"] = trial.number, 0
        return {
            "learning_rate": trial.suggest_float("learning_rate", 1e-4,
                                                 1e-2, log=True),
            "batch_size": trial.suggest_categorical("batch_size", [8, 16]),
            "weight_decay": trial.suggest_float("weight_decay", 1e-6, 1e-4,
                                                log=True),
            "dropout_rate": trial.suggest_float("dropout_rate", 0.0, 0.5),
            "augmentation_intensity": trial.suggest_categorical(
                "augmentation_intensity", ["low"]),
            "patience": trial.suggest_int("patience", 3, 3),
            "max_epochs": trial.suggest_int("max_epochs", 3, 3),
        }

    def fit(train_cached, val_cached, info, model_cfg, train_cfg,
            logger=None, on_epoch_end=None, **kw):
        script = SCRIPT[at["trial"]]
        if script is None:
            raise oom
        accs = script[at["fold"]]
        at["fold"] += 1
        assert len(train_cached) + len(val_cached) == 96
        for epoch, acc in enumerate(accs):
            logger.log_metrics({"val_acc": acc}, step=epoch)
            on_epoch_end(epoch, acc)
        return _Result(max(accs))

    return space, fit


def _runs(client, exp_name):
    out = {}
    for run in client.search_runs(exp_name):
        rid = run["info"]["run_id"]
        hist = {k: [(p.value, p.step) for p in v]
                for k, v in client.get_metric_histories(rid).items()}
        out[run["info"]["run_name"]] = (run["params"], hist,
                                        run["info"]["status"])
    return out


def test_stubbed_sweep_equals_jax(data, tmp_path, monkeypatch):
    root, shards, info, cached = data
    hc = dict(n_trials=len(SCRIPT), k_folds=3, first_fold_min_acc=50.0,
              median_startup_trials=2, median_warmup_steps=0,
              progressive_min_trials=2, progressive_factor=0.85, seed=0,
              study_name="scripted")
    jcached = jax_build_cache(shards, info.class_names,
                              cache_dir=str(root / "cache"), size=SIZE)
    studies = {}
    for name in ("jax", "torch"):
        trk = jax_tracking if name == "jax" else tracking
        trk.set_tracking_uri(str(tmp_path / name / "mlruns"))
        trk.set_experiment("animals10")
        if name == "jax":
            oom = RuntimeError("RESOURCE_EXHAUSTED: out of memory")
            space, fit = _scripted(oom)
            monkeypatch.setattr(jax_objective, "fit", fit)
            ctx = jax_objective.HyperoptContext(
                cached=jcached, info=info,
                hcfg=JaxHyperoptConfig(
                    storage=str(tmp_path / "jax.db"), **hc),
                model_base=JaxModelConfig(), space_fn=space,
                reuse_hbm_pool=False)
            studies[name] = jax_runner.run_kfold_optimization(
                ctx, verbose=False)
        else:
            space, fit = _scripted(torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 1.00 GiB"))
            monkeypatch.setattr(objective, "fit", fit)
            ctx = objective.HyperoptContext(
                cached=cached, info=info,
                hcfg=HyperoptConfig(storage=str(tmp_path / "torch.db"),
                                    **hc),
                device="cpu", space_fn=space, reuse_hbm_pool=False)
            studies[name] = runner.run_kfold_optimization(ctx,
                                                          verbose=False)
    got = studies["torch"].get_trials()
    want = studies["jax"].get_trials()
    assert [t.state for t in got] == [t.state for t in want] == STATES
    for a, b in zip(got, want):
        assert a.params == b.params
        assert a.intermediate_values == b.intermediate_values
        if b.value is None or math.isinf(b.value):
            assert a.value == b.value
        else:
            assert abs(a.value - b.value) <= 1e-9
    assert got[6].value == -math.inf
    runs = _runs(tracking.TrackingClient(str(tmp_path / "torch" / "mlruns")),
                 "animals10")
    jruns = _runs(jax_tracking.TrackingClient(
        str(tmp_path / "jax" / "mlruns")), "animals10")
    assert runs == jruns and len(runs) == len(SCRIPT)
    assert runs["optuna_trial_5_kfold"][0]["recommended_epochs"] == "2"
    assert "pruned_first_fold" in runs["optuna_trial_0_kfold"][0]
    assert "pruned_progressive" in runs["optuna_trial_4_kfold"][0]
    for t in got:
        if t.state == "COMPLETE" and math.isfinite(t.value):
            rid = t.user_attrs["tracking_run_id"]
            params = jax_tracking.TrackingClient(
                str(tmp_path / "torch" / "mlruns")).get_run(rid)["params"]
            assert "recommended_epochs" in params


def test_a_pinned_field_in_the_space_is_refused(data, tmp_path):
    root, _, info, cached = data
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))

    def space(trial):
        hp = objective.quick_space(trial)
        hp["eval_samples"] = trial.suggest_categorical("eval_samples", [8])
        return hp

    ctx = objective.HyperoptContext(
        cached=cached, info=info,
        hcfg=HyperoptConfig(storage=str(tmp_path / "p.db"), k_folds=2),
        device="cpu", space_fn=space)
    study = runner.run_kfold_optimization(ctx, n_trials=1, verbose=False)
    assert study.get_trials()[0].state == "FAILED"
    with pytest.raises(ValueError, match="pins"):
        objective.objective_kfold(study.ask(), ctx)


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


def test_a_tiny_sweep_runs_and_the_cli_resumes_it(data, tmp_path, capsys):
    root, shards, info, cached = data
    uri = str(tmp_path / "mlruns")
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("animals10")
    db = str(tmp_path / "study.db")
    hcfg = HyperoptConfig(n_trials=2, k_folds=2, first_fold_min_acc=0.0,
                          median_startup_trials=50, storage=db,
                          study_name="tiny", seed=0)
    ctx = objective.HyperoptContext(
        cached=cached, info=info, hcfg=hcfg,
        model_base=ModelConfig(depth=18, num_classes=info.num_classes,
                               image_size=56, compute_dtype="float32"),
        device="cpu", train_samples_per_epoch=128, eval_samples=64,
        space_fn=_tiny_space)
    study = runner.run_kfold_optimization(ctx, n_trials=2, verbose=False)
    assert os.path.exists(db)
    trials = study.get_trials()
    assert [t.state for t in trials] == ["COMPLETE", "COMPLETE"]
    assert all(np.isfinite(t.value) for t in trials)
    assert ctx.hbm_pool_stats["upload_bytes"] == 96 * SIZE * SIZE * 3 + 96 * 4
    client = tracking.TrackingClient(uri)
    run = client.get_run(study.best_trial.user_attrs["tracking_run_id"])
    assert run["params"]["recommended_epochs"] in ("1", "2")

    capsys.readouterr()
    rc = hyperopt_cli.main([
        "--data-dir", os.path.dirname(shards[0]), "--cpu", "--quick",
        "--n-trials", "1", "--k-folds", "2", "--storage", db,
        "--study-name", "tiny", "--cache-dir", str(root / "cache"),
        "--depth", "18", "--image-size", "56", "--seed", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Loaded existing study with 2 previous trials" in out
    resumed = runner.create_study("tiny", db).get_trials()
    assert len(resumed) == 3 and resumed[2].state == "COMPLETE"


def test_the_cli_without_shards_returns_1(tmp_path):
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    assert hyperopt_cli.main(["--data-dir", str(tmp_path), "--cpu",
                              "--storage", str(tmp_path / "s.db")]) == 1


@pytest.mark.parametrize("argv,rc", [
    (["--parallel-workers", "2"], 1),
])
def test_the_cli_refuses_what_is_not_ported(tmp_path, argv, rc):
    """--parallel-workers is ported (tests/test_torch_parallel_trials.py
    sweeps with it): the CLI takes it and gets to its data check, here a
    directory without shards."""
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    assert hyperopt_cli.main(["--data-dir", str(tmp_path), "--cpu",
                              "--storage", str(tmp_path / "s.db"),
                              *argv]) == rc


def test_the_cli_sweeps_another_family(data, monkeypatch):
    """--family vit --vit-variant b_16 (laid over ViT-B/16's recipe at a
    small width: 2 blocks of 32, patch 16 at 64 px) sweeps one quick trial
    over two folds to COMPLETE, the ViT family in its tracking run."""
    import dataclasses

    from irp_tpu_torch.cli import model_args

    root, shards, _, _ = data
    real = model_args.model_config_for_family
    seen = []

    def small(family, **kw):
        cfg = dataclasses.replace(real(family, **kw), embed_dim=32,
                                  num_layers=2, mlp_dim=64, num_heads=2,
                                  hidden_dim=16)
        seen.append(cfg)
        return cfg

    monkeypatch.setattr(model_args, "model_config_for_family", small)
    fitted = []
    real_fit = objective.fit

    def fit(*a, **kw):
        fitted.append(a[3])  # the trial's ModelConfig
        return real_fit(*a, **kw)

    monkeypatch.setattr(objective, "fit", fit)
    uri = str(root / "mlruns_vit")
    tracking.set_tracking_uri(uri)
    db = str(root / "vit.db")
    assert hyperopt_cli.main([
        "--data-dir", os.path.dirname(shards[0]), "--cpu", "--quick",
        "--n-trials", "1", "--k-folds", "2", "--storage", db,
        "--study-name", "vit", "--cache-dir", str(root / "cache"),
        "--family", "vit", "--image-size", str(SIZE), "--seed", "0"]) == 0
    assert [c.family for c in seen] == ["vit"]
    assert seen[0].trainable_stages == ("layer4",)  # ViT's default recipe
    # each fold-fit trains the CLI's family and variant, not a ResNet
    assert len(fitted) == 2
    assert all(c.family == "vit" and c.patch_size == 16
               and c.embed_dim == 32 for c in fitted)
    [trial] = runner.create_study("vit", db).get_trials()
    assert trial.state == "COMPLETE" and np.isfinite(trial.value)


def test_the_runner_refuses_parallel_workers(data, tmp_path, monkeypatch):
    """parallel_workers=2 (ported) runs two trials at once on two CPU
    workers, each on its own one-device mesh with its own fold pool, with
    ``fit`` stubbed: both trials COMPLETE, every pool released and their
    sizes summed onto the caller's context."""
    _, _, info, cached = data
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    meshes = []

    def fit(train_cached, val_cached, info, model_cfg, train_cfg,
            logger=None, on_epoch_end=None, mesh=None, **kw):
        meshes.append(mesh)
        on_epoch_end(0, 50.0)
        return _Result(50.0)

    monkeypatch.setattr(objective, "fit", fit)
    hcfg = HyperoptConfig(n_trials=2, k_folds=2, first_fold_min_acc=0.0,
                          storage=str(tmp_path / "p.db"), study_name="par",
                          seed=0)
    ctx = objective.HyperoptContext(cached=cached, info=info, hcfg=hcfg,
                                    device="cpu")
    study = runner.run_kfold_optimization(ctx, n_trials=2, verbose=False,
                                          parallel_workers=2,
                                          devices=["cpu", "cpu"])
    assert [t.state for t in study.get_trials()] == ["COMPLETE"] * 2
    assert len(meshes) == 4 and all(m.size == 1 and not m.is_process
                                    for m in meshes)
    assert ctx._hbm_pool is None
    assert ctx.hbm_pool_stats["upload_bytes"] > 0
    assert 1 <= ctx.hbm_pool_stats["n_worker_pools"] <= 2
