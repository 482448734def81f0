"""The port's final stage (``irp_tpu_torch/train/final.py``,
``cli/final_cli.py``, the final artifacts of ``train/checkpoint.py`` and
the figures of ``utils/viz.py``) against the JAX package's, on the CPU.

One study, written by the JAX package's own storage and tracking: one
COMPLETE trial (ResNet18/56, batch 16) whose tracking run holds
``recommended_epochs = 2``, with an extra searched TrainConfig key
(``label_smoothing``, carried) and pinned ones (``patience``,
``eval_samples``).  Both packages' ``train_final_model`` run on it:

- the derived ModelConfig/TrainConfig are equal field for field;
- the tracking runs have equal params, metric names and artifact names;
- the port's ``final_model.npz``, loaded by the JAX package's
  ``load_predictor`` at float32, predicts the port's test-evaluation
  labels, its loss within 1e-4 relative;
- the port's ``final_model.pth`` equals the JAX ``export_torch_pth`` of
  the same variables, and the port's ``load_predictor`` reads the .pth
  and the .npz to equal probabilities;
- a run whose newest checkpoint was removed resumes to weights equal bit
  for bit to the uninterrupted run's.

``recommended_epochs_from_study``'s three sources, the galleries and
the heatmap (the same PNGs with matplotlib's import patched away), the
CLI with its four refusals and ``tools/final_bn_check.py`` (its BN
statistics recomputed as the train set's batch mean) are checked too.
"""

import copy
import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu import hyperopt as jax_hyperopt
from irp_tpu import infer as jax_infer
from irp_tpu import tracking as jax_tracking
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.data.analyze import analyze_webdataset as jax_analyze
from irp_tpu.data.pipeline import build_cache as jax_build_cache
from irp_tpu.train import checkpoint as jax_ckpt
from irp_tpu.train import final as jax_final
from irp_tpu_torch import hyperopt, infer, tracking
from irp_tpu_torch.cli import final_cli
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.data.analyze import analyze_webdataset
from irp_tpu_torch.data.pipeline import build_cache
from irp_tpu_torch.train import final
from irp_tpu_torch.train.loop import host_weighted_ce
from tests.synth import make_synthetic_shards

torch.set_num_threads(1)
SIZE, CROP, DEPTH = 64, 56, 18
PARAMS = {"learning_rate": 1e-3, "batch_size": 16, "weight_decay": 1e-4,
          "dropout_rate": 0.2, "augmentation_intensity": "medium",
          "max_epochs": 3, "patience": 3, "label_smoothing": 0.1,
          "eval_samples": 64}
ARTIFACTS = ["confusion_matrix.png", "correct_classifications.png",
             "final_model.npz", "final_model.pth",
             "incorrect_classifications.png"]


def _jax_study(path, params, run_id=None, name="final"):
    """A one-trial COMPLETE study written by the JAX package."""
    study = jax_hyperopt.create_study(name, str(path))
    trial = study.ask()
    for k, v in params.items():
        if isinstance(v, str):
            trial.suggest_categorical(k, [v])
        elif isinstance(v, float):
            trial.suggest_float(k, v, v)
        else:
            trial.suggest_int(k, v, v)
    if run_id is not None:
        trial.set_user_attr("tracking_run_id", run_id)
    study.tell(trial, "COMPLETE", 90.0)
    return study


def _spy(module, name, sink):
    """Wrap ``module.name`` so that each call's arguments and result are
    appended to ``sink``; returns the original."""
    original = getattr(module, name)

    def spy(*args, **kwargs):
        result = original(*args, **kwargs)
        sink.append((args, kwargs, result))
        return result

    setattr(module, name, spy)
    return original


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("final")
    data = root / "shards"
    train = make_synthetic_shards(str(data), num_classes=3, per_class=16,
                                  samples_per_shard=16, seed=2, size=SIZE)
    test = make_synthetic_shards(str(data), num_classes=3, per_class=8,
                                 samples_per_shard=24, seed=3, size=SIZE,
                                 prefix="test")
    # the sweep's tracking run, written by the JAX package
    base = str(root / "mlruns_base")
    jax_tracking.set_tracking_uri(base)
    jax_tracking.set_experiment("animals10")
    with jax_tracking.start_run(run_name="optuna_trial_0_kfold") as run:
        run.log_params({"recommended_epochs": 2})
        run_id = run.info.run_id
    db = root / "study.db"
    _jax_study(db, PARAMS, run_id)
    stores = {}
    for name in ("jax", "torch", "cli"):
        stores[name] = str(root / f"mlruns_{name}")
        shutil.copytree(base, stores[name])

    info = analyze_webdataset(train["shards"])
    jinfo = jax_analyze(train["shards"])
    assert info == type(info)(**dataclasses.asdict(jinfo))
    tr = build_cache(train["shards"], info.class_names, size=SIZE)
    te = build_cache(test["shards"], info.class_names, size=SIZE)
    jtr = jax_build_cache(train["shards"], jinfo.class_names, size=SIZE)
    jte = jax_build_cache(test["shards"], jinfo.class_names, size=SIZE)

    # the JAX run (no checkpoints: they do not change its run)
    jax_tracking.set_tracking_uri(stores["jax"])
    jax_fits = []
    original = _spy(jax_final, "fit", jax_fits)
    try:
        jres = jax_final.train_final_model(
            jax_hyperopt.create_study("final", str(db)), jtr, jte, jinfo,
            model_base=JaxModelConfig(depth=DEPTH, image_size=CROP,
                                      compute_dtype="float32"),
            verbose=False)
    finally:
        jax_final.fit = original

    # the port's run, with per-epoch checkpoints
    tracking.set_tracking_uri(stores["torch"])
    fits, evals = [], []
    originals = (_spy(final, "fit", fits),
                 _spy(final, "evaluate_full", evals))
    try:
        res = final.train_final_model(
            hyperopt.create_study("final", str(db)), tr, te, info,
            model_base=ModelConfig(depth=DEPTH, image_size=CROP,
                                   compute_dtype="float32"),
            device="cpu", checkpoint_dir=str(root / "ckpt"), verbose=False)
    finally:
        final.fit, final.evaluate_full = originals
    return {"root": root, "data": str(data), "db": str(db),
            "stores": stores, "info": info, "train": tr, "test": te,
            "jres": jres, "jax_fit": jax_fits[0], "res": res,
            "fit": fits[0], "eval": evals[0][2]}


def _run(uri, tracking_mod, run_id):
    client = tracking_mod.TrackingClient(uri)
    run = client.get_run(run_id)
    return (run["info"]["run_name"], run["info"]["status"], run["params"],
            sorted(client.get_metric_histories(run_id)),
            client.list_artifacts(run_id))


def test_final_configs_equal_jax(world):
    # fit(train_cached, None, info, model_cfg, train_cfg, ...)
    m, t = world["fit"][0][3:5]
    jm, jt = world["jax_fit"][0][3:5]
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    assert dataclasses.asdict(t) == dataclasses.asdict(jt)
    # searched extra key carried, pinned ones held, the final stage's pins
    assert t.label_smoothing == 0.1 and t.eval_samples is None
    assert (t.max_epochs, t.patience, t.scheduler_step, t.seed,
            t.train_samples_per_epoch) == (2, 3, "epoch", 42, None)
    assert m.dropout_rate == 0.2 and m.num_classes == 3


def test_tracking_run_equals_jax(world):
    got = _run(world["stores"]["torch"], tracking, world["res"].run_id)
    want = _run(world["stores"]["jax"], jax_tracking, world["jres"].run_id)
    assert got == want
    name, status, params, metrics, artifacts = got
    assert (name, status) == ("final_model_full_training", "FINISHED")
    assert params["final_epochs"] == "2" and params["mode"] == "hbm"
    assert {"test_acc", "test_loss", "train_loss", "train_acc"} <= set(
        metrics)
    assert artifacts == ARTIFACTS


def test_port_npz_scores_like_its_test_eval_in_jax(world):
    res, ev, info = world["res"], world["eval"], world["info"]
    client = tracking.TrackingClient(world["stores"]["torch"])
    npz = client.artifact_path(res.run_id, "final_model.npz")
    params, _ = jax_ckpt.load_weights_npz(npz)
    cfg = jax_infer.infer_model_config(params, image_size=CROP,
                                       compute_dtype="float32")
    pred = jax_infer.load_predictor(npz, cfg=cfg, batch_size=16)
    probs = pred.predict_probs(np.asarray(world["test"].images))
    assert np.array_equal(probs.argmax(axis=1), ev.preds)
    assert np.array_equal(ev.labels, world["test"].labels)
    loss = host_weighted_ce(np.log(probs), ev.labels, info.class_weights)
    assert abs(loss - res.test_loss) <= 1e-4 * abs(res.test_loss)
    assert res.test_acc == pytest.approx(
        100.0 * np.mean(ev.preds == ev.labels))
    assert res.report["accuracy"] * 100.0 == pytest.approx(res.test_acc)


def test_pth_equals_jax_export_and_both_artifacts_load(world, tmp_path):
    res = world["res"]
    client = tracking.TrackingClient(world["stores"]["torch"])
    npz = client.artifact_path(res.run_id, "final_model.npz")
    pth = client.artifact_path(res.run_id, "final_model.pth")
    params, stats = jax_ckpt.load_weights_npz(npz)
    want = torch.load(jax_ckpt.export_torch_pth(
        str(tmp_path / "jax.pth"), params, stats, depth=DEPTH))
    got = torch.load(pth)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        assert torch.equal(v, want[k]), k
    cfg = ModelConfig(depth=DEPTH, num_classes=3, image_size=CROP,
                      compute_dtype="float32")
    images = np.asarray(world["test"].images[:5])
    p_npz = infer.load_predictor(npz, cfg=cfg, device="cpu").predict_probs(
        images)
    p_pth = infer.load_predictor(pth, cfg=cfg, device="cpu").predict_probs(
        images)
    assert np.array_equal(p_npz, p_pth)
    # the npz names its crop; the JAX reader infers the same config
    assert jax_ckpt.load_weights_meta(npz) == {"image_size": CROP}


def test_resume_after_epoch_one_is_bit_exact(world, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(str(world["root"] / "ckpt"), ckpt)
    assert sorted(os.listdir(ckpt)) == [
        "checkpoint_epoch_000.npz", "checkpoint_epoch_001.npz",
        "final_model.npz", "step_00000000.pt", "step_00000001.pt"]
    os.remove(os.path.join(ckpt, "step_00000001.pt"))  # killed in epoch 1
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    shutil.copytree(world["stores"]["torch"], str(tmp_path / "mlruns"),
                    dirs_exist_ok=True)
    res = final.train_final_model(
        hyperopt.create_study("final", world["db"]), world["train"],
        world["test"], world["info"],
        model_base=ModelConfig(depth=DEPTH, image_size=CROP,
                               compute_dtype="float32"),
        device="cpu", checkpoint_dir=ckpt, verbose=False, resume=True)
    assert len(res.history["train_loss"]) == 1  # epoch 1 alone
    got = res.state.model.state_dict()
    want = world["res"].state.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert res.test_loss == world["res"].test_loss


def test_resume_without_a_checkpoint_dir_raises(world, tmp_path):
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        final.train_final_model(
            hyperopt.create_study("final", world["db"]), world["train"],
            world["test"], world["info"], device="cpu", verbose=False,
            resume=True)


@pytest.mark.parametrize("case", ["run", "max_epochs", "neither"])
def test_recommended_epochs_equal_jax(tmp_path, case):
    uri = str(tmp_path / "mlruns")
    jax_tracking.set_tracking_uri(uri)
    jax_tracking.set_experiment("animals10")
    run_id = None
    if case == "run":
        with jax_tracking.start_run(run_name="trial") as run:
            run.log_params({"recommended_epochs": 4})
            run_id = run.info.run_id
    params = {"learning_rate": 1e-3}
    if case != "neither":
        params["max_epochs"] = 7
    _jax_study(tmp_path / "s.db", params, run_id)
    want = jax_final.recommended_epochs_from_study(
        jax_hyperopt.create_study("final", str(tmp_path / "s.db")))
    got = final.recommended_epochs_from_study(
        hyperopt.create_study("final", str(tmp_path / "s.db")),
        client=tracking.TrackingClient(uri))
    assert got == want == {"run": 4, "max_epochs": 5, "neither": 10}[case]


def test_galleries_and_heatmap_need_no_matplotlib(tmp_path, monkeypatch):
    from irp_tpu_torch.utils import viz

    rng = np.random.default_rng(4)
    labels = rng.integers(0, 3, 40)
    preds = np.where(rng.uniform(size=40) < 0.5, labels,
                     rng.integers(0, 3, 40))
    images = rng.integers(0, 255, (40, 64, 64, 3), dtype=np.uint8)
    names = ["cane", "cavallo", "elefante"]
    want = jax_final.visualize_classifications(
        preds, labels, images, names, str(tmp_path / "jax"))

    def draw(out):
        paths = final.visualize_classifications(preds, labels, images, names,
                                                str(out))
        paths.append(viz.plot_confusion_matrix(
            np.arange(9).reshape(3, 3), names, str(out / "cm.png")))
        return paths

    got = draw(tmp_path / "torch")
    # the same figures, byte for byte, where matplotlib cannot be imported
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    bare = draw(tmp_path / "bare")
    assert [os.path.basename(p) for p in got[:2]] == [
        os.path.basename(p) for p in want] == [
        "correct_classifications.png", "incorrect_classifications.png"]
    for p, q in zip(got, bare):
        with Image.open(p) as im:
            im.load()
            assert im.format == "PNG" and min(im.size) > 100
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read()


def test_display_model_visualizations_finds_the_figures(world, tmp_path):
    tracking.set_tracking_uri(world["stores"]["torch"])
    paths = final.display_model_visualizations(out_dir=str(tmp_path))
    assert sorted(os.path.basename(p) for p in paths) == [
        a for a in ARTIFACTS if a.endswith(".png")]


def test_final_cli_on_a_jax_study(world, capsys):
    tracking.set_tracking_uri(world["stores"]["cli"])
    rc = final_cli.main(["--data-dir", world["data"], "--storage",
                         world["db"], "--study-name", "final",
                         "--cache-dir", str(world["root"] / "cache"),
                         "--cpu", "--depth", str(DEPTH), "--image-size",
                         str(CROP)])
    assert rc == 0
    assert "Final test accuracy" in capsys.readouterr().out


def test_recompute_bn_stats_is_the_train_sets_batch_mean(world):
    from irp_tpu_torch.models.resnet import BatchNorm2d
    from irp_tpu_torch.tools.final_bn_check import recompute_bn_stats

    model = copy.deepcopy(world["res"].state.model)
    bns = {n: m for n, m in model.named_modules()
           if isinstance(m, BatchNorm2d)}
    live = {n for n, m in bns.items() if not m.frozen}
    assert live and all(n.startswith("backbone.layer4") for n in live)
    before = copy.deepcopy(model.state_dict())
    seen = {n: [] for n in live}

    def hook(name):
        def record(_, inputs, __):
            x = inputs[0].double()
            mean = x.mean(dim=(0, 2, 3))
            seen[name].append((mean, (x * x).mean(dim=(0, 2, 3))
                               - mean * mean))
        return record

    handles = [bns[n].register_forward_hook(hook(n)) for n in live]
    recompute_bn_stats(model, world["train"], torch.device("cpu"), 16, CROP,
                       torch.float32)
    for h in handles:
        h.remove()
    assert not model.training
    after = model.state_dict()
    for key, value in before.items():
        layer = key.rsplit(".", 1)[0]
        if layer in live and key.endswith(("running_mean", "running_var")):
            stat = 0 if key.endswith("running_mean") else 1
            want = torch.stack([b[stat] for b in seen[layer]]).mean(0)
            assert len(seen[layer]) == len(world["train"]) // 16
            np.testing.assert_allclose(after[key].double(), want,
                                       rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(after[key], value), key


def test_final_bn_check_tool_on_a_jax_study(world, capsys):
    from irp_tpu_torch.tools import final_bn_check

    rows = final_bn_check.main([
        "--data-dir", world["data"], "--storage", world["db"],
        "--study-name", "final", "--cache-dir", str(world["root"] / "cache"),
        "--cpu", "--depth", str(DEPTH), "--image-size", str(CROP),
        "--run", "1,off,float32"])
    (row,) = rows
    assert (row["epochs"], row["fused_frozen_blocks"], row["dtype"]) == (
        1, "off", "float32")
    assert len(row["train_loss"]) == 1 and row["bn_layers"] > 0
    for key in ("test_acc", "train_acc_eval_form", "test_acc_recomputed_bn",
                "max_abs_log_var_ratio", "max_mean_in_sd"):
        assert np.isfinite(row[key]), key
    assert '"final_bn_check"' in capsys.readouterr().out


@pytest.mark.parametrize("case", ["no_shards", "no_storage", "empty_study",
                                  "resume_without_dir"])
def test_final_cli_refusals_exit_2(world, tmp_path, case):
    tracking.set_tracking_uri(str(tmp_path / "mlruns"))
    argv = {"no_shards": ["--data-dir", str(tmp_path)],
            "no_storage": ["--storage", str(tmp_path / "none.db")],
            "empty_study": ["--study-name", "nothing_here"],
            "resume_without_dir": ["--resume"]}[case]
    db = str(tmp_path / "study.db")
    shutil.copy(world["db"], db)
    base = ["--data-dir", world["data"], "--storage", db, "--study-name",
            "final", "--cpu"]
    assert final_cli.main(base + argv) == 2
