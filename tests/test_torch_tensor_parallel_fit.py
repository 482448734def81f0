"""``fit``, checkpoints and ``train_final_model`` over a 1 x 2 mesh of two
gloo ranks and a 2 x 2 mesh of four (tests/torch_dist_child.py, task
``tp_fit``, the CPU).

- ``fit(mesh=)`` of the tiny ViT (every block tensor-parallel) with a
  validation set: every rank stops on the same epoch with the same
  history, only world rank 0 logs, and the returned model is whole and
  bit-equal on every rank.
- A one-step Adam state of the ViT at model=2 written by
  ``save_checkpoint`` (world rank 0 alone) holds whole tensors, the
  ranks' gathered ones, and restores at model=1 bit for bit; a model=1
  checkpoint restores at model=2 to each rank's slices (the packed
  ``in_proj``'s whole heads among them), which gather back to it bit for
  bit.
- ``train_final_model(mesh=)`` of the ViT (the stream path): world rank 0
  alone writes the checkpoints, the tracking run and the artifacts,
  which hold whole tensors; its ``final_model.npz`` loads into the JAX
  package's ``load_predictor``, whose f32 log-probabilities equal the
  port's whole model's within 1e-5.

The ViT is the one family split in every block, and keeps the files
small (the ranks write their outputs to the test's temporary
directory).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from irp_tpu.infer import infer_model_config as jax_infer_config
from irp_tpu.infer import load_predictor as jax_load_predictor
from irp_tpu.train.checkpoint import load_weights_npz as jax_load_npz
from irp_tpu_torch import infer
from irp_tpu_torch.config import ModelConfig, TrainConfig
from irp_tpu_torch.models.classifier import Classifier, get_classifier
from irp_tpu_torch.ops.preprocess import sample_augment_draws
from irp_tpu_torch.parallel.tensor import shard_index
from irp_tpu_torch.tracking import TrackingClient
from irp_tpu_torch.train.checkpoint import (restore_checkpoint,
                                            save_checkpoint)
from irp_tpu_torch.train.loop import set_mode
from irp_tpu_torch.train.state import create_train_state
from irp_tpu_torch.train.step import StepConfig, train_step

from irp_tpu_torch.models.convert import jax_variables_to_state_dict
from tests.torch_dist_child import launch
from tests.torch_jax_train import uint8_images
from tests.test_torch_tensor_parallel_train import FAMILIES, _variables

torch.set_num_threads(1)
VIT_CFG = dataclasses.replace(FAMILIES["vit"][0], precision="default")
QKV = "backbone.encoder.layers.encoder_layer_1.self_attention.in_proj_weight"
TRAIN = dict(optimizer="adam", learning_rate=1e-3, batch_size=8,
             max_epochs=2, patience=1, train_samples_per_epoch=None,
             eval_samples=None, aug_intensity="low", seed=3)
CKPT_TRAIN = dict(optimizer="adam", learning_rate=1e-3, batch_size=8)
LOGP_TOL = 1e-5


def _ckpt_state(state_dict):
    """A one-process Adam state of the ViT from ``state_dict``."""
    cfg = ModelConfig(**dataclasses.asdict(VIT_CFG))
    model = get_classifier(cfg, device="cpu")
    model.load_state_dict(state_dict)
    set_mode(model, True)
    return create_train_state(model, TrainConfig(**CKPT_TRAIN), cfg, 1)


def _flat(sd: dict) -> dict:
    """A checkpoint's tensors by one flat key."""
    opt = sd["optimizer"]
    out = {f"model/{k}": v for k, v in sd["model"].items()}
    for kind, tensors in opt["moments"].items():
        out.update({f"{kind}/{k}": v for k, v in tensors.items()})
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["1x2", "2x2"])
def run(request, tmp_path_factory):
    world = request.param
    root = tmp_path_factory.mktemp(f"tp_fit{world}")
    images = uint8_images(11, 40, 64)
    labels = (np.arange(40) % 3).astype(np.int32)
    counts = np.bincount(labels[:32], minlength=3)
    info = dict(num_classes=3, class_names=("a", "b", "c"),
                class_weights=tuple(float(32 / (3 * c)) for c in counts),
                class_counts=tuple(int(c) for c in counts),
                total_samples=32)
    weights = jax_variables_to_state_dict(_variables("vit"))
    step_images = torch.from_numpy(uint8_images(5, 8, 64))
    step_labels = torch.from_numpy(labels[:8]).long()
    draws = sample_augment_draws(torch.Generator().manual_seed(0), 8, 64,
                                 64, "medium")
    state = _ckpt_state(weights)
    train_step(state, step_images, step_labels,
               StepConfig(intensity="medium", out_size=32,
                          compute_dtype=torch.float32), aug_draws=draws)
    model1_path = save_checkpoint(str(root / "model1"), state)
    outs = launch("tp_fit", str(root), {
        "dir": str(root), "class_names": ["a", "b", "c"], "info": info,
        "train_images": images[:32], "train_labels": labels[:32],
        "val_images": images[32:], "val_labels": labels[32:],
        "fit_cfg": dataclasses.asdict(VIT_CFG),
        "final_cfg": dataclasses.asdict(VIT_CFG), "train": TRAIN,
        "final_params": {"learning_rate": 1e-3, "weight_decay": 1e-4,
                         "batch_size": 8, "max_epochs": 3,
                         "dropout_rate": 0.0,
                         "augmentation_intensity": "low"},
        "ckpt": {"cfg": dataclasses.asdict(VIT_CFG),
                 "state_dict": weights, "train": CKPT_TRAIN,
                 "images": step_images, "labels": step_labels,
                 "aug_draws": draws, "model1_path": model1_path}},
                  world=world)
    return {"root": root, "outs": outs, "images": images,
            "model1_path": model1_path}


def _whole_shapes(cfg) -> dict:
    return {k: tuple(v.shape) for k, v in Classifier(ModelConfig(
        **dataclasses.asdict(cfg))).state_dict().items()}


def test_fit_stops_together_and_returns_a_whole_model(run):
    o0, *others = run["outs"]
    h0 = o0["history"]
    assert 1 <= len(h0["val_acc"]) <= TRAIN["max_epochs"]
    assert o0["val_acc_logged"] == h0["val_acc"]
    shapes = _whole_shapes(VIT_CFG)
    assert {k: tuple(v.shape) for k, v in o0["fit_state"].items()} == shapes
    for out in others:
        for key in ("train_loss", "val_acc", "val_loss"):
            assert out["history"][key] == h0[key], key
        assert out["best"] == o0["best"]
        assert out["val_acc_logged"] == []
        for name, t in o0["fit_state"].items():
            assert torch.equal(t, out["fit_state"][name]), name


def test_checkpoint_at_model2_restores_at_model1_bit_equal(run):
    o0, *others = run["outs"]
    path = o0["ckpt_path"]
    assert os.path.exists(path)
    for out in others:  # only world rank 0 wrote
        assert out["ckpt_path"] != path
        assert not os.path.exists(out["ckpt_path"])
    saved = torch.load(path, weights_only=True)
    shapes = _whole_shapes(VIT_CFG)
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == shapes
    for key, t in _flat(o0["ckpt_whole"]).items():
        assert torch.equal(t, _flat(saved)[key]), key
    state = restore_checkpoint(path, _ckpt_state(saved["model"]))
    restored = state.state_dict()
    assert restored["optimizer"]["count"] == saved["optimizer"]["count"] == 1
    for key, t in _flat(saved).items():
        assert torch.equal(_flat(restored)[key], t), key


def test_checkpoint_at_model1_restores_at_model2_bit_equal(run):
    saved = torch.load(run["model1_path"], weights_only=True)
    for r, out in enumerate(run["outs"]):
        for key, t in _flat(saved).items():
            assert torch.equal(_flat(out["restored_whole"])[key], t), key
        local, whole = _flat(out["restored_local"]), _flat(saved)
        m = r % 2  # the rank's model index
        rows = shard_index(32, 2, m)
        heads = shard_index(3 * 128, 2, m, packs=3)
        for kind in ("model", "mu", "nu"):
            w = whole[f"{kind}/classifier.1.weight"]
            assert torch.equal(local[f"{kind}/classifier.1.weight"],
                               w[rows]), kind
            w4 = whole[f"{kind}/classifier.4.weight"]
            assert torch.equal(local[f"{kind}/classifier.4.weight"],
                               w4[:, rows]), kind
            assert torch.equal(local[f"{kind}/{QKV}"],
                               whole[f"{kind}/{QKV}"][heads]), kind


def test_final_writes_once_whole_artifacts_that_jax_loads(run):
    root, (o0, *others) = run["root"], run["outs"]
    assert o0["final_run"]
    assert len(TrackingClient(str(root / "mlruns0")).search_runs(
        "tp_final")) == 1
    shapes = _whole_shapes(VIT_CFG)
    assert {k: tuple(v.shape) for k, v in o0["final_state"].items()} == \
        shapes
    for r, out in enumerate(others, 1):
        assert out["final_run"] is None
        assert out["final_acc"] == o0["final_acc"]
        assert not (root / f"ckpt{r}").exists()
        assert TrackingClient(str(root / f"mlruns{r}")
                              ).get_experiment_by_name("tp_final") is None
        for name, t in o0["final_state"].items():
            assert torch.equal(t, out["final_state"][name]), name
    step = torch.load(root / "ckpt0" / "step_00000001.pt",
                      weights_only=True)
    assert {k: tuple(v.shape) for k, v in step["model"].items()} == shapes
    npz = str(root / "ckpt0" / "final_model.npz")
    params, _ = jax_load_npz(npz)
    jcfg = jax_infer_config(params, image_size=32, compute_dtype="float32")
    images = run["images"][32:]
    jax_probs = jax_load_predictor(npz, cfg=jcfg,
                                   batch_size=8).predict_probs(images)
    model = get_classifier(ModelConfig(**dataclasses.asdict(VIT_CFG)),
                           device="cpu")
    model.load_state_dict(o0["final_state"])
    probs = infer.Predictor(model=model, device="cpu",
                            batch_size=8).predict_probs(images)
    np.testing.assert_allclose(np.log(probs), np.log(jax_probs), rtol=0,
                               atol=LOGP_TOL)
    npz_probs = infer.load_predictor(
        npz, cfg=ModelConfig(**dataclasses.asdict(VIT_CFG)),
        device="cpu", batch_size=8).predict_probs(images)
    assert np.array_equal(npz_probs, probs)
