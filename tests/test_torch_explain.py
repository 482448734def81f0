"""Port parity: Grad-CAM (irp_tpu_torch/explain.py, the Grad-CAM surface of
models/classifier.py and predict_cli --gradcam) against the JAX package's
irp_tpu/explain.py on the CPU.

Sizes are tests/test_explain.py's: ResNet18 at a 64 crop (a 2x2 map),
3 classes, hidden 16, float32, K1 'off', with a positive head so that the
maps are not all zero.  The same seeded weights go to both packages
(tests/test_torch_serve.py's route); CAMs agree within 1e-4 and logits
within 1e-3 (the fidelity bar).  At depth 50 with K1 'on' the live
Grad-CAM runs the op irp_tpu_torch::identity_bottleneck 10 times a batch.
"""

import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu import explain as jax_explain
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.infer import make_predictor as jax_make_predictor
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu.train import checkpoint as jax_ckpt
from irp_tpu_torch import explain
from irp_tpu_torch.cli import predict_cli
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.infer import Predictor, make_predictor
from irp_tpu_torch.models.classifier import init_classifier

torch.set_num_threads(1)
TINY = JaxModelConfig(depth=18, num_classes=3, image_size=64, hidden_dim=16,
                      compute_dtype="float32")
NAMES = ["cat", "dog", "fox"]
CAM_TOL, LOGIT_TOL = 1e-4, 1e-3


def _variables():
    """JAX-initialized weights with a positive head (tests/test_explain.py's
    fixture): post-ReLU maps and positive channel weights give maps that
    are not all zero."""
    _, variables = jax_init(TINY, jax.random.PRNGKey(0), image_size=64)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(1)
    params = variables["params"]
    for name in ("head_dense1", "head_dense2"):
        k = params[name]["kernel"]
        params[name] = {
            "kernel": (np.abs(rng.normal(size=k.shape)) * 0.1).astype(
                np.float32),
            "bias": np.zeros_like(params[name]["bias"])}
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def pair():
    variables = _variables()
    ours = make_predictor(variables, class_names=NAMES,
                          cfg=ModelConfig(**dataclasses.asdict(TINY)),
                          batch_size=4, device="cpu")
    theirs = jax_make_predictor(variables, class_names=NAMES, cfg=TINY,
                                batch_size=4)
    return ours, theirs


@pytest.fixture(scope="module")
def images80():
    return np.random.default_rng(42).integers(0, 256, (5, 80, 80, 3),
                                              dtype=np.uint8)


def _x(pred, images):
    from irp_tpu_torch.ops.preprocess import eval_preprocess_batch

    return eval_preprocess_batch(torch.from_numpy(images), 64,
                                 torch.float32).permute(0, 3, 1, 2)


def test_head_from_spatial_equals_forward_bit_for_bit(pair, images80):
    model = pair[0].model
    with torch.inference_mode():
        x = _x(pair[0], images80)
        want = model(x)
        got = model.head_from_spatial(model.spatial_features(x))
    assert got.shape == (5, 3) and torch.equal(got, want)
    assert model.spatial_features(x).shape == (5, 512, 2, 2)


def test_closed_form_head_grad_equals_autograd():
    """d logit_c / d pool(A) = W1^T ((z > 0) * W2[c]) against
    torch.autograd of the eval head, with a random-signed head so that
    the ReLU gate closes some units."""
    cfg = ModelConfig(**dataclasses.asdict(TINY))
    model = init_classifier(cfg, torch.Generator().manual_seed(3),
                            device="cpu").eval()
    rng = np.random.default_rng(4)
    acts = torch.from_numpy(rng.uniform(0, 2, (6, 512, 2, 2)).astype(
        np.float32))
    cls = torch.tensor([-1, 0, 1, 2, -1, 1])
    logits, d_pooled = explain.head_logits_and_grad(model, acts, cls)
    a = acts.clone().requires_grad_(True)
    want_logits = model.head_from_spatial(a)
    target = torch.where(cls < 0, want_logits.argmax(-1), cls)
    want_logits.gather(1, target[:, None]).sum().backward()
    gate = model.classifier[1](model.backbone.pool(acts)) > 0
    assert 0 < int(gate.sum()) < gate.numel()  # the gate is exercised
    assert torch.equal(logits, want_logits.detach())
    # the map's gradient is the pooled one over h*w at every position
    want = a.grad
    got = (d_pooled.detach() / 4)[:, :, None, None].expand_as(want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("class_idx", [None, 1, [0, -1, 2, -1, 1]],
                         ids=["argmax", "explicit", "mixed"])
def test_gradcam_matches_jax(pair, images80, class_idx):
    """5 images at batch 4: the tail pads to the GradCAM's batch."""
    ours, theirs = pair
    cams, logits = explain.GradCAM(ours).explain(images80, class_idx)
    want_cams, want_logits = jax_explain.GradCAM(theirs).explain(
        images80, class_idx)
    assert cams.shape == (5, 64, 64) and cams.dtype == np.float32
    assert cams.min() >= 0.0 and cams.max() <= 1.0
    assert np.abs(cams - np.asarray(want_cams)).max() <= CAM_TOL
    assert np.abs(logits - np.asarray(want_logits)).max() <= LOGIT_TOL
    # each map is min-max normalized: it reaches 1 (the 2x2 map's corners
    # land on the output's, where the bilinear upsample clamps)
    assert np.allclose(cams.max(axis=(1, 2)), 1.0)


def test_gradcam_is_padding_invariant_and_validates(pair, images80):
    ours = pair[0]
    full, _ = explain.GradCAM(ours, batch_size=8).explain(images80)
    ones = np.concatenate([explain.GradCAM(ours, batch_size=1).explain(
        images80[i:i + 1])[0] for i in range(5)])
    np.testing.assert_allclose(full, ones, rtol=0, atol=1e-6)
    gc = explain.GradCAM(ours)
    empty, lg = gc.explain(images80[:0])
    assert empty.shape == (0, 64, 64) and lg.shape == (0, 3)
    for bad in (3, -2):
        with pytest.raises(ValueError, match="class_idx"):
            gc.explain(images80, bad)
    with pytest.raises(ValueError, match="shape"):
        gc.explain(images80, [0, 1])
    with pytest.raises(ValueError, match="crop"):
        gc.explain(images80[:, :60])
    with pytest.raises(ValueError, match="batch_size"):
        explain.GradCAM(ours, batch_size=0)


def test_center_crop_and_overlay_bytes_equal_jax():
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (80, 90, 3), np.uint8)
    np.testing.assert_array_equal(explain.center_crop_u8(image, 64),
                                  jax_explain.center_crop_u8(image, 64))
    batch = rng.integers(0, 256, (2, 70, 70, 3), np.uint8)
    np.testing.assert_array_equal(explain.center_crop_u8(batch, 64),
                                  jax_explain.center_crop_u8(batch, 64))
    for cam in (rng.uniform(0, 1, (80, 90)).astype(np.float32),
                rng.uniform(-0.2, 1.2, (7, 5)).astype(np.float32)):
        got = explain.overlay_cam(image, cam)
        assert got.dtype == np.uint8 and got.shape == (80, 90, 3)
        np.testing.assert_array_equal(got, jax_explain.overlay_cam(image,
                                                                   cam))


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the calls of the port's ops under it."""

    def __init__(self):
        super().__init__()
        self.calls = {"identity_bottleneck": 0, "eval_preprocess": 0,
                      "frozen_epilogue": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith("irp_tpu_torch::"):
            self.calls[name.split("::")[1]] += 1
        return func(*args, **(kwargs or {}))


def test_depth50_gradcam_runs_k1_and_k2_ops():
    """K1 'on' at depth 50 (64 crop, bf16): each batch of the live
    Grad-CAM calls the K1 op 10 times, the frozen prefix's epilogue op 10
    times (the stem, 3 in each block 0) and the K2 op once, and its
    logits are the predictor's own."""
    cfg = ModelConfig(depth=50, num_classes=3, image_size=64, hidden_dim=16,
                      fused_frozen_blocks="on")
    model = init_classifier(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    pred = Predictor(model=model, batch_size=2, device="cpu")
    images = np.random.default_rng(6).integers(0, 256, (3, 64, 64, 3),
                                               np.uint8)
    counter = _Counter()
    with counter:
        cams, logits = explain.GradCAM(pred).explain(images)
    assert counter.calls == {"identity_bottleneck": 20, "eval_preprocess": 2,
                             "frozen_epilogue": 20}
    assert cams.shape == (3, 64, 64) and np.isfinite(cams).all()
    probs = pred.predict_probs(images)
    np.testing.assert_array_equal(
        np.argmax(logits, 1), np.argmax(probs, 1))
    np.testing.assert_allclose(torch.softmax(torch.from_numpy(logits), -1),
                               probs, rtol=0, atol=1e-6)


def test_predict_cli_gradcam_writes_one_png_per_image(tmp_path, capsys):
    """--gradcam: one overlay PNG per image at the crop size, and the
    same CSV labels as the plain scoring run."""
    variables = _variables()
    npz = jax_ckpt.save_weights_npz(str(tmp_path / "w.npz"),
                                    variables["params"],
                                    variables["batch_stats"],
                                    meta={"image_size": 64})
    rng = np.random.default_rng(7)
    images = tmp_path / "images"
    os.makedirs(images / "sub")
    for i in range(5):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (96, 96, 3), np.uint8)).save(
            buf, "JPEG")
        (images / ("sub" if i % 2 else "") / f"img{i}.jpg").write_bytes(
            buf.getvalue())
    base = ["--weights", npz, "--images", str(images), "--cpu",
            "--batch-size", "2", "--classes", ",".join(NAMES)]
    cams = tmp_path / "cams"
    assert predict_cli.main(base + ["--gradcam", str(cams),
                                    "--out", str(tmp_path / "g.csv")]) == 0
    assert predict_cli.main(base + ["--out", str(tmp_path / "p.csv")]) == 0
    pngs = sorted(os.listdir(cams))
    assert len(pngs) == 5 and all(p.endswith("_gradcam.png") for p in pngs)
    assert Image.open(cams / pngs[0]).size == (64, 64)
    assert "wrote 5 Grad-CAM overlays" in capsys.readouterr().out

    def labels(name):
        import csv

        with open(tmp_path / name) as f:
            return [(r["key"], r["label"]) for r in csv.DictReader(f)]

    assert labels("g.csv") == labels("p.csv")
