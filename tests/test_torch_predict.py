"""Batch prediction of the port (``irp_tpu_torch/infer.py``'s
``PredictionResult.topk``/``label_names``/``keys``,
``Predictor.decode_paths``/``predict_paths``/``predict_shards``, and
``cli/predict_cli.py``) against the JAX package's, on the CPU.

The JAX package writes the weights (ResNet18/56, 3 classes); both CLIs
score the same files with the model at float32 (both packages' inferred
config patched to float32 compute): equal CSV header and keys, equal
labels, probabilities within 1e-4, and equal ``--shards`` accuracy.  The
flag checks exit 2 before any weights are loaded, and
``--data-parallel`` on one device scores as the run without it.
Shards whose ``cls`` is a class name (what the curation writer and
tests/synth.py write) score with ``--classes`` in the port; the JAX
package's ``int(cls)`` raises on them (ROADMAP Queue 3).
"""

import csv
import functools
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu import infer as jax_infer
from irp_tpu.cli import predict_cli as jax_predict_cli
from irp_tpu.config import ModelConfig as JaxModelConfig
from irp_tpu.models.classifier import init_classifier as jax_init
from irp_tpu.train import checkpoint as jax_ckpt
from irp_tpu_torch import infer
from irp_tpu_torch.cli import predict_cli
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.data.tar import ShardWriter, TarWriter
from tests.synth import make_synthetic_shards
from tests.torch_native import needs_native_decoder

torch.set_num_threads(1)
CROP, SIZE = 56, 64
CFG = JaxModelConfig(depth=18, num_classes=3, image_size=CROP,
                     hidden_dim=16, compute_dtype="float32")
NAMES = ["cane", "cavallo", "elefante"]
PROB_TOL = 1e-4


def _jpeg(rng, size=SIZE):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Weights written by the JAX package, 7 image files and two shards
    with integer labels (plus one sample without an image)."""
    root = tmp_path_factory.mktemp("predict")
    _, variables = jax_init(CFG, jax.random.PRNGKey(0), image_size=CROP)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    npz = jax_ckpt.save_weights_npz(str(root / "w.npz"),
                                    variables["params"], stats,
                                    meta={"image_size": CROP})
    pth = jax_ckpt.export_torch_pth(str(root / "w.pth"),
                                    variables["params"], stats, depth=18)
    images = root / "images"
    os.makedirs(images / "sub")
    for i in range(7):
        path = images / ("sub" if i % 2 else "") / f"img{i}.jpg"
        path.write_bytes(_jpeg(rng, SIZE + 8 * i))
    Image.fromarray(rng.integers(0, 256, (80, 70, 3), np.uint8)).save(
        str(images / "extra.png"))
    shards = root / "shards"
    writer = ShardWriter(str(shards), "test", 5)
    with writer:
        for i in range(9):
            writer.write({"__key__": f"s{i:03d}", "jpg": _jpeg(rng),
                          "cls": i % 3})
        writer.write({"__key__": "no_image", "cls": 0})
    return {"root": root, "npz": npz, "pth": pth, "images": str(images),
            "shards": str(shards / "test-*.tar"),
            "shard_paths": writer.shard_paths}


@pytest.fixture
def float32(monkeypatch):
    """Both packages' inferred configs compute in float32."""
    for mod in (infer, jax_infer):
        monkeypatch.setattr(mod, "infer_model_config", functools.partial(
            mod.infer_model_config, compute_dtype="float32"))


def _cli(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr()


def _csv(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_cli_images_csv_equals_jax(world, tmp_path, capsys, float32):
    outs = {}
    for name, main in (("jax", jax_predict_cli.main),
                       ("torch", predict_cli.main)):
        out = str(tmp_path / f"{name}.csv")
        rc, _ = _cli(main, ["--weights", world["npz"], "--images",
                            world["images"], "--topk", "2", "--batch-size",
                            "4", "--classes", ",".join(NAMES), "--out", out,
                            "--decoder", "pil", "--cpu"], capsys)
        assert rc == 0
        outs[name] = _csv(out)
    (header, rows), (jheader, jrows) = outs["torch"], outs["jax"]
    assert header == jheader == ["key", "label", "label_name", "prob",
                                 "top1", "top1_prob", "top2", "top2_prob"]
    assert len(rows) == len(jrows) == 8
    for row, jrow in zip(rows, jrows):
        for key in ("key", "label", "label_name", "top1", "top2"):
            assert row[key] == jrow[key]
        for key in ("prob", "top1_prob", "top2_prob"):
            assert abs(float(row[key]) - float(jrow[key])) <= PROB_TOL


def test_cli_shards_accuracy_equals_jax(world, capsys, float32):
    summaries = {}
    for name, main in (("jax", jax_predict_cli.main),
                       ("torch", predict_cli.main)):
        rc, printed = _cli(main, ["--weights", world["pth"], "--shards",
                                  world["shards"], "--image-size",
                                  str(CROP), "--batch-size", "4",
                                  "--decoder", "pil", "--cpu"], capsys)
        assert rc == 0
        summaries[name] = json.loads(printed.out.strip().splitlines()[-1])
    got, want = summaries["torch"], summaries["jax"]
    assert got["n"] == want["n"] == 9  # the sample without an image skipped
    assert got["accuracy"] == want["accuracy"]
    assert set(got) == set(want) == {"n", "elapsed_s", "imgs_per_sec",
                                     "accuracy"}


def test_name_labelled_shards_score_with_classes(world, tmp_path, capsys):
    meta = make_synthetic_shards(str(tmp_path), num_classes=3, per_class=3,
                                 samples_per_shard=9, seed=5, size=SIZE,
                                 prefix="test")
    pred = infer.load_predictor(world["npz"], class_names=meta[
        "class_names"], batch_size=9, device="cpu")
    result, truth = pred.predict_shards(meta["shards"])
    names = [k.rsplit("_", 1)[0] for k in result.keys]
    assert truth.tolist() == [meta["class_names"].index(n) for n in names]
    rc, printed = _cli(predict_cli.main, [
        "--weights", world["npz"], "--shards", meta["shards"][0],
        "--classes", ",".join(meta["class_names"]), "--batch-size", "9",
        "--cpu"], capsys)
    assert rc == 0
    summary = json.loads(printed.out.strip().splitlines()[-1])
    assert summary["accuracy"] == round(float(np.mean(
        result.labels == truth)), 4)
    # without class names the labels cannot be read: no accuracy
    assert infer.load_predictor(world["npz"], batch_size=9,
                                device="cpu").predict_shards(
        meta["shards"])[1] is None
    # the JAX package reads cls with int() and raises on a class name
    with pytest.raises(ValueError, match="invalid literal"):
        jax_infer.load_predictor(world["npz"]).predict_shards(
            meta["shards"])


@pytest.mark.parametrize("argv,item", [
    (["--export", "m.irpx", "--images", "x"], "standalone mode"),
    (["--export-source-size", "256", "--images", "x"], "needs --export"),
    (["--export-batch-buckets", "auto", "--images", "x"], "needs --export"),
    (["--export-no-gradcam", "--images", "x"], "needs --export"),
    (["--gradcam", "cams", "--shards", "x"], "requires --images"),
    (["--data-parallel", "--export", "m.irpx"], "single-device program"),
])
def test_waiting_flags_exit_2_before_loading(tmp_path, capsys, argv, item):
    """Each flag's argument check exits 2 before any load, with the JAX
    CLI's message (--export-source-size and --export-no-gradcam without
    --export are refused too, as --export-batch-buckets is there;
    --data-parallel with --export, as in the JAX CLI)."""
    missing = str(tmp_path / "missing.npz")  # a load would raise
    rc, printed = _cli(predict_cli.main, ["--weights", missing, "--cpu",
                                          *argv], capsys)
    assert rc == 2
    assert item in printed.err


def test_data_parallel_on_one_device_scores_alike(world, tmp_path, capsys):
    """--data-parallel on the default mesh of one device (the CPU here)
    writes the CSV the run without it writes."""
    outs = []
    for extra in ([], ["--data-parallel"]):
        out = str(tmp_path / f"dp{len(extra)}.csv")
        rc, _ = _cli(predict_cli.main, [
            "--weights", world["npz"], "--images", world["images"],
            "--batch-size", "4", "--out", out, "--decoder", "pil", "--cpu",
            *extra], capsys)
        assert rc == 0
        outs.append(_csv(out))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("argv,match", [
    (["--weights", "m.irpx", "--images", "x"], "m.irpx"),
    (["--weights", "w.npz"], "--images / --shards"),
])
def test_other_refusals_exit_2(capsys, argv, match):
    rc, printed = _cli(predict_cli.main, [*argv, "--cpu"], capsys)
    assert rc == 2 and match in printed.err


def test_cli_runs_on_the_card_unless_told(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_cli.main(["--weights", world["npz"], "--images",
                          world["images"]])


@pytest.mark.parametrize("class_names", [None, NAMES])
def test_topk_and_label_names_equal_jax(class_names):
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(3), 6).astype(np.float32)
    labels = probs.argmax(axis=1).astype(np.int32)
    got = infer.PredictionResult(labels, probs, class_names, ["a"] * 6)
    want = jax_infer.PredictionResult(labels, probs, class_names, ["a"] * 6)
    for k in (1, 2, 5):
        for g, w in zip(got.topk(k), want.topk(k)):
            assert np.array_equal(g, w)
    assert got.label_names() == want.label_names()
    assert len(got) == 6 and got.keys == want.keys


def _predictors(world):
    port_cfg = ModelConfig(depth=18, num_classes=3, image_size=CROP,
                           hidden_dim=16, compute_dtype="float32")
    return (infer.load_predictor(world["npz"], cfg=port_cfg, batch_size=4,
                                 device="cpu"),
            jax_infer.load_predictor(world["npz"], cfg=CFG, batch_size=4))


def test_predict_paths_and_shards_equal_jax(world, monkeypatch):
    pred, jpred = _predictors(world)
    paths = sorted(os.path.join(r, f) for r, _, fs in os.walk(
        world["images"]) for f in fs)
    # PIL on both sides (the 'auto' case is the test below)
    decoded = pred.decode_paths(paths, decoder="pil")
    assert decoded.shape == (8, 256, 256, 3)
    assert np.array_equal(decoded, jpred.decode_paths(paths, decoder="pil"))
    got = pred.predict_paths(paths, decoder="pil")
    want = jpred.predict_paths(paths, decoder="pil")
    assert got.keys == want.keys == paths
    assert np.array_equal(got.labels, want.labels)
    assert np.abs(got.probs - want.probs).max() <= PROB_TOL
    # streamed in chunks, the same result
    monkeypatch.setattr(infer.Predictor, "_chunk", lambda self: 3)
    chunked = pred.predict_paths(paths, decoder="pil")
    assert np.array_equal(chunked.probs, got.probs)
    for chunk in (3, 1024):
        monkeypatch.setattr(infer.Predictor, "_chunk",
                            lambda self, c=chunk: c)
        (res, truth) = pred.predict_shards(world["shards"], decoder="pil")
        (jres, jtruth) = jpred.predict_shards(world["shards"],
                                              decoder="pil")
        assert res.keys == jres.keys == [f"s{i:03d}" for i in range(9)]
        assert np.array_equal(truth, jtruth)
        assert np.array_equal(res.labels, jres.labels)
        assert np.abs(res.probs - jres.probs).max() <= PROB_TOL


@needs_native_decoder
def test_predict_paths_and_shards_auto_decoder_equal_jax(world,
                                                         monkeypatch):
    """At both packages' default decoder, 'auto': the native batch decoder
    with PIL for what it cannot decode, the same pixels in both."""
    from irp_tpu_torch.data import jpeg

    assert jpeg.native_decoder_available(), jpeg.build_log_tail()
    pred, jpred = _predictors(world)
    paths = sorted(os.path.join(r, f) for r, _, fs in os.walk(
        world["images"]) for f in fs)
    decoded = pred.decode_paths(paths)
    assert np.array_equal(decoded, jpred.decode_paths(paths))
    assert np.abs(decoded.astype(int) - pred.decode_paths(
        paths, decoder="pil").astype(int)).max() <= 1
    got, want = pred.predict_paths(paths), jpred.predict_paths(paths)
    assert got.keys == want.keys == paths
    assert np.array_equal(got.labels, want.labels)
    assert np.abs(got.probs - want.probs).max() <= PROB_TOL
    monkeypatch.setattr(infer.Predictor, "_chunk", lambda self: 3)
    (res, truth) = pred.predict_shards(world["shards"])
    (jres, jtruth) = jpred.predict_shards(world["shards"])
    assert res.keys == jres.keys and np.array_equal(truth, jtruth)
    assert np.array_equal(res.labels, jres.labels)
    assert np.abs(res.probs - jres.probs).max() <= PROB_TOL


def test_predict_shards_literal_paths_and_globs(world, tmp_path):
    pred, _ = _predictors(world)
    odd = tmp_path / "run[3]"
    odd.mkdir()
    shard = str(odd / "test-000000.tar")
    rng = np.random.default_rng(11)
    with TarWriter(shard) as w:
        for i in range(3):
            w.write({"__key__": f"k{i}", "jpg": _jpeg(rng), "cls": i})
    result, truth = pred.predict_shards(shard)  # a literal path with '['
    assert len(result) == 3 and truth.tolist() == [0, 1, 2]
    result, truth = pred.predict_shards(world["shard_paths"])
    assert len(result) == 9 and truth is not None
    empty, truth = pred.predict_shards(str(tmp_path / "none-*.tar"))
    assert len(empty) == 0 and empty.probs.shape == (0, 3) and truth is None
    with pytest.raises(FileNotFoundError):
        pred.predict_shards(str(tmp_path / "missing.tar"))
