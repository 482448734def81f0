"""Port parity: the curation CLI (irp_tpu_torch/cli/curation_cli.py) and
the port's copies of the curation, shard and figure modules, on a tiny
JPEG tree on the CPU.

The CLI's outlier stage runs on the CPU (--cpu) with its model config
patched to ResNet18/56 in f32, so that it takes seconds.
"""

import argparse
import dataclasses
import glob
import io
import os
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu.data import curation as jax_curation
from irp_tpu_torch.cli import curation_cli
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.data import curation

torch.set_num_threads(1)

CLASSES = ("cat", "dog", "horse")


@pytest.fixture
def raw_tree(tmp_path):
    """work/raw/<class>/*.jpg: 3 classes x 8 images, 200x240 RGB, each
    class a smooth colour pattern plus noise."""
    rng = np.random.default_rng(0)
    work = tmp_path / "work"
    for ci, cls in enumerate(CLASSES):
        folder = work / "raw" / cls
        folder.mkdir(parents=True)
        base = np.zeros((200, 240, 3))
        base[..., ci] = np.linspace(40, 220, 240)[None, :]
        for i in range(8):
            arr = np.clip(base + rng.normal(0, 25, base.shape), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(
                folder / f"{cls}_{i}.jpg", quality=90)
    return str(work)


def _members(pattern):
    """{member name: bytes} over every shard matching ``pattern``."""
    out = {}
    for path in sorted(glob.glob(pattern)):
        with tarfile.open(path) as tar:
            for m in tar.getmembers():
                out[os.path.relpath(path, os.path.dirname(pattern)) + ":"
                    + m.name] = tar.extractfile(m).read()
    return out


def test_cli_outliers_on_the_cpu(raw_tree, monkeypatch, capsys):
    def small_config(args):
        return ModelConfig(depth=18, num_classes=3, image_size=56,
                           hidden_dim=16, compute_dtype="float32",
                           precision="highest",
                           pretrained_path=args.pretrained)

    monkeypatch.setattr(curation_cli, "_outlier_model_config", small_config)
    rc = curation_cli.main(["--work-dir", raw_tree, "--skip-ingest",
                            "--outliers", "--cpu", "--samples-per-shard",
                            "5", "--test-size", "0.25", "--target-size",
                            "64"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Outlier detection (cpu)" in out and "Done:" in out
    for name in ("dataset_analysis_report.txt",
                 "dataset_cleaning_report.txt", "umap.png", "outliers.png"):
        assert os.path.getsize(os.path.join(raw_tree, name)) > 0, name
    # the clean set (non-outliers) feeds the shards: every class survives
    clean = os.path.join(raw_tree, "clean")
    assert sorted(os.listdir(clean)) == sorted(CLASSES)
    n_clean = sum(len(os.listdir(os.path.join(clean, c))) for c in CLASSES)
    assert 0 < n_clean < 24
    shards = _members(os.path.join(raw_tree, "webdataset", "*.tar"))
    assert sum(name.endswith(".jpg") for name in shards) == n_clean
    for name, data in shards.items():
        if name.endswith(".jpg"):
            assert Image.open(io.BytesIO(data)).size == (64, 64)


def test_cli_default_config_is_the_model_config_default():
    args = argparse.Namespace(pretrained="w.pth")
    cfg = curation_cli._outlier_model_config(args)
    want = dataclasses.replace(ModelConfig(), pretrained_path="w.pth")
    assert cfg == want
    assert (cfg.depth, cfg.image_size, cfg.compute_dtype,
            cfg.fused_frozen_blocks) == (50, 224, "bfloat16", "off")


def test_cli_without_a_card_refuses_the_outlier_stage(raw_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        curation_cli.main(["--work-dir", raw_tree, "--skip-ingest",
                           "--skip-clean", "--outliers"])


def test_shards_match_the_jax_package(raw_tree, tmp_path):
    """The port's copies of process_dataset and verify_webdataset write and
    read the same shard members as the JAX package's, byte for byte."""
    src = os.path.join(raw_tree, "raw")
    kw = dict(test_size=0.25, samples_per_shard=5, target_size=64, seed=3,
              verbose=False)
    got = curation.process_dataset(src, str(tmp_path / "port"), **kw)
    want = jax_curation.process_dataset(src, str(tmp_path / "jax"), **kw)
    assert (got["n_train"], got["n_test"]) == (want["n_train"],
                                               want["n_test"])
    assert _members(str(tmp_path / "port" / "*.tar")) == \
        _members(str(tmp_path / "jax" / "*.tar"))
    for split in ("train", "test"):
        v_got = curation.verify_webdataset(
            str(tmp_path / "port" / f"{split}-*.tar"), target_size=64,
            verbose=False)
        v_want = jax_curation.verify_webdataset(
            str(tmp_path / "jax" / f"{split}-*.tar"), target_size=64,
            verbose=False)
        assert v_got == v_want and v_got["ok"]


def test_analysis_matches_the_jax_package(raw_tree):
    src = os.path.join(raw_tree, "raw")
    got, want = curation.analyze_dataset(src), jax_curation.analyze_dataset(
        src)
    assert got.total_images == want.total_images == 24
    assert got.to_report_dict() == want.to_report_dict()
    assert curation.get_dataset_info(src) == jax_curation.get_dataset_info(
        src)


def test_load_image_dir_cache(raw_tree):
    info = curation.get_dataset_info(os.path.join(raw_tree, "raw"))
    cached = curation_cli.load_image_dir_cache(info)
    assert cached.images.shape == (24, 256, 256, 3)
    assert cached.images.dtype == np.uint8
    assert list(cached.class_names) == sorted(CLASSES)
    assert list(np.bincount(cached.labels)) == [8, 8, 8]
    assert cached.images.std() > 0  # decoded, not zeros


def test_report_renderers_match_the_jax_package(raw_tree, tmp_path, capsys):
    """render_analysis_markdown and display_dataset_report against the JAX
    package's on the same tree: the same Markdown, the same printed
    report and report file, equal tables; the sample grid drawn."""
    src = os.path.join(raw_tree, "raw")
    got, want = curation.analyze_dataset(src), jax_curation.analyze_dataset(
        src)
    assert curation.render_analysis_markdown(got, "grid.png") == \
        jax_curation.render_analysis_markdown(want, "grid.png")
    outs, printed = {}, {}
    for name, pkg, analysis in (("port", curation, got),
                                ("jax", jax_curation, want)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = pkg.display_dataset_report(
            analysis, report_path=str(d / "report.txt"),
            sample_grid_path=str(d / "samples.png"))
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] and "cat" in printed["port"]
    port, jax_out = outs["port"], outs["jax"]
    assert set(port) == set(jax_out) == {"class_table", "quality_table",
                                         "report_path", "sample_grid_path"}
    assert port["class_table"].equals(jax_out["class_table"])
    assert port["quality_table"].equals(jax_out["quality_table"])
    with open(port["report_path"], "rb") as a, \
            open(jax_out["report_path"], "rb") as b:
        assert a.read() == b.read()
    with Image.open(port["sample_grid_path"]) as img:
        assert img.size[0] > 0 and img.size[1] > 0
