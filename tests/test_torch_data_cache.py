"""The port's shard data plane against the JAX package's:
``analyze_webdataset``, ``create_stratified_kfolds``, ``build_cache``
(file for file, byte for byte, and loadable by the other package) and
``CachedDataset.subset_by_shards``.  Exact equality throughout, on
``tests/synth.py`` shards at 64 px.
"""

import dataclasses
import io
import os
import tarfile

import numpy as np
import pytest
import torch

from irp_tpu.data import analyze as jax_analyze
from irp_tpu.data import kfold as jax_kfold
from irp_tpu.data import pipeline as jax_pipeline
from irp_tpu.data import tar as jax_tar
from irp_tpu_torch.data import analyze, kfold, pipeline
from irp_tpu_torch.data import tar as torch_tar
from tests.synth import make_synthetic_shards

torch.set_num_threads(1)
SIZE = 64


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache_shards")
    # uneven class sizes, so that the frequency order and the weights
    # carry information
    meta = make_synthetic_shards(str(root), num_classes=3, per_class=14,
                                 samples_per_shard=6, seed=4, size=SIZE)
    extra = make_synthetic_shards(str(root / "more"), num_classes=2,
                                  per_class=5, samples_per_shard=5, seed=5,
                                  size=SIZE, prefix="train-x")
    return meta["shards"] + extra["shards"]


def test_analyze_webdataset_equals_jax(shards):
    got = analyze.analyze_webdataset(shards)
    want = jax_analyze.analyze_webdataset(shards)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    root = os.path.dirname(shards[0])
    assert analyze.resolve_shards(root) == jax_analyze.resolve_shards(root)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("seed", [0, 42])
def test_stratified_kfolds_equal_jax(shards, k, seed):
    got = kfold.create_stratified_kfolds(shards, k=k, seed=seed)
    assert got == jax_kfold.create_stratified_kfolds(shards, k=k, seed=seed)
    assert sorted(s for f in got for s in f) == sorted(shards)


def _files(d):
    return sorted(os.listdir(d))


def test_build_cache_writes_the_jax_files_byte_for_byte(shards, tmp_path):
    names = analyze.analyze_webdataset(shards).class_names
    got = pipeline.build_cache(shards, names, cache_dir=str(tmp_path / "t"),
                               size=SIZE)
    want = jax_pipeline.build_cache(shards, names,
                                    cache_dir=str(tmp_path / "j"), size=SIZE)
    files = _files(tmp_path / "t")
    assert files == _files(tmp_path / "j") and len(files) == 3
    assert any(f.endswith("_pil.img.npy") for f in files)
    for f in files:
        a = (tmp_path / "t" / f).read_bytes()
        assert a == (tmp_path / "j" / f).read_bytes(), f
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.shard_ids, want.shard_ids)
    assert got.keys == want.keys and got.shard_paths == want.shard_paths


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_cache_loads_in_the_other_package(shards, tmp_path, monkeypatch,
                                            writer):
    names = analyze.analyze_webdataset(shards).class_names
    cache_dir = str(tmp_path / "c")
    build = {"jax": jax_pipeline.build_cache,
             "torch": pipeline.build_cache}
    written = build[writer](shards, names, cache_dir=cache_dir, size=SIZE)

    def no_reads(_path):
        raise AssertionError("the cache on disk was not used")

    # the reader must load the files, not decode the shards again
    monkeypatch.setattr(jax_tar, "iter_shard", no_reads)
    monkeypatch.setattr(torch_tar, "iter_shard", no_reads)
    reader = build["torch" if writer == "jax" else "jax"]
    loaded = reader(shards, names, cache_dir=cache_dir, size=SIZE)
    assert isinstance(loaded.images, np.memmap)
    np.testing.assert_array_equal(loaded.images, written.images)
    np.testing.assert_array_equal(loaded.labels, written.labels)
    np.testing.assert_array_equal(loaded.shard_ids, written.shard_ids)
    assert loaded.keys == written.keys
    assert tuple(loaded.shard_paths) == tuple(written.shard_paths)


def _corrupt_shard(shard, out):
    """A copy of ``shard`` whose second sample's JPEG is cut short."""
    with tarfile.open(shard) as src, tarfile.open(out, "w") as dst:
        jpgs = 0
        for m in src:
            data = src.extractfile(m).read()
            if m.name.endswith(".jpg"):
                jpgs += 1
                if jpgs == 2:
                    data = data[:40]
            info = tarfile.TarInfo(m.name)
            info.size = len(data)
            info.mtime = m.mtime
            dst.addfile(info, io.BytesIO(data))
    return out


def test_a_corrupt_jpeg_is_skipped_as_in_jax(shards, tmp_path, capsys):
    """The same warning line and the same samples as the JAX package's
    in-memory build.  The JAX package's build with a cache directory
    fails at this point (its right-sized copy reads past the written
    rows, ROADMAP Queue 3); the port's writes the right-sized cache."""
    bad = _corrupt_shard(shards[1], str(tmp_path / "train-bad.tar"))
    paths = [shards[0], bad, shards[2]]
    names = jax_analyze.analyze_webdataset(paths).class_names
    want = jax_pipeline.build_cache(paths, names, size=SIZE)
    want_out = capsys.readouterr().out
    for cache_dir in (None, str(tmp_path / "t")):
        got = pipeline.build_cache(paths, names, cache_dir=cache_dir,
                                   size=SIZE)
        got_out = capsys.readouterr().out
        assert "WARNING: build_cache skipped 1 undecodable sample(s)" \
            in got_out
        assert got_out == want_out
        assert len(got) == len(want) == 17
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.shard_ids, want.shard_ids)
        assert got.keys == want.keys
    files = _files(tmp_path / "t")
    assert len(files) == 3 and not any(f.endswith(".tmp.npy") for f in files)
    img = np.load(str(tmp_path / "t" / [f for f in files
                                        if f.endswith(".img.npy")][0]))
    np.testing.assert_array_equal(img, want.images)


@pytest.mark.parametrize("with_images", [True, False])
def test_subset_by_shards_equals_jax(shards, with_images):
    names = analyze.analyze_webdataset(shards).class_names
    got = pipeline.build_cache(shards, names, size=SIZE)
    want = jax_pipeline.build_cache(shards, names, size=SIZE)
    part = shards[1::2]
    a = got.subset_by_shards(part, with_images=with_images)
    b = want.subset_by_shards(part, with_images=with_images)
    assert a.keys == b.keys and len(a) > 0
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.shard_ids, b.shard_ids)
    if with_images:
        np.testing.assert_array_equal(a.images, b.images)
    else:
        assert a.images is None and b.images is None


def test_the_native_decoder_is_refused_not_swapped(shards, monkeypatch):
    names = analyze.analyze_webdataset(shards).class_names
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.build_cache(shards[:1], names, use_native=True)
    monkeypatch.setenv("IRP_NATIVE_DECODE", "1")
    with pytest.raises(NotImplementedError, match="IRP_NATIVE_DECODE"):
        pipeline.build_cache(shards[:1], names)
    # a caller's own decoder is not the native one
    got = pipeline.build_cache(shards[:1], names, size=SIZE,
                               decoder=pipeline.decode_to_rgb256)
    assert len(got) == 6
