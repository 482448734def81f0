"""The port's native batch JPEG decoder (``irp_tpu_torch/data/jpeg.py``,
``csrc/decode.cpp``) against the JAX package's (``irp_tpu/data/jpeg.py``,
``native/``) and PIL, and the decode paths that take it: ``decode_blobs``
and ``build_cache(use_native=True)``.

The port builds its own copy of the decoder with g++ into
``build/irp_tpu_torch/``; the JAX package loads ``native/libirpdecode.so``.
On the same blobs the two libraries must give the same bytes, and both
stay within 1/255 of PIL's bilinear resize.
"""

import glob
import hashlib
import io
import os
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from irp_tpu.data import jpeg as jax_jpeg
from irp_tpu.data import pipeline as jax_pipeline
from irp_tpu_torch.data import analyze, jpeg, pipeline
from tests.synth import make_synthetic_shards
from tests.torch_native import needs_native_decoder

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


pytestmark = needs_native_decoder


def _encode(arr, mode="RGB", **save):
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, format="JPEG", **save)
    return buf.getvalue()


def _blobs():
    """Smooth RGB JPEGs of odd sizes (down- and upsampled, one already at
    the output size), a grayscale one and a progressive one."""
    rng = np.random.default_rng(0)

    def image(h, w):
        small = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3))
        big = np.repeat(np.repeat(small, 8, axis=0), 8, axis=1)[:h, :w]
        return np.clip(big + rng.normal(0, 12, big.shape), 0,
                       255).astype(np.uint8)

    return [_encode(image(121, 93), quality=92),
            _encode(image(300, 257), quality=85),
            _encode(image(64, 64), quality=95),
            _encode(image(31, 17), quality=90),
            _encode(image(90, 140), "L", quality=90),
            _encode(image(77, 101), quality=90, progressive=True)]


def test_the_decoder_is_built_here_and_nothing_else_is_written():
    assert jpeg.native_decoder_available(), jpeg.build_log_tail()
    lib = jpeg.library_path()
    assert os.path.dirname(lib) == os.path.join(REPO, "build",
                                                "irp_tpu_torch")
    assert os.path.exists(lib) and os.path.exists(lib[:-3] + ".log")


def test_a_fresh_build_writes_only_its_build_dir(tmp_path, monkeypatch):
    """A build from scratch (into a fresh build directory) leaves the JAX
    package's native/ files as they were, bytes and mtimes."""
    def snapshot():
        out = {}
        for path in sorted(glob.glob(os.path.join(REPO, "native", "*"))):
            with open(path, "rb") as f:
                out[path] = (hashlib.sha256(f.read()).hexdigest(),
                             os.stat(path).st_mtime_ns)
        return out

    before = snapshot()
    monkeypatch.setattr(jpeg, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(jpeg, "_LIB", None)
    monkeypatch.setattr(jpeg, "_TRIED", False)
    assert jpeg.build() > 0
    assert jpeg.native_decoder_available()
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        os.path.basename(jpeg.library_path())[:-3] + ext
        for ext in (".so", ".log"))
    assert snapshot() == before and before


def test_a_failed_build_is_reported_not_hidden(tmp_path, monkeypatch):
    monkeypatch.setattr(jpeg, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(jpeg, "CXX_FLAGS", jpeg.CXX_FLAGS + ("-DNO",
                                                             "-include",
                                                             "missing.h"))
    monkeypatch.setattr(jpeg, "_LIB", None)
    monkeypatch.setattr(jpeg, "_TRIED", False)
    assert not jpeg.native_decoder_available()
    assert "missing.h" in jpeg.build_log_tail()
    with pytest.raises(RuntimeError, match="missing.h"):
        jpeg.decode_batch_native([b"x"], 8)
    # decode_blobs('auto') decodes with PIL where the library is missing
    blob = _blobs()[0]
    np.testing.assert_array_equal(
        pipeline.decode_blobs([blob], 64),
        pipeline.decode_to_rgb256(blob, 64)[None])


def test_a_failed_build_is_recorded_and_not_retried(tmp_path, monkeypatch):
    """A later process (fresh module state) reads the failure left beside
    the log instead of running the compiler again; removing the
    ``.failed`` file lets the next one try."""
    monkeypatch.setattr(jpeg, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(jpeg, "CXX_FLAGS", jpeg.CXX_FLAGS + ("-include",
                                                             "missing.h"))
    monkeypatch.setattr(jpeg, "_LIB", None)
    monkeypatch.setattr(jpeg, "_TRIED", False)
    assert "missing.h" in jpeg.prepare("auto")
    failed = jpeg.library_path()[:-3] + ".failed"
    assert os.path.exists(failed)

    calls = []
    real_run = subprocess.run
    monkeypatch.setattr(jpeg.subprocess, "run",
                        lambda *a, **k: calls.append(a) or real_run(*a, **k))
    monkeypatch.setattr(jpeg, "_TRIED", False)
    assert not jpeg.native_decoder_available() and calls == []
    with pytest.raises(RuntimeError, match="remove .*failed to try again"):
        jpeg.build()
    assert jpeg.prepare("pil") is None  # PIL asks for no build
    os.remove(failed)
    monkeypatch.setattr(jpeg, "_TRIED", False)
    assert not jpeg.native_decoder_available() and len(calls) == 1


@pytest.mark.parametrize("size", [64, 256])
def test_native_decode_byte_equal_to_jax_and_within_1_of_pil(size):
    blobs = _blobs()
    got, ok = jpeg.decode_batch_native(blobs, size, n_threads=2)
    want, jok = jax_jpeg.decode_batch_native(blobs, size)
    assert ok.all() and jok.all()
    assert got.shape == (len(blobs), size, size, 3)
    np.testing.assert_array_equal(got, want)
    for blob, img in zip(blobs, got):
        ref = pipeline.decode_to_rgb256(blob, size)
        assert np.abs(img.astype(int) - ref.astype(int)).max() <= 1
    one = jpeg.make_native_decoder(size)
    np.testing.assert_array_equal(one(blobs[1]), got[1])
    with pytest.raises(ValueError, match="native JPEG decode failed"):
        one(b"not a jpeg")


def test_corrupt_rows_are_flagged_and_out_rows_untouched():
    blobs = _blobs()[:3]
    blobs[1] = b"not a jpeg at all"
    sentinel = np.full((3, 32, 32, 3), 7, np.uint8)
    out = sentinel.copy()
    imgs, ok = jpeg.decode_batch_native(blobs, 32, out=out)
    assert imgs is out
    assert list(ok) == [True, False, True]
    np.testing.assert_array_equal(out[1], sentinel[1])
    assert (out[0] != 7).any() and (out[2] != 7).any()
    with pytest.raises(ValueError, match="C-contiguous"):
        jpeg.decode_batch_native(blobs, 32, out=out[:, ::2])


def test_decode_blobs_auto_equals_jax_on_a_jpeg_png_mix():
    rng = np.random.default_rng(1)
    png = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (50, 70, 3), np.uint8)).save(
        png, format="PNG")
    blobs = _blobs()[:3] + [png.getvalue()] + _blobs()[4:]
    got = pipeline.decode_blobs(blobs, 96)
    np.testing.assert_array_equal(got, jax_pipeline.decode_blobs(blobs, 96))
    # the PNG took the PIL fallback; 'pil' is PIL for all, as in JAX
    np.testing.assert_array_equal(got[3],
                                  pipeline.decode_to_rgb256(blobs[3], 96))
    np.testing.assert_array_equal(
        pipeline.decode_blobs(blobs, 96, decoder="pil"),
        jax_pipeline.decode_blobs(blobs, 96, decoder="pil"))
    out = np.zeros((len(blobs), 96, 96, 3), np.uint8)
    assert pipeline.decode_blobs(blobs, 96, out=out) is out
    np.testing.assert_array_equal(out, got)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_shards")
    meta = make_synthetic_shards(str(root), num_classes=3, per_class=8,
                                 samples_per_shard=7, seed=5, size=80)
    return meta["shards"]


def test_build_cache_native_equals_jax_and_is_tagged(shards, tmp_path):
    names = analyze.analyze_webdataset(shards).class_names
    got = pipeline.build_cache(shards, names, size=64, use_native=True)
    want = jax_pipeline.build_cache(shards, names, size=64, use_native=True)
    assert got.keys == want.keys and len(got) == 24
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.shard_ids, want.shard_ids)
    pil = pipeline.build_cache(shards, names, size=64)
    assert np.abs(got.images.astype(int) - pil.images.astype(int)).max() \
        <= 1
    # on disk: the JAX package's file names and bytes, the decoder in the
    # name, so a native and a PIL cache of the same shards stay apart
    for pkg, d in ((pipeline, "port"), (jax_pipeline, "jax")):
        pkg.build_cache(shards, names, cache_dir=str(tmp_path / d), size=64,
                        use_native=True)
        pkg.build_cache(shards, names, cache_dir=str(tmp_path / d), size=64)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    metas = [f for f in files if f.endswith(".json")]
    assert len(metas) == 2 and any(f.endswith("_native.json")
                                   for f in metas)
    assert any(f.endswith("_pil.json") for f in metas)
    for f in files:
        with open(tmp_path / "port" / f, "rb") as a, \
                open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read(), f
    # the port reads the JAX package's native cache as its own
    again = pipeline.build_cache(shards, names,
                                 cache_dir=str(tmp_path / "jax"), size=64,
                                 use_native=True)
    np.testing.assert_array_equal(again.images, want.images)
