"""The per-sample augmentation path of the port against the JAX package's
(``ops/preprocess.py::augment_batch`` and its parts).

The JAX ``augment_batch`` splits its key per image and each image's key
five ways (flip, vflip, crop, jitter, rotation); the tests re-derive those
draws by the same splits and calls and hand them to the port.  The JAX
functions run op by op (``jax.disable_jit``): under ``jax.jit`` XLA's CPU
backend contracts products and sums into FMAs, which moves values by an
ulp and, at the rotation's exact .5 ties, the pixel chosen.  Bars: f32
within 1e-5; a bf16 output within one bf16 ulp of the JAX package's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from irp_tpu.ops import preprocess as jpre
from irp_tpu_torch.ops import preprocess as tpre

from tests.torch_jax_train import uint8_images

torch.set_num_threads(1)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)
_SCALE = {"medium": (0.8, 1.0), "high": (0.7, 1.0)}
_JITTER = {"medium": (0.1, 0.0), "high": (0.2, 0.1)}
_RATIO = (3 / 4, 4 / 3)


def _uniform(key, lo, hi):
    """One uniform draw, op by op as the JAX functions run here (jitted,
    ``floats * (hi - lo) + lo`` becomes an FMA, an ulp away)."""
    with jax.disable_jit():
        return float(jax.random.uniform(key, (), minval=lo, maxval=hi))


def jax_sample_draws(key, intensity: str, b: int) -> tpre.SampleDraws:
    """The draws ``irp_tpu.ops.preprocess.augment_batch(images, key,
    intensity)`` makes for each of its ``b`` images, as SampleDraws."""
    rows = []
    for k in jax.random.split(key, b):
        k_h, k_v, k_crop, k_jit, k_rot = jax.random.split(k, 5)
        row = {"hflip": bool(jax.random.bernoulli(k_h))}
        if intensity != "low":
            if intensity == "high":
                row["vflip"] = bool(jax.random.bernoulli(k_v, p=0.2))
            k1, k2, k3, k4 = jax.random.split(k_crop, 4)
            row["area"] = _uniform(k1, *_SCALE[intensity])
            row["log_ratio"] = _uniform(k2, jnp.log(_RATIO[0]),
                                        jnp.log(_RATIO[1]))
            row["top"] = _uniform(k3, 0.0, 1.0)
            row["left"] = _uniform(k4, 0.0, 1.0)
            v, hue = _JITTER[intensity]
            kb, kc, ks, kh = jax.random.split(k_jit, 4)
            row["brightness"] = _uniform(kb, max(0.0, 1 - v), 1 + v)
            row["contrast"] = _uniform(kc, max(0.0, 1 - v), 1 + v)
            row["saturation"] = _uniform(ks, max(0.0, 1 - v), 1 + v)
            if hue > 0:
                row["hue"] = _uniform(kh, -hue, hue)
                row["angles"] = _uniform(k_rot, -15.0, 15.0)
        rows.append(row)
    return tpre.SampleDraws(**{
        name: torch.tensor([r[name] for r in rows],
                           dtype=torch.bool if name.endswith("flip")
                           else torch.float32)
        for name in rows[0]})


@pytest.mark.parametrize("intensity", ["low", "medium", "high"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augment_batch_matches_jax_on_its_draws(intensity, dtype):
    b, size, out = 4, 48, 40
    images = uint8_images(0, b, size)
    key = jax.random.PRNGKey(7)
    with jax.disable_jit():
        want = np.asarray(jpre.augment_batch(
            jnp.asarray(images), key, intensity, out,
            dtype=getattr(jnp, dtype)).astype(jnp.float32))
    draws = jax_sample_draws(key, intensity, b)
    got = tpre.augment_batch(torch.from_numpy(images), draws, intensity,
                             out, dtype=getattr(torch, dtype)).float()
    assert got.shape == want.shape == (b, out, out, 3)
    diff = np.abs(got.numpy() - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
        assert (diff / ulp).max() <= 1.0


@pytest.mark.parametrize("crop", [(0.55, 1.0), (0.8, 0.2), (1.0, 1.0)])
def test_random_resized_crop_matches_jax(crop):
    """Crops larger than the output (the antialiased, widened kernel),
    smaller (plain bilinear) and the whole image."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (50, 60, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    for out in (32, 64):
        with jax.disable_jit():
            want = np.asarray(jpre.random_resized_crop(
                jnp.asarray(img), key, out, scale=crop))
        k1, k2, k3, k4 = jax.random.split(key, 4)
        t = torch.tensor
        got = tpre.random_resized_crop(
            torch.from_numpy(img)[None], t([_uniform(k1, *crop)]),
            t([_uniform(k2, jnp.log(_RATIO[0]), jnp.log(_RATIO[1]))]),
            t([_uniform(k3, 0.0, 1.0)]), t([_uniform(k4, 0.0, 1.0)]),
            out)[0].numpy()
        assert got.shape == want.shape == (out, out, 3)
        assert np.abs(got - want).max() <= 1e-5


def test_scale_translate_weights_match_jax():
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    for in_size, out_size, scale, trans in ((256, 224, 224 / 243.7, -3.1),
                                            (40, 64, 1.6, -8.0),
                                            (30, 30, 1.0, 0.0)):
        want = np.asarray(compute_weight_mat(
            in_size, out_size, jnp.float32(scale), jnp.float32(trans),
            _fill_triangle_kernel, True)).T
        got = tpre.scale_translate_weights(
            in_size, out_size, torch.tensor([scale]), torch.tensor([trans])
        )[0].numpy()
        assert np.abs(got - want).max() <= 1e-6


def test_color_jitter_and_adjust_hue_match_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (20, 24, 3)).astype(np.float32)
    img[:3] = 0.5  # grey: no saturation, hue masked to 0
    key = jax.random.PRNGKey(2)
    with jax.disable_jit():
        want = np.asarray(jpre.color_jitter(jnp.asarray(img), key, 0.2,
                                            0.2, 0.2, 0.1))
    kb, kc, ks, kh = jax.random.split(key, 4)
    got = tpre.color_jitter(
        torch.from_numpy(img), _uniform(kb, 0.8, 1.2),
        _uniform(kc, 0.8, 1.2), _uniform(ks, 0.8, 1.2),
        _uniform(kh, -0.1, 0.1)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    # brightness alone, as the 'medium' intensity's hue-free jitter
    with jax.disable_jit():
        want = np.asarray(jpre.color_jitter(jnp.asarray(img), key, 0.1,
                                            0.0, 0.0, 0.0))
    got = tpre.color_jitter(torch.from_numpy(img),
                            _uniform(kb, 0.9, 1.1)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    for shift in (-0.1, 0.05, 0.5):
        want = np.asarray(jpre.adjust_hue(jnp.asarray(img), shift))
        got = tpre.adjust_hue(torch.from_numpy(img), shift).numpy()
        assert np.abs(got - want).max() <= 1e-5
    # per-image shifts over a batch, each image as alone
    batch = np.stack([img, img[::-1].copy()])
    got = tpre.adjust_hue(torch.from_numpy(batch),
                          torch.tensor([0.05, -0.2])).numpy()
    for i, shift in enumerate((0.05, -0.2)):
        want = np.asarray(jpre.adjust_hue(jnp.asarray(batch[i]), shift))
        assert np.abs(got[i] - want).max() <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_matches_jax(dtype):
    images = uint8_images(5, 2, 16)
    want = np.asarray(jpre.normalize(jnp.asarray(images),
                                     dtype=getattr(jnp, dtype))
                      .astype(jnp.float32))
    got = tpre.normalize(torch.from_numpy(images),
                         dtype=getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, want)


def _within_4_sigma(a, mean, var):
    a = np.asarray(a, np.float64)
    assert abs(a.mean() - mean) <= 4 * math.sqrt(var / len(a))


def test_sample_per_image_draws_follow_the_jax_laws():
    n = 20000
    gen = torch.Generator().manual_seed(0)
    for intensity in ("medium", "high"):
        d = tpre.sample_per_image_draws(gen, n, intensity)
        _within_4_sigma(d.hflip.float(), 0.5, 0.25)
        lo, hi = _SCALE[intensity]
        v, hue = _JITTER[intensity]
        laws = [(d.area, lo, hi), (d.top, 0.0, 1.0), (d.left, 0.0, 1.0),
                (d.log_ratio, math.log(_RATIO[0]), math.log(_RATIO[1])),
                (d.brightness, 1 - v, 1 + v), (d.contrast, 1 - v, 1 + v),
                (d.saturation, 1 - v, 1 + v)]
        if intensity == "high":
            _within_4_sigma(d.vflip.float(), 0.2, 0.16)
            laws += [(d.hue, -hue, hue), (d.angles, -15.0, 15.0)]
        else:
            assert d.vflip is None and d.hue is None and d.angles is None
        for t, a, b in laws:
            x = t.numpy()
            assert a <= x.min() and x.max() <= b
            _within_4_sigma(x, (a + b) / 2, (b - a) ** 2 / 12)
            assert stats.kstest(x, stats.uniform(a, b - a).cdf).pvalue > 1e-3
    low = tpre.sample_per_image_draws(gen, 8, "low")
    assert low.area is None and low.brightness is None
    # a batch augmented on the sampler's draws: finite, the right shape
    images = torch.from_numpy(uint8_images(1, 3, 48))
    for intensity in ("low", "medium", "high"):
        out = tpre.augment_batch(
            images, tpre.sample_per_image_draws(gen, 3, intensity),
            intensity, 40, dtype=torch.float32)
        assert out.shape == (3, 40, 40, 3) and torch.isfinite(out).all()
