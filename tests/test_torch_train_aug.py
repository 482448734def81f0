"""Training augmentation and batch mixing of the port against the JAX
package's (``ops/preprocess.py``, ``ops/mix.py``).

The generators differ, so the port's functions take their draws as
arguments: the parity tests recompute the JAX package's draws from its key
by its own splits (tests/torch_jax_train.py) and pass them in.  Bars: f32
outputs within 1e-5; a bf16 work dtype within one bf16 ulp (2^-8) of the
[0, 1] image before normalization; nearest rotation index for index.  The
samplers get law tests: the port's draws against the JAX package's from
the same laws (two-sample Kolmogorov-Smirnov, p > 1e-3) and against the
stated ranges and rates.

The JAX functions run as written, op by op.  Under ``jax.jit`` XLA's CPU
backend fuses them and contracts products and sums into FMAs, which moves
values by an ulp (the normalization by up to 2.3e-5) and, at the
rotation's exact .5 ties, the pixel chosen; that is the compiler's
rounding, not the functions' semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from irp_tpu.ops import mix as jmix
from irp_tpu.ops import preprocess as jpre
from irp_tpu_torch.ops import mix as tmix
from irp_tpu_torch.ops import preprocess as tpre

from tests.torch_jax_train import jax_augment_draws, uint8_images

torch.set_num_threads(1)
MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)


@pytest.mark.parametrize("intensity", ["low", "medium", "high"])
@pytest.mark.parametrize("work", ["float32", "bfloat16"])
def test_augment_batch_fused_matches_jax_given_its_draws(intensity, work):
    b, size, out = 4, 48, 40
    images = uint8_images(0, b, size)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jpre.augment_batch_fused(
        jnp.asarray(images), key, intensity, out, dtype=jnp.float32,
        work_dtype=getattr(jnp, work)))
    draws = jax_augment_draws(key, intensity, b, size, size)
    got = tpre.augment_batch_fused(torch.from_numpy(images), draws,
                                   intensity, out, dtype=torch.float32,
                                   work_dtype=getattr(torch, work)).numpy()
    assert got.shape == want.shape == (b, out, out, 3)
    if work == "float32":
        assert np.abs(got - want).max() <= 1e-5
    else:
        # the [0, 1] image before normalization, within one bf16 ulp
        assert np.abs((got - want) * STD).max() <= 2.0 ** -8


def test_interp_matrix_and_resample_match_jax():
    rng = np.random.default_rng(1)
    b, h, out = 4, 80, 48
    tops = rng.uniform(0, 20, b).astype(np.float32)
    sizes = rng.uniform(40, 80 - 20, b).astype(np.float32)
    mirror = np.array([True, False, True, False])
    want = np.asarray(jax.vmap(lambda t, s, m: jpre.interp_matrix(
        t, s, h, out, m))(jnp.asarray(tops), jnp.asarray(sizes),
                          jnp.asarray(mirror)))
    got = tpre.interp_matrix(torch.from_numpy(tops), torch.from_numpy(sizes),
                             h, out, torch.from_numpy(mirror)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    x = rng.uniform(0, 1, (b, h, h, 3)).astype(np.float32)
    want = np.asarray(jpre.resample_crop_batch(
        jnp.asarray(x), jnp.asarray(tops), jnp.asarray(tops[::-1].copy()),
        jnp.asarray(sizes), jnp.asarray(sizes), out,
        hflip=jnp.asarray(mirror), vflip=jnp.asarray(~mirror)))
    t = torch.from_numpy
    got = tpre.resample_crop_batch(t(x), t(tops), t(tops[::-1].copy()),
                                   t(sizes), t(sizes), out, hflip=t(mirror),
                                   vflip=t(~mirror)).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("work", ["float32", "bfloat16"])
def test_color_jitter_with_hue_matches_jax(work):
    rng = np.random.default_rng(2)
    b = 5
    x = rng.uniform(0, 1, (b, 24, 24, 3)).astype(np.float32)
    x[0, :4] = 0.5  # grey pixels: zero saturation, hue masked to 0
    x[1, :4] = 0.0  # black: maxc 0
    key = jax.random.PRNGKey(5)
    jx = jnp.asarray(x).astype(getattr(jnp, work))
    want = np.asarray(jpre.color_jitter_batch(jx, key, 0.2, 0.2, 0.2, 0.1)
                      .astype(jnp.float32))
    kb, kc, ks, kh = jax.random.split(key, 4)

    def f(k, shape, lo, hi):
        return torch.from_numpy(np.array(jax.random.uniform(
            k, shape, minval=lo, maxval=hi)).reshape(b))

    got = tpre.color_jitter_batch(
        torch.from_numpy(x).to(getattr(torch, work)),
        f(kb, (b, 1, 1, 1), 0.8, 1.2), f(kc, (b, 1, 1, 1), 0.8, 1.2),
        f(ks, (b, 1, 1, 1), 0.8, 1.2), f(kh, (b, 1, 1), -0.1, 0.1))
    tol = 1e-5 if work == "float32" else 2.0 ** -8
    assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("size", [31, 33])
def test_rotate_nearest_ties_round_as_jax(size):
    """At 30, 60 and 120 degrees on an odd grid some source coordinates
    land exactly on .5: JAX's map_coordinates rounds them away from zero,
    torch.round to even.  The port must pick the JAX package's pixel."""
    rng = np.random.default_rng(size)
    angles = np.array([30.0, 60.0, -60.0, 120.0, 7.5, -15.0], np.float32)
    x = rng.uniform(0, 1, (len(angles), size, size, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda im, a: jpre.rotate(im, a))(
        jnp.asarray(x), jnp.asarray(angles)))
    got = tpre.rotate(torch.from_numpy(x), torch.from_numpy(angles)).numpy()
    np.testing.assert_array_equal(got, want)
    # the grid has exact ties, and ties-to-even would move pixels
    theta = torch.tensor(-60.0) * np.pi / 180.0
    c = (size - 1) / 2.0
    ys = torch.arange(size, dtype=torch.float32)[:, None] - c
    xs = torch.arange(size, dtype=torch.float32)[None, :] - c
    src = torch.cos(theta) * ys - torch.sin(theta) * xs + c
    assert int(((src - src.trunc()).abs() == 0.5).sum()) > 0
    assert not torch.equal(torch.round(src), tpre._round_half_away(src))


def test_sample_augment_draws_follow_the_jax_laws():
    n, h, w = 20000, 256, 256
    gen = torch.Generator().manual_seed(0)
    d = tpre.sample_augment_draws(gen, n, h, w, "high")
    assert abs(float(d.hflip.float().mean()) - 0.5) < 0.02
    assert abs(float(d.vflip.float().mean()) - 0.2) < 0.02
    for t, lo, hi in ((d.brightness, 0.8, 1.2), (d.contrast, 0.8, 1.2),
                      (d.saturation, 0.8, 1.2), (d.hue, -0.1, 0.1),
                      (d.angles, -15.0, 15.0)):
        a = t.numpy()
        assert lo <= a.min() and a.max() <= hi
        assert stats.kstest(a, stats.uniform(lo, hi - lo).cdf).pvalue > 1e-3
    key = jax.random.PRNGKey(0)
    for scale in ((0.7, 1.0), (0.8, 1.0)):
        want = [np.asarray(v) for v in jpre._sample_rrc_boxes(
            key, n, h, w, scale)]
        got = [v.numpy() for v in tpre.sample_rrc_boxes(gen, n, h, w, scale)]
        for g, wv in zip(got, want):
            assert stats.ks_2samp(g, wv).pvalue > 1e-3
        tops, lefts, ch, cw = got
        assert (tops >= 0).all() and (tops + ch <= h + 1e-3).all()
        assert (lefts >= 0).all() and (lefts + cw <= w + 1e-3).all()
        area = ch * cw / (h * w)
        assert area.min() >= scale[0] * 0.75 and area.max() <= 1.0 + 1e-6
        inside = (ch < h) & (cw < w)
        ratio = cw[inside] / ch[inside]
        assert ratio.min() >= 0.75 - 1e-4 and ratio.max() <= 4 / 3 + 1e-4
    medium = tpre.sample_augment_draws(gen, 8, h, w, "medium")
    assert medium.vflip is None and medium.angles is None \
        and medium.hue is None
    low = tpre.sample_augment_draws(gen, 8, h, w, "low")
    assert low.tops is None and low.brightness is None


def _jax_mix_draws(key, mixup, cutmix, h, w):
    """ops/mix.py::mix_batch's draws from its key, as the port's MixDraws."""
    k_choice, k_mix, k_cut, k_box = jax.random.split(key, 4)
    d = tmix.MixDraws()
    if mixup > 0:
        d.lam_mixup = float(jax.random.beta(k_mix, mixup, mixup))
    if cutmix > 0:
        d.lam_cutmix = float(jax.random.beta(k_cut, cutmix, cutmix))
        k_cx, k_cy = jax.random.split(k_box)
        d.cy = int(jax.random.randint(k_cy, (), 0, h))
        d.cx = int(jax.random.randint(k_cx, (), 0, w))
    if mixup > 0 and cutmix > 0:
        d.pick_cut = bool(jax.random.bernoulli(k_choice))
    return d


@pytest.mark.parametrize("mixup,cutmix", [(0.4, 0.0), (0.0, 1.0),
                                          (0.4, 1.0), (0.0, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mix_batch_matches_jax_given_its_draws(mixup, cutmix, dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (6, 20, 20, 3)).astype(np.float32)
    labels = np.arange(6, dtype=np.int32) % 3
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        wx, wa, wb, wlam = jmix.mix_batch(jx, jnp.asarray(labels), key,
                                          mixup, cutmix)
        d = _jax_mix_draws(key, mixup, cutmix, 20, 20)
        gx, ga, gb, glam = tmix.mix_batch(
            torch.from_numpy(x).to(getattr(torch, dtype)),
            torch.from_numpy(labels), d, mixup, cutmix)
        np.testing.assert_array_equal(gx.float().numpy(),
                                      np.asarray(wx.astype(jnp.float32)))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        assert abs(glam - float(wlam)) <= 1e-7


def test_mix_lambda_follows_beta_and_the_coin_is_fair():
    rng = np.random.default_rng(0)
    draws = [tmix.sample_mix_draws(rng, 0.4, 1.0, 224, 224)
             for _ in range(4000)]
    lam_m = np.array([d.lam_mixup for d in draws])
    lam_c = np.array([d.lam_cutmix for d in draws])
    assert stats.kstest(lam_m, stats.beta(0.4, 0.4).cdf).pvalue > 1e-3
    assert stats.kstest(lam_c, stats.beta(1.0, 1.0).cdf).pvalue > 1e-3
    assert abs(np.mean([d.pick_cut for d in draws]) - 0.5) < 0.03
    cy = np.array([d.cy for d in draws])
    assert cy.min() >= 0 and cy.max() < 224
    # the adjusted lam is 1 - the patch's share of the image
    (y1, y2, x1, x2), lam = tmix._cutmix_box_and_lam(0.3, 5, 200, 224, 224)
    assert lam == pytest.approx(1 - (y2 - y1) * (x2 - x1) / 224 ** 2)
