"""Batched image preprocessing and training augmentation (the JAX
package's ``ops/preprocess.py``).

Eval path: :func:`eval_preprocess_batch`, center crop + normalize through
the K2 kernel on the card (``ops/cuda_image.py``).

Training path: :func:`augment_batch_fused`, the intensities of the
reference stack's torchvision pipelines on a whole (B, 256, 256, 3) uint8
batch, NHWC throughout:

    low:    HFlip -> CenterCrop
    medium: HFlip -> RandomResizedCrop(scale 0.8-1.0) -> ColorJitter(0.1)
    high:   HFlip -> VFlip(p=0.2) -> RRC(scale 0.7-1.0)
            -> ColorJitter(0.2, hue 0.1) -> RandomRotation(15)

The crop-resize is two batched contractions with antialiased bilinear
matrices that fold the flips in (:func:`interp_matrix`); the crop box is
clamped into the image instead of torchvision's retry loop; ColorJitter
runs in the fixed order brightness -> contrast -> saturation -> hue.

Every random choice is an argument (:class:`AugmentDraws`): the two
packages' generators cannot draw the same numbers, so a parity test feeds
the JAX package's draws here, and :func:`sample_augment_draws` draws them
in training with the same laws.

Per-sample path: :func:`augment_batch`, the JAX package's vmapped
``_augment_one`` (flips on the image, then :func:`random_resized_crop`
resampled with ``jax.image.scale_and_translate``'s antialiased weights,
:func:`color_jitter` with :func:`adjust_hue`, the rotation, then
:func:`normalize`), on the per-image draws of :class:`SampleDraws`
(:func:`sample_per_image_draws` draws them).  It is API only, as in the
JAX package: no training path runs it.  Its crop weights
(:func:`scale_translate_weights`, ``jax.image.scale_and_translate``'s)
and the fused path's (:func:`interp_matrix`, the JAX package's fused
matrices) are the same triangle filter computed in a different order,
and round differently; each path keeps its own builder so that it stays
equal to its JAX counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from irp_tpu_torch.ops.cuda_image import eval_preprocess

INTENSITIES = ("low", "medium", "high")
# (crop scale range, jitter brightness/contrast/saturation, hue, vflip p,
# rotation degrees) per intensity; a None range or a 0 means no such op
_LAWS = {
    "low": (None, 0.0, 0.0, 0.0, 0.0),
    "medium": ((0.8, 1.0), 0.1, 0.0, 0.0, 0.0),
    "high": ((0.7, 1.0), 0.2, 0.1, 0.2, 15.0),
}
RRC_RATIO = (3 / 4, 4 / 3)


def eval_preprocess_batch(images_u8: torch.Tensor, out_size: int = 224,
                          dtype=torch.bfloat16,
                          mean: Sequence[float] = IMAGENET_MEAN,
                          std: Sequence[float] = IMAGENET_STD
                          ) -> torch.Tensor:
    """Eval path: CenterCrop(out_size) + ImageNet normalize, from the
    (B, 256, 256, 3) uint8 cache geometry to (B, out, out, 3) ``dtype``.

    A CPU tensor runs the plain version, a CUDA tensor the kernel
    (``ops/cuda_image.py``).
    """
    return eval_preprocess(images_u8, out_size, mean, std, dtype)


@dataclasses.dataclass
class AugmentDraws:
    """The random choices of one :func:`augment_batch_fused` call, (B,)
    tensors on the batch's device; None where the intensity draws none.

    ``tops``/``lefts``/``heights``/``widths``: the crop boxes in source
    pixels (float32); ``brightness``/``contrast``/``saturation``: jitter
    factors; ``hue``: shifts in turns; ``angles``: rotations in degrees.
    """

    hflip: torch.Tensor
    vflip: Optional[torch.Tensor] = None
    tops: Optional[torch.Tensor] = None
    lefts: Optional[torch.Tensor] = None
    heights: Optional[torch.Tensor] = None
    widths: Optional[torch.Tensor] = None
    brightness: Optional[torch.Tensor] = None
    contrast: Optional[torch.Tensor] = None
    saturation: Optional[torch.Tensor] = None
    hue: Optional[torch.Tensor] = None
    angles: Optional[torch.Tensor] = None

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def _uniform(generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + u * (hi - lo)


def sample_rrc_boxes(generator: torch.Generator, batch: int, h: int, w: int,
                     scale: Tuple[float, float],
                     ratio: Tuple[float, float] = RRC_RATIO):
    """torchvision RandomResizedCrop's box law, vectorized: area fraction
    ~ U(scale), log aspect ~ U(log ratio), the box clamped into the image
    and its corner uniform over the room left.  Returns (tops, lefts,
    heights, widths) float32 on the generator's device."""
    area = h * w * _uniform(generator, (batch,), scale[0], scale[1])
    log_ratio = _uniform(generator, (batch,), math.log(ratio[0]),
                         math.log(ratio[1]))
    aspect = torch.exp(log_ratio)
    cw = torch.sqrt(area * aspect).clamp(1.0, float(w))
    ch = torch.sqrt(area / aspect).clamp(1.0, float(h))
    tops = _uniform(generator, (batch,), 0.0, 1.0) * (h - ch)
    lefts = _uniform(generator, (batch,), 0.0, 1.0) * (w - cw)
    return tops, lefts, ch, cw


def sample_augment_draws(generator: torch.Generator, batch: int, h: int,
                         w: int, intensity: str) -> AugmentDraws:
    """Draw one batch's augmentation choices from ``generator`` (on the
    device the batch lies on) with the JAX package's laws: hflip p=0.5;
    'high' adds vflip p=0.2, hue U(-0.1, 0.1) turns and angles U(-15, 15);
    jitter factors U(max(0, 1 - v), 1 + v)."""
    if intensity not in _LAWS:
        raise ValueError(f"unknown intensity: {intensity}")
    scale, jit, hue, p_v, deg = _LAWS[intensity]
    dev = generator.device
    draws = AugmentDraws(
        hflip=torch.rand(batch, generator=generator, device=dev) < 0.5)
    if scale is None:
        return draws
    if p_v > 0:
        draws.vflip = torch.rand(batch, generator=generator,
                                 device=dev) < p_v
    (draws.tops, draws.lefts, draws.heights,
     draws.widths) = sample_rrc_boxes(generator, batch, h, w, scale)
    lo, hi = max(0.0, 1.0 - jit), 1.0 + jit
    draws.brightness = _uniform(generator, (batch,), lo, hi)
    draws.contrast = _uniform(generator, (batch,), lo, hi)
    draws.saturation = _uniform(generator, (batch,), lo, hi)
    if hue > 0:
        draws.hue = _uniform(generator, (batch,), -hue, hue)
    if deg > 0:
        draws.angles = _uniform(generator, (batch,), -deg, deg)
    return draws


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop over the two spatial dims of (..., H, W, C)."""
    h, w = x.shape[-3], x.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top:top + size, left:left + size, :]


def interp_matrix(start: torch.Tensor, size: torch.Tensor, in_size: int,
                  out_size: int, mirror: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """(B, out, in) antialiased bilinear (triangle filter) matrices that
    resample each window [start, start + size) of ``in_size`` pixels to
    ``out_size``, float32.  ``mirror`` (B,) bool samples the window from
    the flipped source: flip-then-crop for the same box, at no cost."""
    scale = size / out_size
    support = scale.clamp_min(1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=start.device)
    centers = start[:, None] + (o[None, :] + 0.5) * scale[:, None] - 0.5
    if mirror is not None:
        centers = torch.where(mirror[:, None], (in_size - 1.0) - centers,
                              centers)
    src = torch.arange(in_size, dtype=torch.float32, device=start.device)
    dist = (centers[:, :, None] - src[None, None, :]).abs() \
        / support[:, None, None]
    wts = (1.0 - dist).clamp(0.0, 1.0)
    return wts / wts.sum(dim=2, keepdim=True).clamp_min(1e-8)


def resample_crop_batch(x: torch.Tensor, tops, lefts, heights, widths,
                        out_size: int, hflip=None, vflip=None
                        ) -> torch.Tensor:
    """Batched crop + resize of (B, H, W, C) by two contractions, flips
    folded into the matrices.  The matrices are rounded to x.dtype, each
    contraction accumulates in float32 and its result is rounded to
    x.dtype, as the JAX package's einsums with an f32 accumulator do."""
    b, h, w, c = x.shape
    dt = x.dtype
    ry = interp_matrix(tops, heights, h, out_size, vflip).to(dt).float()
    rx = interp_matrix(lefts, widths, w, out_size, hflip).to(dt).float()
    # rows: (B, out, H) @ (B, H, W*C)
    tmp = torch.bmm(ry, x.float().reshape(b, h, w * c)).to(dt)
    # columns: (B, out, W) against the W axis of (B, out_h, W, C)
    tmp = tmp.float().reshape(b, out_size, w, c).permute(0, 2, 1, 3)
    out = torch.bmm(rx, tmp.reshape(b, w, out_size * c)).to(dt)
    return out.reshape(b, out_size, out_size, c).permute(0, 2, 1,
                                                         3).contiguous()


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma (torchvision's rgb_to_grayscale weights), keepdim."""
    wts = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return (x * wts).sum(dim=-1, keepdim=True)


def _blend(a, b, factor):
    return factor * a + (1.0 - factor) * b


def _rgb_to_hsv(x: torch.Tensor):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.amax(dim=-1)
    minc = x.amin(dim=-1)
    deltac = maxc - minc
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.where(maxc > 0, deltac / maxc.clamp_min(1e-12), zero)
    dc = deltac.clamp_min(1e-12)
    rc = (maxc - r) / dc
    gc = (maxc - g) / dc
    bc = (maxc - b) / dc
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(deltac == 0, zero, h)
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def color_jitter_batch(x: torch.Tensor, brightness=None, contrast=None,
                       saturation=None, hue=None) -> torch.Tensor:
    """ColorJitter on a (B, H, W, 3) [0, 1] batch with per-image factors
    ((B,) tensors; None skips that op), in the order b -> c -> s -> h.
    Factors are cast to x.dtype, so a bf16 batch stays bf16."""
    if brightness is not None:
        x = (_per_image(brightness, x, 4) * x).clamp(0.0, 1.0)
    if contrast is not None:
        mean_gray = _grayscale(x).float().mean(dim=(1, 2, 3),
                                               keepdim=True).to(x.dtype)
        x = _blend(x, mean_gray, _per_image(contrast, x, 4)).clamp(0.0, 1.0)
    if saturation is not None:
        x = _blend(x, _grayscale(x), _per_image(saturation, x, 4)).clamp(
            0.0, 1.0)
    if hue is not None:
        x = adjust_hue(x, hue)
    return x


def _per_image(f, x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A scalar, or (B,) factors of a batch, in x.dtype, shaped to
    broadcast over the trailing ``ndim - 1`` dims of an image."""
    f = torch.as_tensor(f, device=x.device).to(x.dtype)
    return f.reshape((-1,) + (1,) * (ndim - 1)) if f.ndim else f


def adjust_hue(x: torch.Tensor, shift) -> torch.Tensor:
    """Shift the hue of a [0, 1] image (H, W, 3), or of a batch, by
    ``shift`` turns (a scalar, or (B,) for a batch): torchvision's
    ``adjust_hue`` through HSV."""
    h, s, v = _rgb_to_hsv(x)
    return _hsv_to_rgb(torch.remainder(h + _per_image(shift, x, 3), 1.0),
                       s, v)


def _round_half_away(a: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties away from zero (``lax.round``'s default, the
    rule of the JAX package's nearest ``map_coordinates``); torch.round
    sends ties to even."""
    t = torch.trunc(a)
    return torch.where((a - t).abs() >= 0.5, t + torch.sign(a), t)


def rotate(x: torch.Tensor, angles: torch.Tensor,
           fill: float = 0.0) -> torch.Tensor:
    """Rotate each (H, W, C) image of x by its angle in degrees about its
    center, nearest neighbour, pixels from outside filled with ``fill``
    (torchvision RandomRotation's defaults)."""
    b, h, w, c = x.shape
    dev = x.device
    theta = (-angles.float()) * math.pi / 180.0
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    src_y = cos * ys - sin * xs + cy
    src_x = sin * ys + cos * xs + cx
    iy = _round_half_away(src_y).to(torch.int64)
    ix = _round_half_away(src_x).to(torch.int64)
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, h * w)
    out = torch.gather(x.reshape(b, h * w, c), 1,
                       flat[:, :, None].expand(b, h * w, c))
    fill_t = torch.full((), fill, dtype=x.dtype, device=dev)
    return torch.where(valid.reshape(b, h, w, 1),
                       out.reshape(b, h, w, c), fill_t)


def augment_batch_fused(images_u8: torch.Tensor, draws: AugmentDraws,
                        intensity: str, out_size: int,
                        mean: Sequence[float] = IMAGENET_MEAN,
                        std: Sequence[float] = IMAGENET_STD,
                        dtype=torch.bfloat16, work_dtype=torch.float32
                        ) -> torch.Tensor:
    """Augment and normalize a (B, H, W, 3) uint8 batch with the given
    draws -> (B, out, out, 3) ``dtype`` (NHWC: the model's input in
    channels_last memory after ``.permute(0, 3, 1, 2)``).

    ``work_dtype`` is the arithmetic dtype of the [0, 1] image (bf16
    halves its memory traffic; the eval path stays float32)."""
    if intensity not in _LAWS:
        raise ValueError(f"unknown intensity: {intensity}")
    b, h, w = images_u8.shape[:3]
    x = images_u8.to(work_dtype) / 255.0
    if intensity == "low":
        x = torch.where(draws.hflip[:, None, None, None], x.flip(2), x)
        x = center_crop(x, out_size)
    else:
        x = resample_crop_batch(x, draws.tops, draws.lefts, draws.heights,
                                draws.widths, out_size, hflip=draws.hflip,
                                vflip=draws.vflip)
        x = color_jitter_batch(x, draws.brightness, draws.contrast,
                               draws.saturation, draws.hue)
        if intensity == "high":
            x = rotate(x, draws.angles)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x.float() - mean_t) / std_t).to(dtype).contiguous()


# -- the per-sample path (the JAX package's augment_batch) -----------------

def normalize(x: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD, dtype=torch.bfloat16
              ) -> torch.Tensor:
    """A [0, 255] image (uint8 or float), channels last -> ``dtype``
    ``(x / 255 - mean) / std`` (ToTensor + Normalize)."""
    x = x.float() / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(dtype)


def color_jitter(x: torch.Tensor, brightness=None, contrast=None,
                 saturation=None, hue=None) -> torch.Tensor:
    """ColorJitter on one [0, 1] image (H, W, 3) with scalar factors, or on
    a batch with (B,) factors; None skips that op.  Brightness, contrast
    (against the image's mean grey), saturation, then :func:`adjust_hue`,
    each clipped to [0, 1] but the hue."""
    if x.ndim == 3:
        return color_jitter(x[None], *(
            None if f is None else torch.as_tensor(f).reshape(1)
            for f in (brightness, contrast, saturation, hue)))[0]
    return color_jitter_batch(x, brightness, contrast, saturation, hue)


def scale_translate_weights(in_size: int, out_size: int,
                            scale: torch.Tensor, translation: torch.Tensor,
                            antialias: bool = True) -> torch.Tensor:
    """(B, out, in) float32 resampling weights of
    ``jax.image.scale_and_translate(method='linear')`` for per-image
    ``scale`` and ``translation`` (B,): an output pixel o samples the
    input at ``(o + 0.5 - translation) / scale - 0.5`` with a triangle
    kernel widened by ``1 / scale`` when that is above 1 (``antialias``),
    each row renormalized to sum 1 (rows summing to no more than 1000
    float32 eps, and samples outside [-0.5, in - 0.5], weigh 0)."""
    scale = scale.float()[:, None, None]
    translation = translation.float()[:, None, None]
    # a tensor divided by a tensor: ``1.0 / scale`` would multiply by a
    # reciprocal, an ulp off the quotient
    inv_scale = torch.ones_like(scale) / scale
    kernel_scale = inv_scale.clamp_min(1.0) if antialias else 1.0
    o = torch.arange(out_size, dtype=torch.float32,
                     device=scale.device)[None, :, None]
    sample = (o + 0.5) * inv_scale - translation * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32,
                       device=scale.device)[None, None, :]
    wts = (1.0 - ((sample - src).abs() / kernel_scale).abs()).clamp_min(0.0)
    total = wts.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total, 1.0),
                      torch.zeros((), device=wts.device))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, wts, torch.zeros((), device=wts.device))


def random_resized_crop(x: torch.Tensor, area: torch.Tensor,
                        log_ratio: torch.Tensor, top: torch.Tensor,
                        left: torch.Tensor, out_size: int,
                        antialias: bool = True) -> torch.Tensor:
    """RandomResizedCrop of each float image of (B, H, W, C) -> (B, out,
    out, C), float32.

    Per image: a crop of ``area`` times the image's area and aspect
    ``exp(log_ratio)`` (w / h), clamped into the image, its corner at
    ``top`` and ``left`` (in [0, 1]) of the room left, resampled to
    ``out_size`` with :func:`scale_translate_weights` (bilinear,
    antialiased when the crop is larger than the output)."""
    b, h, w, c = x.shape
    area_px = h * w * area.float()
    aspect = torch.exp(log_ratio.float())
    cw = torch.sqrt(area_px * aspect).clamp(1.0, float(w))
    ch = torch.sqrt(area_px / aspect).clamp(1.0, float(h))
    top_px = top.float() * (h - ch)
    left_px = left.float() * (w - cw)
    out_t = torch.full_like(ch, float(out_size))
    scale_y, scale_x = out_t / ch, out_t / cw  # quotients, as above
    wy = scale_translate_weights(h, out_size, scale_y, -top_px * scale_y,
                                 antialias)
    wx = scale_translate_weights(w, out_size, scale_x, -left_px * scale_x,
                                 antialias)
    # rows: (B, out, H) @ (B, H, W*C); columns against the W axis
    tmp = torch.bmm(wy, x.float().reshape(b, h, w * c))
    tmp = tmp.reshape(b, out_size, w, c).permute(0, 2, 1, 3)
    out = torch.bmm(wx, tmp.reshape(b, w, out_size * c))
    return out.reshape(b, out_size, out_size, c).permute(0, 2, 1,
                                                         3).contiguous()


@dataclasses.dataclass
class SampleDraws:
    """The per-image random choices of one :func:`augment_batch` call, (B,)
    tensors; None where the intensity draws none.

    ``hflip``/``vflip``: flips; ``area``: the crop's share of the image's
    area; ``log_ratio``: the log of its aspect (w / h); ``top``/``left``:
    its corner as a fraction of the room left; ``brightness``/
    ``contrast``/``saturation``: jitter factors; ``hue``: shift in turns;
    ``angles``: rotation in degrees."""

    hflip: torch.Tensor
    vflip: Optional[torch.Tensor] = None
    area: Optional[torch.Tensor] = None
    log_ratio: Optional[torch.Tensor] = None
    top: Optional[torch.Tensor] = None
    left: Optional[torch.Tensor] = None
    brightness: Optional[torch.Tensor] = None
    contrast: Optional[torch.Tensor] = None
    saturation: Optional[torch.Tensor] = None
    hue: Optional[torch.Tensor] = None
    angles: Optional[torch.Tensor] = None


def sample_per_image_draws(generator: torch.Generator, batch: int,
                           intensity: str) -> SampleDraws:
    """Draw :func:`augment_batch`'s choices from ``generator`` with the
    JAX package's per-image laws: hflip p=0.5; 'medium' and 'high' a crop
    area ~ U(0.8, 1) or U(0.7, 1), log aspect ~ U(log 3/4, log 4/3),
    corner fractions ~ U(0, 1), jitter factors ~ U(1 - v, 1 + v) with v
    0.1 or 0.2; 'high' also vflip p=0.2, hue ~ U(-0.1, 0.1) turns and an
    angle ~ U(-15, 15) degrees."""
    if intensity not in _LAWS:
        raise ValueError(f"unknown intensity: {intensity}")
    scale, jit, hue, p_v, deg = _LAWS[intensity]
    dev = generator.device
    draws = SampleDraws(
        hflip=torch.rand(batch, generator=generator, device=dev) < 0.5)
    if scale is None:
        return draws
    if p_v > 0:
        draws.vflip = torch.rand(batch, generator=generator,
                                 device=dev) < p_v
    draws.area = _uniform(generator, (batch,), scale[0], scale[1])
    draws.log_ratio = _uniform(generator, (batch,), math.log(RRC_RATIO[0]),
                               math.log(RRC_RATIO[1]))
    draws.top = _uniform(generator, (batch,), 0.0, 1.0)
    draws.left = _uniform(generator, (batch,), 0.0, 1.0)
    lo, hi = max(0.0, 1.0 - jit), 1.0 + jit
    draws.brightness = _uniform(generator, (batch,), lo, hi)
    draws.contrast = _uniform(generator, (batch,), lo, hi)
    draws.saturation = _uniform(generator, (batch,), lo, hi)
    if hue > 0:
        draws.hue = _uniform(generator, (batch,), -hue, hue)
    if deg > 0:
        draws.angles = _uniform(generator, (batch,), -deg, deg)
    return draws


def augment_batch(images_u8: torch.Tensor, draws: SampleDraws,
                  intensity: str = "medium", out_size: int = 224,
                  dtype=torch.bfloat16,
                  mean: Sequence[float] = IMAGENET_MEAN,
                  std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """Augment and normalize a (B, H, W, 3) uint8 batch image by image, in
    float32, with the given draws -> (B, out, out, 3) ``dtype``:

        low:    HFlip -> CenterCrop
        medium: HFlip -> RandomResizedCrop(0.8-1.0) -> ColorJitter(0.1)
        high:   HFlip -> VFlip -> RRC(0.7-1.0) -> ColorJitter(0.2, hue 0.1)
                -> RandomRotation(15, nearest)
    """
    if intensity not in _LAWS:
        raise ValueError(f"unknown intensity: {intensity}")
    x = images_u8.float() / 255.0
    x = torch.where(draws.hflip[:, None, None, None], x.flip(2), x)
    if intensity == "low":
        x = center_crop(x, out_size)
    else:
        if intensity == "high":
            x = torch.where(draws.vflip[:, None, None, None], x.flip(1), x)
        x = random_resized_crop(x, draws.area, draws.log_ratio, draws.top,
                                draws.left, out_size)
        x = color_jitter(x, draws.brightness, draws.contrast,
                         draws.saturation, draws.hue)
        if intensity == "high":
            x = rotate(x, draws.angles)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(dtype).contiguous()
