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
    dt = x.dtype

    def per_image(f, ndim=4):
        return f.to(dt).reshape((-1,) + (1,) * (ndim - 1))

    if brightness is not None:
        x = (per_image(brightness) * x).clamp(0.0, 1.0)
    if contrast is not None:
        mean_gray = _grayscale(x).float().mean(dim=(1, 2, 3),
                                               keepdim=True).to(dt)
        x = _blend(x, mean_gray, per_image(contrast)).clamp(0.0, 1.0)
    if saturation is not None:
        x = _blend(x, _grayscale(x), per_image(saturation)).clamp(0.0, 1.0)
    if hue is not None:
        h, s, v = _rgb_to_hsv(x)
        x = _hsv_to_rgb(torch.remainder(h + per_image(hue, 3), 1.0), s, v)
    return x


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
