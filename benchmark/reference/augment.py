"""Training augmentation and its random draws, plain.

The configuration's training pipeline, torchvision's medium intensity:
horizontal flip (p 0.5) -> RandomResizedCrop(scale 0.8-1, ratio 3/4-4/3)
to the crop size -> ColorJitter(brightness, contrast, saturation 0.1) ->
ImageNet normalization.  As the program states it: the crop box is
clamped into the image (no retry loop), the resize is bilinear with an
antialiasing triangle filter widened by the downscale factor, and the
jitter runs brightness -> contrast -> saturation with contrast against
each image's mean grey (ITU-R 601 luma).

Draws, in the order of a training step on one device generator: eight
(B,) uniform vectors (flip, area, log aspect, top, left, brightness,
contrast, saturation), then the head's two dropout masks, (B, F) and
(B, hidden), uniform below the keep probability.
"""

from __future__ import annotations

import math

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SCALE, RATIO, JITTER = (0.8, 1.0), (3 / 4, 4 / 3), 0.1
LUMA = (0.299, 0.587, 0.114)


def _uniform(gen, b, lo, hi):
    return lo + torch.rand(b, generator=gen, device=gen.device) * (hi - lo)


def step_draws(gen: torch.Generator, b: int, h: int, w: int, feats: int,
               hidden: int, rate: float) -> dict:
    """One training step's draws for a batch of ``b`` (h, w) images."""
    d = {"hflip": torch.rand(b, generator=gen, device=gen.device) < 0.5}
    area = h * w * _uniform(gen, b, *SCALE)
    aspect = torch.exp(_uniform(gen, b, math.log(RATIO[0]),
                                math.log(RATIO[1])))
    d["box_w"] = torch.sqrt(area * aspect).clamp(1.0, float(w))
    d["box_h"] = torch.sqrt(area / aspect).clamp(1.0, float(h))
    d["top"] = _uniform(gen, b, 0.0, 1.0) * (h - d["box_h"])
    d["left"] = _uniform(gen, b, 0.0, 1.0) * (w - d["box_w"])
    for name in ("brightness", "contrast", "saturation"):
        d[name] = _uniform(gen, b, 1.0 - JITTER, 1.0 + JITTER)
    keep = 1.0 - rate
    d["masks"] = (torch.rand((b, feats), generator=gen,
                             device=gen.device) < keep,
                  torch.rand((b, hidden), generator=gen,
                             device=gen.device) < keep)
    return d


def _resize_weights(start, size, n_in: int, n_out: int) -> torch.Tensor:
    """(B, n_out, n_in): output pixel o samples the box [start, start +
    size) at start + (o + 0.5) * size / n_out - 0.5 with a triangle of
    half-width max(size / n_out, 1), each row summing to 1."""
    scale = (size / n_out)[:, None, None]
    o = torch.arange(n_out, dtype=torch.float32, device=start.device)
    pos = start[:, None, None] + (o[None, :, None] + 0.5) * scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=start.device)
    wts = (1.0 - (pos - src).abs() / scale.clamp_min(1.0)).clamp_min(0.0)
    return wts / wts.sum(dim=2, keepdim=True)


def _grey(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) luma of an NCHW batch."""
    luma = torch.tensor(LUMA, dtype=x.dtype, device=x.device)
    return (x * luma[None, :, None, None]).sum(dim=1, keepdim=True)


def augment(images_u8: torch.Tensor, d: dict, out: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 and one step's draws -> (B, 3, out, out)
    float32, normalized."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    x = torch.where(d["hflip"][:, None, None, None], x.flip(3), x)
    _, _, h, w = x.shape
    ry = _resize_weights(d["top"], d["box_h"], h, out)
    rx = _resize_weights(d["left"], d["box_w"], w, out)
    x = torch.einsum("boh,bchw,bpw->bcop", ry, x, rx)
    col = lambda v: v[:, None, None, None]  # noqa: E731
    x = (x * col(d["brightness"])).clamp(0.0, 1.0)
    grey_mean = _grey(x).mean(dim=(1, 2, 3), keepdim=True)
    x = (col(d["contrast"]) * x + (1 - col(d["contrast"])) * grey_mean
         ).clamp(0.0, 1.0)
    x = (col(d["saturation"]) * x + (1 - col(d["saturation"])) * _grey(x)
         ).clamp(0.0, 1.0)
    mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def eval_crop(images_u8: torch.Tensor, out: int) -> torch.Tensor:
    """The eval transform: the centre out x out crop, normalized:
    (B, H, W, 3) uint8 -> (B, 3, out, out) float32."""
    h, w = images_u8.shape[1:3]
    top, left = (h - out) // 2, (w - out) // 2
    x = images_u8[:, top:top + out, left:left + out].permute(0, 3, 1, 2)
    mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, device=x.device)[None, :, None, None]
    return (x.float() / 255.0 - mean) / std
