"""Mixup / CutMix batch mixing (the JAX package's ``ops/mix.py``).

Each sample is mixed with its partner in the reversed batch
(:func:`_partner`); one coefficient per step.  Over a process mesh each
rank's batch is one shard of the data axis, so its local reverse is the
JAX package's shard-local pairing.  Both transforms are the one
blend ``x + (x2 - x) * w``, with w the scalar ``1 - lam`` (mixup) or an
(H, W) patch mask (CutMix, lam re-derived from the patch area the border
leaves).  Labels stay hard: the loss is ``lam * CE(y_a) + (1 - lam) *
CE(y_b)`` (``models/classifier.py::mixed_weighted_cross_entropy``).

The per-step draws (:class:`MixDraws`) are host scalars, drawn by
:func:`sample_mix_draws` from a numpy generator, so the device never
waits for them; a parity test passes the JAX package's draws instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class MixDraws:
    """One step's mixing choices: the Beta draws of mixup and CutMix (None
    where that alpha is 0), the fair coin that picks CutMix when both are
    on, and the CutMix patch centre (row ``cy``, column ``cx``)."""

    lam_mixup: Optional[float] = None
    lam_cutmix: Optional[float] = None
    pick_cut: bool = False
    cy: int = 0
    cx: int = 0


def sample_mix_draws(rng: np.random.Generator, mixup_alpha: float,
                     cutmix_alpha: float, height: int,
                     width: int) -> MixDraws:
    """One step's draws: lam ~ Beta(alpha, alpha) for each transform that
    is on, the coin ~ Bernoulli(0.5), the centre uniform over the image."""
    draws = MixDraws()
    if mixup_alpha > 0:
        draws.lam_mixup = float(rng.beta(mixup_alpha, mixup_alpha))
    if cutmix_alpha > 0:
        draws.lam_cutmix = float(rng.beta(cutmix_alpha, cutmix_alpha))
        draws.cy = int(rng.integers(0, height))
        draws.cx = int(rng.integers(0, width))
    if mixup_alpha > 0 and cutmix_alpha > 0:
        draws.pick_cut = bool(rng.random() < 0.5)
    return draws


def _partner(arr: torch.Tensor) -> torch.Tensor:
    """Reversed-batch pairing (one data shard: this rank's batch)."""
    return arr.flip(0)


def _cutmix_box_and_lam(lam: float, cy: int, cx: int, height: int,
                        width: int):
    """The patch [y1, y2) x [x1, x2) of side ratio sqrt(1 - lam) centred at
    (cy, cx), clipped to the image, and lam adjusted to its area; float32
    arithmetic as the JAX package does it."""
    f32 = np.float32
    ratio = np.sqrt(np.maximum(f32(1.0) - f32(lam), f32(0.0)))
    cut_h = int(f32(height) * ratio)
    cut_w = int(f32(width) * ratio)
    y1 = int(np.clip(cy - cut_h // 2, 0, height))
    y2 = int(np.clip(cy + (cut_h - cut_h // 2), 0, height))
    x1 = int(np.clip(cx - cut_w // 2, 0, width))
    x2 = int(np.clip(cx + (cut_w - cut_w // 2), 0, width))
    area = (y2 - y1) * (x2 - x1)
    lam_adj = float(f32(1.0) - f32(area) / f32(height * width))
    return (y1, y2, x1, x2), lam_adj


def _cutmix_mask_and_lam(lam: float, cy: int, cx: int, height: int,
                         width: int, device=None):
    """(H, W) float32 mask, 1 inside the patch, and the adjusted lam."""
    (y1, y2, x1, x2), lam_adj = _cutmix_box_and_lam(lam, cy, cx, height,
                                                    width)
    mask = torch.zeros((height, width), dtype=torch.float32, device=device)
    mask[y1:y2, x1:x2] = 1.0
    return mask, lam_adj


def _as_dtype(v: float, dtype) -> float:
    """A float32 scalar rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def mix_batch(x: torch.Tensor, labels: torch.Tensor, draws: MixDraws,
              mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0):
    """Mix a (B, H, W, C) batch with its reversed self.

    Returns ``(x_mixed, labels_a, labels_b, lam)`` with the loss contract
    ``lam * loss(y_a) + (1 - lam) * loss(y_b)``; lam is a float32 value as
    a Python float.  With both alphas 0 the batch passes through, lam 1.
    """
    use_mixup, use_cutmix = mixup_alpha > 0, cutmix_alpha > 0
    labels_b = _partner(labels)
    if not (use_mixup or use_cutmix):
        return x, labels, labels_b, 1.0
    height, width = x.shape[1], x.shape[2]
    pick_cut = use_cutmix and (draws.pick_cut or not use_mixup)
    if pick_cut:
        mask, lam = _cutmix_mask_and_lam(draws.lam_cutmix, draws.cy,
                                         draws.cx, height, width, x.device)
        w = mask.to(x.dtype)[None, :, :, None]
    else:
        lam = float(np.float32(draws.lam_mixup))
        w = _as_dtype(float(np.float32(1.0) - np.float32(lam)), x.dtype)
    mixed = x + (_partner(x) - x) * w
    return mixed, labels, labels_b, lam
