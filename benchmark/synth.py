"""Inputs made from the seed: images, labels and weights.

Both sides of a run get these and nothing else: the program under test
(``irp_tpu_torch``) and the plain reference in ``reference/``.  Images
are smooth random colour fields with grain, so that every crop, jitter
and forward reads something that differs from image to image; weights
are made on the device in two large draws and cut into leaves by the
reference's own list of names and shapes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 2048  # images made per call on the device


def device_generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for one stream of draws (the sampler, the
    augmentation, the schedule of requests, ...), from the run's seed."""
    words = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def images(n: int, px: int, seed: int, device) -> np.ndarray:
    """(n, px, px, 3) uint8 on the host: an 8 x 8 random colour field per
    image, resized to px bilinearly, with uniform grain of +-12 levels.
    Made on ``device`` in chunks of :data:`CHUNK` images."""
    gen = device_generator(device, seed)
    out = np.empty((n, px, px, 3), np.uint8)
    for start in range(0, n, CHUNK):
        m = min(CHUNK, n - start)
        base = torch.rand((m, 3, 8, 8), generator=gen, device=device) * 255
        field = torch.nn.functional.interpolate(
            base, size=(px, px), mode="bilinear", align_corners=False)
        grain = torch.rand((m, 3, px, px), generator=gen, device=device)
        x = (field + (grain - 0.5) * 24).clamp(0, 255).round()
        torch.from_numpy(out[start:start + m]).copy_(
            x.to(torch.uint8).permute(0, 2, 3, 1))
    return out


def labels(class_counts, seed: int) -> np.ndarray:
    """Labels with exactly ``class_counts[i]`` of class i, in an order
    drawn from the seed (int32)."""
    y = np.repeat(np.arange(len(class_counts), dtype=np.int32),
                  class_counts)
    return y[np.random.default_rng(sub_seed(seed, 1)).permutation(len(y))]


def class_weights(class_counts) -> np.ndarray:
    """Inverse-frequency weights n / (k * count_i), float32."""
    counts = np.asarray(class_counts, np.float64)
    return (counts.sum() / (len(counts) * counts)).astype(np.float32)


def _fan_in(shape) -> int:
    return int(np.prod(shape[1:]))


def weights(specs, seed: int, device) -> dict:
    """A state_dict from ``specs`` (name -> (shape, kind)), f32 on
    ``device``.  Kinds: 'kernel' N(0, 1/fan_in) (a conv's or dense
    layer's weight), 'bias' and 'embed' N(0, 0.02^2), 'scale' U(0.5, 1)
    (BatchNorm and LayerNorm weight), 'mean' N(0, 0.1^2) and 'var'
    U(0.5, 1.5) (BatchNorm running statistics), 'count' 0 (int64).  All
    normal and uniform draws come from two calls, one of each."""
    gen = device_generator(device, sub_seed(seed, 2))
    numel = {n: math.prod(shape) for n, (shape, _) in specs.items()}
    total = sum(numel.values())
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, (shape, kind) in specs.items():
        k = numel[name]
        z, u = normal[off:off + k].view(shape), uniform[off:off + k].view(
            shape)
        off += k
        if kind == "kernel":
            t = z / math.sqrt(_fan_in(shape))
        elif kind in ("bias", "embed"):
            t = z * 0.02
        elif kind == "scale":
            t = 0.5 + 0.5 * u
        elif kind == "branch_scale":
            t = 0.1 + 0.2 * u
        elif kind == "mean":
            t = z * 0.1
        elif kind == "var":
            t = 0.5 + u
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            raise ValueError(f"unknown weight kind {kind!r} for {name}")
        out[name] = t.clone()
    return out
