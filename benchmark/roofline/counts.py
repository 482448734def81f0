"""Operations and bytes of the classifiers and of kernel K1, from shapes.

Operations are those of the convolutions and matrix products (2 per
multiply-add); normalization, activations, pooling and the augmentation
are left out.  A training step counts the frozen prefix's forward only,
and for each trainable product its forward, its weight gradient and,
where its input carries a gradient, its input gradient.
"""

from __future__ import annotations

from benchmark.reference import families
from benchmark.roofline.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S


def products(cfg):
    """Every product of the classifier: the family's
    (``reference/families/<family>.py``), then the head's two dense
    layers."""
    out, feats = families.load(cfg).products(cfg)
    h, k = cfg["hidden_dim"], cfg["num_classes"]
    return out + [("head", 2 * feats * h, True), ("head", 2 * h * k, True)]


def forward_flops(cfg) -> float:
    """Operations of one image's forward."""
    return float(sum(f for _, f, _ in products(cfg)))


def train_flops(cfg) -> float:
    """Operations of one image's training step: the frozen prefix
    forward; a trainable product 3x its forward, 2x where its input
    carries no gradient."""
    trainable = set(cfg["trainable_stages"]) | {"head"}
    total = 0.0
    for stage, f, input_grad in products(cfg):
        if stage in trainable:
            total += f * (3 if input_grad else 2)
        else:
            total += f
    return total


def bound_ms(n_bytes: float, flops: float) -> float:
    """The least time (ms): bytes over the memory rate or operations over
    the bf16 rate, whichever is larger."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3


def k1_bound_ms(b: int, h: int, w: int, c: int, m: int) -> float:
    """K1, the fused frozen identity bottleneck C -> M -> C: x read and
    the output written once in bf16, the bf16 weights and f32 biases read
    once, against 2 B H W (CM + 9 M^2 + MC) operations."""
    n_bytes = 2 * b * h * w * c * 2 + (c * m + 9 * m * m + m * c) * 2 \
        + (2 * m + c) * 4
    return bound_ms(n_bytes, 2 * b * h * w * (c * m + 9 * m * m + m * c))


def k1_blocks(cfg, batch: int):
    """(B, H, W, C, M) of each block K1 runs in one forward: the family's
    ``k1_blocks``, none where the family has no such kernel."""
    blocks = getattr(families.load(cfg), "k1_blocks", None)
    return blocks(cfg, batch) if blocks else []
