#!/usr/bin/env python
"""Benchmark the fused identity-bottleneck kernel against the unfused block
and the relu copy floor, on the card.

For ResNet50's layer1/2/3 identity-block shapes at B=256: the device time
of the fused kernel (``csrc/identity_bottleneck.cu``), of the port's
unfused ``Bottleneck`` on the same weights (cuDNN convs, BN, relu), of
the relu copy kernel (``csrc/copy_floor.cu``), which reads x once and
writes one output: no fused block can move less, and of ``torch.relu``
at the same shape; beside them the fused block's bound (:func:`k1_bound`).
Times are CUDA-event medians over bursts whose inputs are cold in L2
(:func:`gpu_ms`).

  python -m irp_tpu_torch.tools.bench_fused_block
"""

from __future__ import annotations

import argparse
import math
import statistics

import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
SHAPES = [  # (B, H, W, C, M, label)
    (256, 56, 56, 256, 64, "layer1"),
    (256, 28, 28, 512, 128, "layer2"),
    (256, 14, 14, 1024, 256, "layer3"),
]


def gpu_ms(calls, reps: int = 10) -> float:
    """Median device time of one call, over ``reps`` bursts that run every
    call once.  Each call works on its own buffers, so a burst touches
    more than the 50 MB L2 and every call finds its inputs cold.  A sleep
    kernel ahead of each burst lets the host enqueue the whole burst
    before the card reaches it, so host overhead is not timed."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for call in calls:
            call()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / len(calls))
    return statistics.median(per_call)


def bound(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """The least time (ms) for the work: bytes over the memory rate or
    operations over ``peak_flops``, whichever is larger, and which."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(b: int, h: int, w: int, c: int, m: int):
    """The fused block's bound (ms, and by what): x read and out written
    once, the bf16 weights and f32 biases read once, against its
    2 B H W (CM + 9M^2 + MC) operations."""
    n_bytes = 2 * b * h * w * c * 2 + (c * m + 9 * m * m + m * c) * 2 \
        + (2 * m + c) * 4
    return bound(n_bytes, 2 * b * h * w * (c * m + 9 * m * m + m * c))


def n_sets(set_bytes: int) -> int:
    """Input sets for :func:`gpu_ms` that together exceed the L2 cache."""
    return max(2, math.ceil(128e6 / set_bytes))


def random_identity_block(c: int, m: int, gen: torch.Generator):
    """A bf16 frozen identity Bottleneck (C -> M -> C) in eval form with
    weights from ``gen``, BN affine and running stats perturbed so that
    the folding matters; in channels_last memory on the card."""
    from irp_tpu_torch.models.layers import lecun_normal_
    from irp_tpu_torch.models.resnet import Bottleneck

    block = Bottleneck(c, m, 1, torch.bfloat16, True, foldable=True)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            lecun_normal_(conv.weight, conv.weight[0].numel(), gen)
        for bn in (block.bn1, block.bn2, block.bn3):
            f = bn.num_features
            bn.weight.copy_(0.5 + torch.rand(f, generator=gen))
            bn.bias.copy_(torch.randn(f, generator=gen) * 0.1)
            bn.running_mean.copy_(torch.randn(f, generator=gen) * 0.1)
            bn.running_var.copy_(0.5 + torch.rand(f, generator=gen))
    return block.to(device="cuda", memory_format=torch.channels_last).eval()


def bench_shape(b, h, w, c, m, gen) -> dict:
    """Fused, unfused, copy-floor and torch.relu device ms at one shape
    beside the fused block's bound, with the fused kernel's max |diff|
    from its plain version and that version's max |value|."""
    from irp_tpu_torch.ops.cuda_resnet import (fused_identity_bottleneck,
                                               reference_identity_bottleneck,
                                               relu_copy)

    block = random_identity_block(c, m, gen)
    weights = block.folded_weights()
    x_bytes = b * h * w * c * 2
    xs = [torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16).cuda()
          for _ in range(n_sets(2 * x_bytes))]
    want = reference_identity_bottleneck(xs[0], *weights).float()
    diff = float((fused_identity_bottleneck(xs[0], *weights).float()
                  - want).abs().max())
    max_plain = float(want.abs().max())
    del want

    def unfused(x):
        with torch.inference_mode():
            block(x.permute(0, 3, 1, 2), fused=False)

    t_fused = gpu_ms([lambda x=x: fused_identity_bottleneck(x, *weights)
                      for x in xs])
    t_unfused = gpu_ms([lambda x=x: unfused(x) for x in xs])
    t_copy = gpu_ms([lambda x=x: relu_copy(x) for x in xs])
    t_relu = gpu_ms([lambda x=x: torch.relu(x) for x in xs])
    bound_ms, bound_by = k1_bound(b, h, w, c, m)
    return {"fused_ms": t_fused, "unfused_ms": t_unfused,
            "copy_floor_ms": t_copy, "relu_ms": t_relu,
            "copy_floor_gb_per_s": 2 * x_bytes / 1e9 / (t_copy / 1e3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "maxdiff": diff, "max_abs_plain": max_plain}


def main(argv=None) -> list:
    """Print one line per shape; returns the measured numbers."""
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    from irp_tpu_torch._kernels import resolve_device

    resolve_device("cuda")  # raises without a card
    gen = torch.Generator().manual_seed(0)
    results = []
    for b, h, w, c, m, label in SHAPES:
        r = bench_shape(b, h, w, c, m, gen)
        print(f"{label}: fused {r['fused_ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  unfused "
              f"{r['unfused_ms']:.4f} ms  copy-floor "
              f"{r['copy_floor_ms']:.4f} ms "
              f"({r['copy_floor_gb_per_s']:.0f} GB/s)  torch.relu "
              f"{r['relu_ms']:.4f} ms  maxdiff {r['maxdiff']:.4f}",
              flush=True)
        results.append({"shape": label, "B": b, "H": h, "W": w, "C": c,
                        "M": m, **r})
    return results


if __name__ == "__main__":
    main()
