"""The training step's share (%) of the card's bf16 peak: the
operations of the window's images (roofline/counts.py: train_flops) over
the window's time."""

from benchmark.roofline.peaks import PEAK_BF16_FLOPS


def read(record):
    flops = record["images"] * record["train_flops_per_image"]
    return 100.0 * flops / record["window_s"] / PEAK_BF16_FLOPS
