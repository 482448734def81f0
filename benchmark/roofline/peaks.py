"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit)."""

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
