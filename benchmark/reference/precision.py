"""The arithmetic of the reference's matrix products.

'float32': operands as they are, float32 with TF32 off.  'fp8': each
operand of a convolution or matrix product rounded to float8 e4m3 with
one scale per tensor (its largest magnitude to 448), gradients passed
straight through: the control, the reference computed one precision
below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "fp8")
_E4M3_MAX = 448.0


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a matrix product of the given precision reads it."""
    if precision == "float32":
        return x
    if precision == "fp8":
        return _RoundFp8.apply(x)
    raise ValueError(f"unknown reference precision {precision!r}")


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matrix products without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
