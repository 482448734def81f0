"""Fused frozen identity bottleneck: the CUDA kernel's wrapper, its plain
version and the BatchNorm folding it needs; the epilogue of the frozen
prefix's other, BN-folded convs; and the relu copy that is the
bottleneck's bandwidth floor.  The bottleneck and the epilogue are the
custom ops ``irp_tpu_torch::identity_bottleneck`` and
``irp_tpu_torch::frozen_epilogue`` (``torch.library``): each one's CPU
kernel is the plain version, its CUDA kernel the launch, and its fake
kernel gives ``torch.export`` the output's shape, so an exported program
holds the op itself.

Counterpart of the JAX package's ``ops/pallas_resnet.py`` and of
``tools/bench_fused_block.py::copy_floor``; the epilogue has no
counterpart (XLA fuses those BNs there).  The kernels are
``csrc/identity_bottleneck.cu``, ``csrc/frozen_epilogue.cu`` and
``csrc/copy_floor.cu``.  Arguments keep the JAX layout: x is NHWC, conv
kernels are HWIO, 1x1 kernels are (C_in, C_out) matrices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from irp_tpu_torch import _kernels
from irp_tpu_torch.models.layers import at_least_f32


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Inference-form BatchNorm as a per-channel (scale, bias) affine."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


def fold_bn_into_conv(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Fold an inference-form BN into the preceding bias-free conv.

    kernel: (kh, kw, C_in, C_out) HWIO.  Returns (folded_kernel, bias_out)
    with bias shaped (C_out,), in the kernel's dtype (call with f32
    params, cast after).
    """
    s, b = fold_bn(scale, bias, mean, var, eps)
    return kernel * s, b


def reference_identity_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch version of the kernel: f32 arithmetic on the same
    inputs, rounded to x.dtype where the kernel rounds (after each conv's
    bias + relu, and after conv3's bias)."""
    f32 = torch.float32
    dt = x.dtype
    h, w = x.shape[1:3]
    a = torch.relu(torch.matmul(x.to(f32), w1.to(f32)) + b1.to(f32)).to(dt)
    # the 3x3 same conv as 9 shifted f32 matmuls over the zero-padded map
    ap = F.pad(a.to(f32), (0, 0, 1, 1, 1, 1))
    w2 = w2.to(f32)
    acc = sum(torch.matmul(ap[:, dy:dy + h, dx:dx + w], w2[dy, dx])
              for dy in range(3) for dx in range(3))
    bmap = torch.relu(acc + b2.to(f32)).to(dt)
    y = (torch.matmul(bmap.to(f32), w3.to(f32)) + b3.to(f32)).to(dt)
    return torch.relu(x + y)


def _check_shapes(x, w1, b1, w2, b2, w3, b3):
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    _, _, _, c = x.shape
    m = w1.shape[-1] if w1.ndim == 2 else -1
    want = {"w1": (c, m), "b1": (m,), "w2": (3, 3, m, m), "b2": (m,),
            "w3": (m, c), "b3": (c,)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for x "
                             f"{tuple(x.shape)}, got "
                             f"{tuple(got[name].shape)}")


K1_WIDTHS = (64, 128, 256, 512)  # the M the fused kernel takes


def bottleneck_plan(h: int, w: int, c: int, m: int) -> int:
    """Output rows per work unit (the band) of the fused kernel at this
    shape: the narrowest band whose output pixels fill three quarters of
    one 128-pixel pass (two 64-row wgmma tiles), so that each unit costs
    one pass of phases 2 and 3 and the units are as many as that allows:
    blocks that walk many short units drift out of step, and one block's
    HBM-bound phase 1 overlaps another's tensor-bound phases 2 and 3.  The
    kernel narrows it further where its shared memory does not hold the
    band.  Raises ValueError for a C or M the kernel does not take.
    """
    if c % 64 or m not in K1_WIDTHS:
        raise ValueError(f"kernel needs C a multiple of 64 and M in "
                         f"{K1_WIDTHS}, got C={c} M={m}")
    return min(h, -(-96 // w))


def fused_identity_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """One fused identity bottleneck block: relu(x + f(x)).

    f = 1x1 conv (w1, b1) -> relu -> 3x3 same-pad conv (w2, b2) -> relu ->
    1x1 conv (w3, b3), every BN pre-folded (:func:`fold_bn_into_conv`).

    x: (B, H, W, C); w1: (C, M), w2: (3, 3, M, M), w3: (M, C) in x.dtype;
    b1/b2: (M,), b3: (C,) float32.  Goes through the custom op
    ``irp_tpu_torch::identity_bottleneck``, which ``torch.export`` keeps as
    one node: a CPU tensor runs :func:`reference_identity_bottleneck`; a
    CUDA tensor launches the kernel on the current stream (bf16 x and
    weights, C a multiple of 64, M in :data:`K1_WIDTHS`, contiguous, a row
    that fits the kernel's shared memory; :func:`bottleneck_plan` picks
    its band) or raises.
    """
    _check_shapes(x, w1, b1, w2, b2, w3, b3)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return torch.ops.irp_tpu_torch.identity_bottleneck(x, w1, b1, w2, b2,
                                                       w3, b3)


fused_identity_bottleneck.launches = 0


@torch.library.custom_op("irp_tpu_torch::identity_bottleneck",
                         mutates_args=(), device_types="cpu")
def _identity_bottleneck_op(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor, w3: torch.Tensor,
                            b3: torch.Tensor) -> torch.Tensor:
    return reference_identity_bottleneck(x, w1, b1, w2, b2, w3,
                                         b3).contiguous()


@_identity_bottleneck_op.register_fake
def _(x, w1, b1, w2, b2, w3, b3):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@_identity_bottleneck_op.register_kernel("cuda")
def _(x, w1, b1, w2, b2, w3, b3):
    b, h, w, c = x.shape
    m = w1.shape[1]
    args = (x, w1, b1, w2, b2, w3, b3)
    for name, t, dtype in zip(("x", "w1", "b1", "w2", "b2", "w3", "b3"), args,
                              (torch.bfloat16,) * 2 + (torch.float32,)
                              + (torch.bfloat16, torch.float32) * 2):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    if b == 0:
        return out
    band = bottleneck_plan(h, w, c, m)
    lib = _kernels.load("identity_bottleneck")
    with torch.cuda.device(x.device):
        code = lib.irp_identity_bottleneck(
            *(t.data_ptr() for t in args), out.data_ptr(), b, h, w, c, m,
            band, _kernels.stream_handle(x.device))
    _kernels.check(lib, code, "identity_bottleneck")
    fused_identity_bottleneck.launches += 1
    return out


def pooled_size(n: int) -> int:
    """Output size of the stem's 3x3, stride 2, pad 1 max-pool."""
    return (n - 1) // 2 + 1


def frozen_epilogue_plain(y, b, r=None, b_r=None, pool: bool = False):
    """Plain PyTorch version of the epilogue kernel: ``relu(y + b)``,
    ``relu((y + r) + (b + b_r))`` with a residual, or ``relu(max(window)
    + b)`` over the 3x3/2 pad-1 max-pool's windows with ``pool``.  y, r:
    NHWC; b, b_r: (C,).  f32 arithmetic (f64 for f64 inputs) in the
    kernel's order, rounded to y.dtype once."""
    s = at_least_f32(y)
    bias = b.to(s.dtype)
    if r is not None:
        s = s + r.to(s.dtype)
        bias = bias + b_r.to(s.dtype)
    if pool:
        s = F.max_pool2d(s.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    return torch.relu(s + bias).to(y.dtype).contiguous()


def frozen_epilogue(y, b, r=None, b_r=None, pool: bool = False):
    """What is left of an inference BatchNorm folded into the conv before
    it (:func:`fold_bn_into_conv`), with what follows it in the frozen
    ResNet prefix, in one pass over the conv's output
    (:func:`frozen_epilogue_plain`).  Its three uses: ``relu(y + b)``
    after a block 0's conv1 and conv2; ``relu(y + r + (b + b_r))`` at a
    block 0's tail, y its conv3's output and r its downsample conv's; and
    with ``pool`` the stem's 3x3/2 pad-1 max-pool of ``relu(y + b)``,
    computed as ``relu(max(window) + b)``, which is equal since the bias
    is per channel.

    y, r: (B, H, W, C); b, b_r: (C,) float32.  Goes through the custom op
    ``irp_tpu_torch::frozen_epilogue``, which ``torch.export`` keeps as one
    node: a CPU tensor runs :func:`frozen_epilogue_plain`; a CUDA tensor
    launches ``csrc/frozen_epilogue.cu`` on the current stream (bf16 y
    and r, C a multiple of 8, contiguous, 16-byte aligned) or raises.
    ``frozen_epilogue.launches`` counts the kernel's launches (the card
    alone, as K1's counter does).
    """
    if y.ndim != 4:
        raise ValueError(f"y must be (B, H, W, C), got {tuple(y.shape)}")
    c = y.shape[3]
    if tuple(b.shape) != (c,):
        raise ValueError(f"b must be ({c},) for y {tuple(y.shape)}, got "
                         f"{tuple(b.shape)}")
    if (r is None) != (b_r is None):
        raise ValueError("r and b_r come together")
    if r is not None:
        if pool:
            raise ValueError("the pooled epilogue takes no residual")
        if r.shape != y.shape or tuple(b_r.shape) != (c,):
            raise ValueError(f"r must be {tuple(y.shape)} and b_r ({c},), "
                             f"got {tuple(r.shape)} and "
                             f"{tuple(b_r.shape)}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")
    return torch.ops.irp_tpu_torch.frozen_epilogue(y, b, r, b_r, pool)


frozen_epilogue.launches = 0


@torch.library.custom_op("irp_tpu_torch::frozen_epilogue", mutates_args=(),
                         device_types="cpu")
def _frozen_epilogue_op(y: torch.Tensor, b: torch.Tensor,
                        r: Optional[torch.Tensor],
                        b_r: Optional[torch.Tensor],
                        pool: bool) -> torch.Tensor:
    return frozen_epilogue_plain(y, b, r, b_r, pool)


@_frozen_epilogue_op.register_fake
def _(y, b, r, b_r, pool):
    if not pool:
        return torch.empty_like(y, memory_format=torch.contiguous_format)
    n, h, w, c = y.shape
    return y.new_empty((n, pooled_size(h), pooled_size(w), c))


@_frozen_epilogue_op.register_kernel("cuda")
def _(y, b, r, b_r, pool):
    args = {"y": (y, torch.bfloat16), "b": (b, torch.float32)}
    if r is not None:
        args.update(r=(r, torch.bfloat16), b_r=(b_r, torch.float32))
    for name, (t, dtype) in args.items():
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    n, h, w, c = y.shape
    if c % 8:
        raise ValueError(f"the kernel needs C a multiple of 8, got {c}")
    out = (y.new_empty((n, pooled_size(h), pooled_size(w), c)) if pool
           else torch.empty_like(y))
    if out.numel() == 0:
        return out
    lib = _kernels.load("frozen_epilogue")
    stream = _kernels.stream_handle(y.device)
    with torch.cuda.device(y.device):
        if pool:
            code = lib.irp_bias_relu_maxpool(
                y.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
                out.shape[1], out.shape[2], stream)
        elif r is None:
            code = lib.irp_bias_relu(y.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), y.numel(), c, stream)
        else:
            code = lib.irp_bias_add_relu(
                y.data_ptr(), b.data_ptr(), r.data_ptr(), b_r.data_ptr(),
                out.data_ptr(), y.numel(), c, stream)
    _kernels.check(lib, code, "frozen_epilogue")
    frozen_epilogue.launches += 1
    return out


def relu_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the copy-floor kernel."""
    return x.clamp_min(0)


def relu_copy(x: torch.Tensor) -> torch.Tensor:
    """``relu(x)`` into a new tensor: the copy floor a fused block at the
    same shape is measured against (one read and one write of x).

    A CPU tensor runs :func:`relu_copy_plain`; a CUDA tensor launches the
    kernel on the current stream (contiguous, 16-byte aligned bf16) or
    raises.
    """
    if x.device.type == "cpu":
        return relu_copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _kernels.load("copy_floor")
    with torch.cuda.device(x.device):
        code = lib.irp_relu_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                 _kernels.stream_handle(x.device))
    _kernels.check(lib, code, "relu_copy")
    relu_copy.launches += 1
    return out


relu_copy.launches = 0
