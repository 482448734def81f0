"""Fused frozen identity bottleneck: the CUDA kernel's wrapper, its plain
version and the BatchNorm folding it needs; and the relu copy that is its
bandwidth floor.

Counterpart of the JAX package's ``ops/pallas_resnet.py`` and of
``tools/bench_fused_block.py::copy_floor``.  The kernels are
``csrc/identity_bottleneck.cu`` and ``csrc/copy_floor.cu``.  Arguments
keep the JAX layout: x is NHWC, conv kernels are HWIO, 1x1 kernels are
(C_in, C_out) matrices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from irp_tpu_torch import _kernels


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


def fused_identity_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """One fused identity bottleneck block: relu(x + f(x)).

    f = 1x1 conv (w1, b1) -> relu -> 3x3 same-pad conv (w2, b2) -> relu ->
    1x1 conv (w3, b3), every BN pre-folded (:func:`fold_bn_into_conv`).

    x: (B, H, W, C); w1: (C, M), w2: (3, 3, M, M), w3: (M, C) in x.dtype;
    b1/b2: (M,), b3: (C,) float32.  A CPU tensor runs
    :func:`reference_identity_bottleneck`; a CUDA tensor launches the
    kernel on the current stream (bf16 x and weights, C and M multiples
    of 64, contiguous) or raises.
    """
    _check_shapes(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return reference_identity_bottleneck(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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
    if c % 64 or m % 64:
        raise ValueError(f"kernel needs C and M multiples of 64, got C={c} "
                         f"M={m}")
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = _kernels.load("identity_bottleneck")
    with torch.cuda.device(x.device):
        code = lib.irp_identity_bottleneck(
            *(t.data_ptr() for t in args), out.data_ptr(), b, h, w, c, m,
            _kernels.stream_handle(x.device))
    _kernels.check(lib, code, "identity_bottleneck")
    fused_identity_bottleneck.launches += 1
    return out


fused_identity_bottleneck.launches = 0


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
