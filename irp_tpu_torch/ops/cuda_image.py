"""The image-path kernels' wrappers and their plain versions.

Counterpart of the JAX package's ``ops/pallas_image.py``:

- :func:`eval_preprocess` (``pallas_eval_preprocess``): eval crop +
  normalize, kernel ``csrc/eval_preprocess.cu``.  The output is NHWC,
  which is the model's NCHW input in ``channels_last`` memory:
  ``out.permute(0, 3, 1, 2)`` is that input, with no copy.
- :func:`pairwise_dist` (``pallas_pairwise_dist``): squared Euclidean
  distances for the curation kNN, kernel ``csrc/pairwise_dist.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from irp_tpu_torch import _kernels
from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

_OUT_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _norm_rows(width: int, mean, std):
    """Per-lane scale/bias rows for the (H, W*C) view: out = x*scale+bias
    == (x/255 - mean_c) / std_c for lane l with c = l % 3."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale_c = 1.0 / (255.0 * std)
    bias_c = -mean / std
    scale = np.tile(scale_c, width)[None, :]
    bias = np.tile(bias_c, width)[None, :]
    return scale, bias


def _check_images(images_u8: torch.Tensor, out_size: int) -> None:
    if not isinstance(images_u8, torch.Tensor):
        raise TypeError("images must be a torch.Tensor")
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4 \
            or images_u8.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) uint8, got "
                         f"{tuple(images_u8.shape)} {images_u8.dtype}")
    h, w = images_u8.shape[1:3]
    if h < out_size or w < out_size:
        raise ValueError(f"images are {h}x{w}, smaller than the "
                         f"{out_size}x{out_size} crop")


def eval_preprocess_plain(images_u8: torch.Tensor, out_size: int = 224,
                          mean: Sequence[float] = IMAGENET_MEAN,
                          std: Sequence[float] = IMAGENET_STD,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same crop offsets and the
    same two f32 roundings (x*scale, then +bias) before the cast."""
    _check_images(images_u8, out_size)
    h, w = images_u8.shape[1:3]
    top, left = (h - out_size) // 2, (w - out_size) // 2
    crop = images_u8[:, top:top + out_size, left:left + out_size, :]
    scale, bias = _norm_rows(out_size, mean, std)
    dev = images_u8.device
    scale = torch.from_numpy(scale).reshape(out_size, 3).to(dev)
    bias = torch.from_numpy(bias).reshape(out_size, 3).to(dev)
    return (crop.to(torch.float32) * scale + bias).to(dtype)


def eval_preprocess(images_u8: torch.Tensor, out_size: int = 224,
                    mean: Sequence[float] = IMAGENET_MEAN,
                    std: Sequence[float] = IMAGENET_STD,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, out, out, 3) ``dtype``: center crop at
    ((H-out)//2, (W-out)//2), then ``x/255`` normalized by mean/std.

    A CPU tensor goes through :func:`eval_preprocess_plain`; a CUDA tensor
    launches the kernel on the current stream (bf16 or f32 output) or
    raises.
    """
    if images_u8.device.type == "cpu":
        return eval_preprocess_plain(images_u8, out_size, mean, std, dtype)
    _check_images(images_u8, out_size)
    if images_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {images_u8.device}")
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"kernel output dtype must be bfloat16 or float32, "
                         f"got {dtype}")
    if not images_u8.is_contiguous():
        raise ValueError("images must be contiguous")
    b, h, w, _ = images_u8.shape
    dev = images_u8.device
    out = torch.empty((b, out_size, out_size, 3), dtype=dtype, device=dev)
    if b == 0:
        return out
    scale, bias = _norm_rows(1, mean, std)
    c_scale = (ctypes.c_float * 3)(*scale.ravel().tolist())
    c_bias = (ctypes.c_float * 3)(*bias.ravel().tolist())
    lib = _kernels.load("eval_preprocess")
    with torch.cuda.device(dev):
        code = lib.irp_eval_preprocess(
            images_u8.data_ptr(), out.data_ptr(), b, h, w, out_size,
            _OUT_DTYPES[dtype], c_scale, c_bias, _kernels.stream_handle(dev))
    _kernels.check(lib, code, "eval_preprocess")
    eval_preprocess.launches += 1
    return out


eval_preprocess.launches = 0


def _pairwise_args(a, b, a_sq, b_sq):
    """Validated (b, a_sq, b_sq): b defaults to a, and each squared norm
    not given is computed."""
    if b is None:
        b = a
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D float32 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"a is {tuple(a.shape)} and b {tuple(b.shape)}: "
                         "their widths differ")
    if a_sq is None:
        a_sq = (a * a).sum(dim=1)
    if b_sq is None:
        b_sq = a_sq if b is a else (b * b).sum(dim=1)
    for name, t, rows in (("a_sq", a_sq, a), ("b_sq", b_sq, b)):
        if t.dtype != torch.float32 or tuple(t.shape) != (rows.shape[0],):
            raise ValueError(f"{name} must be a float32 vector with one "
                             f"value per row, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, t in (("b", b), ("a_sq", a_sq), ("b_sq", b_sq)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    return b, a_sq, b_sq


def pairwise_dist_plain(a: torch.Tensor, b: torch.Tensor | None = None,
                        a_sq: torch.Tensor | None = None,
                        b_sq: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in float32:
    ``(a_sq[:, None] + b_sq[None, :] - 2 a b^T).clamp_min(0)``."""
    b, a_sq, b_sq = _pairwise_args(a, b, a_sq, b_sq)
    return (a_sq[:, None] + b_sq[None, :] - 2.0 * (a @ b.T)).clamp_min(0.0)


def pairwise_dist(a: torch.Tensor, b: torch.Tensor | None = None,
                  a_sq: torch.Tensor | None = None,
                  b_sq: torch.Tensor | None = None) -> torch.Tensor:
    """Squared Euclidean distances ``max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)``:
    a (M, D) and b (N, D) float32 (b defaults to a) -> (M, N) float32.

    ``a_sq`` / ``b_sq`` are the rows' squared norms, computed here when
    not given.  A CPU tensor goes through :func:`pairwise_dist_plain`; a
    CUDA tensor launches the kernel on the current stream (contiguous
    inputs) or raises.  The kernel's result is a view of an (M, N')
    buffer whose row stride N' rounds N up to a multiple of 4, so every
    row starts 16-byte aligned.
    """
    if a.device.type == "cpu":
        return pairwise_dist_plain(a, b, a_sq, b_sq)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    b, a_sq, b_sq = _pairwise_args(a, b, a_sq, b_sq)
    for name, t in (("a", a), ("b", b), ("a_sq", a_sq), ("b_sq", b_sq)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, d = a.shape
    n = b.shape[0]
    ldo = -(-n // 4) * 4
    out = torch.empty((m, ldo), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out[:, :n]
    lib = _kernels.load("pairwise_dist")
    with torch.cuda.device(a.device):
        code = lib.irp_pairwise_dist(
            a.data_ptr(), b.data_ptr(), a_sq.data_ptr(), b_sq.data_ptr(),
            out.data_ptr(), m, n, d, ldo, _kernels.stream_handle(a.device))
    _kernels.check(lib, code, "pairwise_dist")
    pairwise_dist.launches += 1
    return out[:, :n]


pairwise_dist.launches = 0
