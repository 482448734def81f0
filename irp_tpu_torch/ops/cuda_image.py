"""Eval crop + normalize: the CUDA kernel's wrapper and its plain version.

Counterpart of the JAX package's ``ops/pallas_image.py``
(``pallas_eval_preprocess``).  The kernel is ``csrc/eval_preprocess.cu``.
The output is NHWC, which is the model's NCHW input in ``channels_last``
memory: ``out.permute(0, 3, 1, 2)`` is that input, with no copy.
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
