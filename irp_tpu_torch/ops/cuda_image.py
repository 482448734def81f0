"""The image-path kernels' wrappers and their plain versions.

Counterpart of the JAX package's ``ops/pallas_image.py``:

- :func:`eval_preprocess` (``pallas_eval_preprocess``): eval crop +
  normalize, kernel ``csrc/eval_preprocess.cu``, behind the custom op
  ``irp_tpu_torch::eval_preprocess`` (``torch.library``; CPU kernel the
  plain version, fake kernel the output's shape for ``torch.export``).  The output is NHWC,
  which is the model's NCHW input in ``channels_last`` memory:
  ``out.permute(0, 3, 1, 2)`` is that input, with no copy.
- :func:`pairwise_topk` (``pallas_pairwise_dist`` and the top-k that the
  curation kNN applies to its output): the k nearest columns of each
  row, kernel ``csrc/pairwise_topk.cu``.  :func:`pairwise_dist_plain` is
  the distance formula both it and the TPU kernel compute.
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

    Goes through the custom op ``irp_tpu_torch::eval_preprocess``, which
    ``torch.export`` keeps as one node: a CPU tensor runs
    :func:`eval_preprocess_plain`; a CUDA tensor launches the kernel on the
    current stream (bf16 or f32 output) or raises.
    """
    _check_images(images_u8, out_size)
    if images_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {images_u8.device}")
    return torch.ops.irp_tpu_torch.eval_preprocess(
        images_u8, int(out_size), [float(v) for v in mean],
        [float(v) for v in std], dtype)


eval_preprocess.launches = 0


@torch.library.custom_op("irp_tpu_torch::eval_preprocess", mutates_args=(),
                         device_types="cpu")
def _eval_preprocess_op(images_u8: torch.Tensor, out_size: int,
                        mean: Sequence[float], std: Sequence[float],
                        dtype: torch.dtype) -> torch.Tensor:
    return eval_preprocess_plain(images_u8, out_size, mean, std, dtype)


@_eval_preprocess_op.register_fake
def _(images_u8, out_size, mean, std, dtype):
    return images_u8.new_empty((images_u8.shape[0], out_size, out_size, 3),
                               dtype=dtype)


@_eval_preprocess_op.register_kernel("cuda")
def _(images_u8, out_size, mean, std, dtype):
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


# the kernel's limits on the card: its per-row lists and its resident rows
# of a live in shared memory
TOPK_MAX_K = 128
TOPK_MAX_D = 128


def _topk_args(a, b, k, a_sq, b_sq, self_offset):
    """Validated (b, a_sq, b_sq) for a top-k call, and k checked against
    the columns a row has once its own is left out."""
    b, a_sq, b_sq = _pairwise_args(a, b, a_sq, b_sq)
    n = b.shape[0]
    limit = n - 1 if self_offset >= 0 else n
    if not isinstance(k, (int, np.integer)) or k < 1 or k > limit:
        raise ValueError(f"k must be an int in [1, {limit}] for {n} columns"
                         f"{' with self excluded' if self_offset >= 0 else ''}"
                         f", got {k!r}")
    return b, a_sq, b_sq


def pairwise_topk_plain(a: torch.Tensor, b: torch.Tensor | None, k: int,
                        a_sq: torch.Tensor | None = None,
                        b_sq: torch.Tensor | None = None,
                        self_offset: int = -1):
    """Plain PyTorch version of the kernel: :func:`pairwise_dist_plain`,
    column ``i + self_offset`` of row i set to +inf when ``self_offset >=
    0`` (as the JAX knn does to its own column), then the k smallest of
    each row in ascending order of (distance, index), by a stable sort.
    Returns (squared distances (M, k) float32, indices (M, k) int32)."""
    b, a_sq, b_sq = _topk_args(a, b, k, a_sq, b_sq, self_offset)
    d = pairwise_dist_plain(a, b, a_sq, b_sq)
    if self_offset >= 0:
        rows = torch.arange(max(0, min(a.shape[0], b.shape[0] - self_offset)),
                            device=a.device)
        d[rows, rows + self_offset] = float("inf")
    d, idx = torch.sort(d, dim=1, stable=True)
    return d[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def pairwise_topk(a: torch.Tensor, b: torch.Tensor | None, k: int,
                  a_sq: torch.Tensor | None = None,
                  b_sq: torch.Tensor | None = None, self_offset: int = -1):
    """The k nearest columns of every row: a (M, D) and b (N, D) float32
    (b defaults to a) -> (squared distances (M, k) float32, indices (M, k)
    int32), each row in ascending order of (distance, index), distances
    ``max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)``.  Column ``i + self_offset``
    of row i is left out when ``self_offset >= 0``; k is at most the
    columns a row has left.

    ``a_sq`` / ``b_sq`` are the rows' squared norms, computed here when
    not given.  A CPU tensor goes through :func:`pairwise_topk_plain`; a
    CUDA tensor launches the kernel on the current stream (contiguous
    inputs, k <= TOPK_MAX_K, D <= TOPK_MAX_D) or raises.  The kernel reads
    rows of a width that is a multiple of 4; other widths are padded here
    with zero columns, which change no distance (``knn`` pads once).
    """
    if a.device.type == "cpu":
        return pairwise_topk_plain(a, b, k, a_sq, b_sq, self_offset)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    b, a_sq, b_sq = _topk_args(a, b, k, a_sq, b_sq, self_offset)
    if k > TOPK_MAX_K:
        raise ValueError(f"k = {k} exceeds the kernel's cap of {TOPK_MAX_K} "
                         "neighbours a row on the card")
    for name, t in (("a", a), ("b", b), ("a_sq", a_sq), ("b_sq", b_sq)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, d = a.shape
    n = b.shape[0]
    dp = -(-max(d, 1) // 4) * 4
    if dp > TOPK_MAX_D:
        raise ValueError(f"width {d} exceeds the kernel's cap of "
                         f"{TOPK_MAX_D} on the card")
    if dp != d:
        a = torch.nn.functional.pad(a, (0, dp - d))
        b = torch.nn.functional.pad(b, (0, dp - d))
    out_d = torch.empty((m, k), dtype=torch.float32, device=a.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=a.device)
    if m == 0:
        return out_d, out_i
    lib = _kernels.load("pairwise_topk")
    with torch.cuda.device(a.device):
        splits = lib.irp_pairwise_topk_splits(m, n, dp, k)
        if splits < 1:
            _kernels.check(lib, -splits, "pairwise_topk")
        part = torch.empty((splits, m, k), dtype=torch.int64, device=a.device)
        bound = torch.empty((m, k), dtype=torch.int32, device=a.device)
        code = lib.irp_pairwise_topk(
            a.data_ptr(), b.data_ptr(), a_sq.data_ptr(), b_sq.data_ptr(),
            part.data_ptr(), bound.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), m, n, dp, k, self_offset, splits,
            _kernels.stream_handle(a.device))
    _kernels.check(lib, code, "pairwise_topk")
    pairwise_topk.launches += 1
    return out_d, out_i


pairwise_topk.launches = 0
