"""Train-mode BatchNorm as one op with a hand-written backward.

:func:`batch_norm_train` is the batch-statistics form of
``models/resnet.py::BatchNorm2d``: flax's moments (the mean and the biased
``E[x^2] - E[x]^2``, clipped at 0, in f32 over N, H and W), the running
buffers moved by ``momentum`` toward that mean and variance, and the
normalisation ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, rounded
to x's dtype.  It is a ``torch.autograd.Function`` whose backward is
written by hand: it saves x and the per-channel moments, not autograd's
f32 graph.  It runs on the card alone, each direction two passes of
``csrc/bn_train.cu``.

The plain versions are the formula as the CPU runs it, and the tests'
yardstick: :func:`batch_moments`, :func:`normalize_plain` and
:func:`update_running_stats` are what ``BatchNorm2d`` computes on every
path that does not take the op; :func:`batch_norm_train_plain` and
:func:`batch_norm_train_backward_plain` are the op's two directions.

The backward of the formula, per channel over its n = N*H*W elements, with
``xc = x - mean``, ``rstd = rsqrt(var + eps)`` and ``s = rstd * weight``::

    dx = s * (dy - sum(dy) / n) - s * rstd^2 * xc * sum(dy * xc) / n
    dweight = rstd * sum(dy * xc)        dbias = sum(dy)

where the second term of dx is dropped in a channel whose ``E[x^2] -
E[x]^2`` fell below 0, as the clamp's gradient drops it.  No counterpart
in the JAX package (XLA fuses and differentiates this BN there).
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from irp_tpu_torch import _kernels
from irp_tpu_torch.models.layers import at_least_f32

THREADS = 256  # a block of csrc/bn_train.cu
VEC = 8        # bf16 channels a thread
MAX_SW = 32    # vectors of a slab: a warp's 512 contiguous bytes of a row
# the fewest rows a thread of a reduction sums: the rows are split no finer
MIN_ROWS_PER_THREAD = 4


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def batch_moments(xf: torch.Tensor):
    """(mean, E[x^2]) of an NCHW map over N, H and W, in its dtype."""
    return xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))


def normalize_plain(xf, mean, var_raw, weight, bias, eps: float):
    """``(xf - mean) * (rsqrt(max(var_raw, 0) + eps) * weight) + bias`` in
    xf's dtype (f32, or f64 for f64 inputs), per channel of the NCHW map."""
    mul = torch.rsqrt(var_raw.clamp_min(0.0) + eps) * weight
    return (xf - _per_channel(mean)) * _per_channel(mul) \
        + _per_channel(bias)


def update_running_stats(running_mean, running_var, mean, var_raw,
                         momentum: float) -> None:
    """Move the running buffers by ``momentum`` toward the batch's mean
    and its clipped biased variance (``F.batch_norm`` would take the
    unbiased one, which the JAX package never does)."""
    with torch.no_grad():
        keep = 1.0 - momentum
        running_mean.copy_(keep * running_mean + momentum * mean)
        running_var.copy_(keep * running_var
                          + momentum * var_raw.clamp_min(0.0))


def batch_norm_train_plain(x, weight, bias, eps: float):
    """The op's forward in plain PyTorch: (y in x's dtype, moments), the
    moments a (2, C) tensor of the mean and the unclipped ``E[x^2] -
    mean^2``, f32 (f64 for f64 inputs).  The running buffers are
    :func:`update_running_stats`'s."""
    xf = at_least_f32(x)
    mean, ex2 = batch_moments(xf)
    var_raw = ex2 - mean * mean
    y = normalize_plain(xf, mean, var_raw, weight.to(xf.dtype),
                        bias.to(xf.dtype), eps)
    return y.to(x.dtype), torch.stack([mean, var_raw])


def batch_norm_train_backward_plain(dy, x, moments, weight, eps: float):
    """The op's backward in plain PyTorch: (dx in x's dtype, dweight,
    dbias) from the output's gradient, x and the forward's moments, in f32
    (f64 for f64 inputs), in the kernel's order (the module docstring's
    formula)."""
    xf = at_least_f32(x)
    dt = xf.dtype
    dyf = dy.to(dt)
    mean, var_raw = moments.to(dt)
    n = x.numel() // x.shape[1]
    rstd = torch.rsqrt(var_raw.clamp_min(0.0) + eps)
    xc = xf - _per_channel(mean)
    sum_dy = dyf.sum(dim=(0, 2, 3))
    sum_dy_xc = (dyf * xc).sum(dim=(0, 2, 3))
    s = rstd * weight.to(dt)
    a = sum_dy / n
    k = torch.where(var_raw >= 0, s * rstd * rstd * (sum_dy_xc / n),
                    torch.zeros_like(s))
    dx = _per_channel(s) * (dyf - _per_channel(a)) - _per_channel(k) * xc
    return dx.to(x.dtype), rstd * sum_dy_xc, sum_dy


class BnPlan(NamedTuple):
    """The tiling of ``csrc/bn_train.cu`` at one shape: ``sw`` 8-channel
    vectors by ``rp`` row phases a block, ``slabs`` blocks across the
    channels, ``splits`` row ranges in the two reductions (whose grid is
    splits x slabs)."""
    sw: int
    rp: int
    slabs: int
    splits: int


@functools.lru_cache(maxsize=256)
def bn_plan(rows: int, c: int, sms: int) -> BnPlan:
    """The kernels' tiling for a (rows, c) map on a card with ``sms``
    SMs: a slab is a warp's 512 bytes of a row or the whole row, the
    block's other threads take further rows, and the reductions split the
    rows until there are two blocks an SM (each thread keeping at least
    :data:`MIN_ROWS_PER_THREAD` rows), which keeps enough loads in flight
    to reach the card's bandwidth and the partials that the last block
    adds few."""
    cvec = c // VEC
    sw = min(cvec, MAX_SW)
    rp = THREADS // sw
    slabs = -(-cvec // sw)
    splits = max(1, min(-(-2 * sms // slabs),
                        -(-rows // (MIN_ROWS_PER_THREAD * rp))))
    splits = -(-rows // -(-rows // splits))  # no split without a row
    return BnPlan(sw, rp, slabs, splits)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Workspace(NamedTuple):
    counters: torch.Tensor  # int32, one a slab, left at 0 by the kernels
    scratch: torch.Tensor   # float32: the reductions' partials, dx's coef


# (device index, stream) -> _Workspace.  Kernels on one stream run in
# order, so the launches of every BatchNorm on it share one workspace.
_WORKSPACES: dict = {}


class _Launch(NamedTuple):
    """What the launches on one (N, C, H, W) map need: the library, the
    current stream of the map's device, its rows and channels, the plan
    and the stream's workspace."""
    lib: object
    stream: int
    rows: int
    c: int
    plan: BnPlan
    ws: _Workspace


def _launch(t: torch.Tensor) -> _Launch:
    n, c, h, w = t.shape
    rows = n * h * w
    index = t.get_device()
    plan = bn_plan(rows, c, _sm_count(index))
    stream = _kernels.stream_handle(t.device)
    scratch = 2 * plan.splits * c + 3 * c
    ws = _WORKSPACES.get((index, stream))
    if ws is None or ws.counters.numel() < plan.slabs \
            or ws.scratch.numel() < scratch:
        ws = _Workspace(
            torch.zeros(max(plan.slabs, 64), dtype=torch.int32,
                        device=t.device),
            torch.empty(max(scratch, 1 << 18), dtype=torch.float32,
                        device=t.device))
        _WORKSPACES[index, stream] = ws
    return _Launch(_kernels.load("bn_train"), stream, rows, c, plan, ws)


def _on_device(t: torch.Tensor):
    """The CUDA runtime launches on the current device: make it t's."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def _nhwc_memory(t: torch.Tensor) -> torch.Tensor:
    """``t`` (N, C, H, W) held in channels_last memory, 16-byte aligned:
    the kernels' (rows, C) map."""
    t = t.contiguous(memory_format=torch.channels_last)
    if t.data_ptr() % 16:
        t = t.clone(memory_format=torch.channels_last)
    return t


def _check_cuda(x, tensors) -> None:
    """Raise on what the kernels do not take: x (N, C, H, W) bf16 with C
    a multiple of 8 and 1 to 2^31 - 1 rows; each of ``tensors`` (name,
    tensor) float32 (C,), contiguous, 16-byte aligned, on x's device."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the kernels take bfloat16 x, got {x.dtype}")
    n, c, h, w = x.shape
    if c % VEC:
        raise ValueError(f"the kernels need C a multiple of {VEC}, got {c}")
    if not 0 < n * h * w < 2 ** 31:
        raise ValueError(f"the kernels need 1 to 2^31 - 1 rows, got "
                         f"{n * h * w}")
    index = x.get_device()
    for name, t in tensors:
        if t.get_device() != index or t.dtype != torch.float32 \
                or t.shape != (c,) or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be a contiguous, 16-byte aligned float32 "
                f"({c},) tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _stats_cuda(xl, running_mean, running_var, momentum: float,
                update: bool, at: _Launch = None):
    """The moments (2, C) of ``xl`` (channels_last bf16) by
    ``bn_fw_stats``; with ``update`` the running buffers move."""
    at = at or _launch(xl)
    moments = torch.empty((2, at.c), dtype=torch.float32, device=xl.device)
    with _on_device(xl):
        code = at.lib.irp_bn_fw_stats(
            xl.data_ptr(), at.rows, at.c, at.plan.sw, at.plan.rp,
            at.plan.splits, at.ws.scratch.data_ptr(),
            at.ws.counters.data_ptr(), moments.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(),
            1.0 - momentum, momentum, int(update), at.stream)
    _kernels.check(at.lib, code, "bn_fw_stats")
    return moments


def _normalize_cuda(xl, moments, weight, bias, eps: float,
                    at: _Launch = None):
    """y (channels_last bf16) from ``xl`` and its moments by
    ``bn_fw_normalize``."""
    at = at or _launch(xl)
    y = torch.empty_like(xl)
    with _on_device(xl):
        code = at.lib.irp_bn_fw_normalize(
            xl.data_ptr(), moments.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), eps, y.data_ptr(), at.rows, at.c, at.plan.sw,
            at.plan.rp, at.stream)
    _kernels.check(at.lib, code, "bn_fw_normalize")
    return y


def _forward_cuda(x, weight, bias, running_mean, running_var,
                  momentum: float, eps: float, update: bool):
    """(x in channels_last memory, y, moments) on the card."""
    _check_cuda(x, (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)))
    xl = _nhwc_memory(x)
    at = _launch(xl)
    moments = _stats_cuda(xl, running_mean, running_var, momentum, update,
                          at)
    y = _normalize_cuda(xl, moments, weight, bias, eps, at)
    batch_norm_train.launches += 1
    return xl, y, moments


def _backward_cuda(dy, xl, moments, weight, eps: float, need_dx: bool):
    """(dx or None, dweight, dbias) on the card: ``bn_bw_reduce``, then
    ``bn_bw_dx`` where dx is needed."""
    dyl = _nhwc_memory(dy)
    if dyl.dtype != torch.bfloat16 or dyl.shape != xl.shape:
        raise ValueError(f"the kernels take a bfloat16 dy of x's shape "
                         f"{tuple(xl.shape)}, got {dyl.dtype} "
                         f"{tuple(dyl.shape)}")
    at = _launch(xl)
    c, plan = at.c, at.plan
    dw = torch.empty(c, dtype=torch.float32, device=xl.device)
    db = torch.empty(c, dtype=torch.float32, device=xl.device)
    dx = torch.empty_like(xl) if need_dx else None
    # the partials, then dx's coefficients (s, a, k)
    partial = at.ws.scratch.data_ptr()
    coef = partial + 4 * 2 * plan.splits * c
    with _on_device(xl):
        code = at.lib.irp_bn_bw_reduce(
            dyl.data_ptr(), xl.data_ptr(), moments.data_ptr(),
            weight.data_ptr(), eps, at.rows, c, plan.sw, plan.rp,
            plan.splits, partial, at.ws.counters.data_ptr(), coef,
            dw.data_ptr(), db.data_ptr(), at.stream)
        _kernels.check(at.lib, code, "bn_bw_reduce")
        if need_dx:
            code = at.lib.irp_bn_bw_dx(
                dyl.data_ptr(), xl.data_ptr(), moments.data_ptr(), coef,
                dx.data_ptr(), at.rows, c, plan.sw, plan.rp, at.stream)
            _kernels.check(at.lib, code, "bn_bw_dx")
    batch_norm_train.backward_launches += 1
    return dx, dw, db


class _BatchNormTrain(torch.autograd.Function):
    """y = BN(x) with the batch's moments; saves x and the moments."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                momentum: float, eps: float, update: bool):
        x, y, moments = _forward_cuda(x, weight, bias, running_mean,
                                      running_var, momentum, eps, update)
        ctx.save_for_backward(x, weight, moments)
        ctx.eps = eps
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, moments = ctx.saved_tensors
        need_dx, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = _backward_cuda(dy, x, moments, weight, ctx.eps, need_dx)
        return (dx if need_dx else None,
                dw.to(weight.dtype) if need_w else None,
                db.to(weight.dtype) if need_b else None,
                None, None, None, None, None)


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum: float, eps: float, update: bool = True):
    """Train-mode BatchNorm of an NCHW map with the batch's moments (the
    module docstring), its backward written by hand.  With ``update`` the
    running buffers move by ``momentum`` (in place, outside autograd).

    It runs ``csrc/bn_train.cu`` (a CUDA bf16 x, C a multiple of 8;
    float32 weight, bias and running buffers of shape (C,); y in
    channels_last memory) or raises; the plain versions above are its
    two directions off the card.  ``batch_norm_train.launches`` counts
    its forwards and ``batch_norm_train.backward_launches`` its
    backwards."""
    if not x.is_cuda:
        raise ValueError(f"the kernels run on a CUDA device, got {x.device}")
    return _BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                 momentum, eps, update)


batch_norm_train.launches = 0
batch_norm_train.backward_launches = 0
