"""Layers the model families share: flax's ``dtype``/``param_dtype`` pair
in PyTorch.

Parameters are f32.  A conv or a dense layer casts its input, weight and
bias to the compute dtype per op, as flax's ``nn.Conv``/``nn.Dense`` with
``dtype=bfloat16`` do; a LayerNorm computes in f32 (f64 stays) and casts
its output to the compute dtype, as flax's ``nn.LayerNorm`` does, so an
f32 input (the Grad-CAM surface's tokens) still gives a compute-dtype
output.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (2 sigma) of variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as is in float64 (the reference precision a
    float64 ``compute_dtype`` keeps end to end)."""
    return x if x.dtype == torch.float64 else x.float()


class Linear(nn.Linear):
    """Dense layer computed in ``compute_dtype`` from f32 params."""

    def __init__(self, fin, fout, compute_dtype=torch.bfloat16):
        super().__init__(fin, fout)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """Conv computed in ``compute_dtype`` from f32 params; bias-free (the
    convs a BatchNorm follows) unless ``bias``, flax ``nn.Conv``'s
    default."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1,
                 bias=False, compute_dtype=torch.bfloat16):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         groups=groups, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, 1, self.groups)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis in f32 (f64 stays), output cast to
    ``compute_dtype`` (f64 when the input is f64)."""

    def __init__(self, dim, eps=1e-6, compute_dtype=torch.bfloat16):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        xf = at_least_f32(x)
        dt = xf.dtype
        y = F.layer_norm(xf, self.normalized_shape, self.weight.to(dt),
                         self.bias.to(dt), self.eps)
        return y.to(torch.float64 if dt == torch.float64
                    else self.compute_dtype)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW tensor (a view when it is held in
    channels_last memory)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor."""
    return x.permute(0, 3, 1, 2)


def global_pool(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Global average pool of an NCHW map in f32 (f64 stays), cast to
    ``dtype``: (B, C, h, w) -> (B, C)."""
    return at_least_f32(x).mean(dim=(2, 3)).to(dtype)


def flax_init_(module: nn.Module, generator=None) -> None:
    """flax's default initializers over ``module``: lecun_normal conv and
    dense kernels, zero biases, LayerNorm and BatchNorm scale 1 and bias
    0 (BatchNorm's running mean 0 and variance 1)."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            if mod.bias is not None:
                with torch.no_grad():
                    mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.reset_parameters()


def stochastic_depth(y: torch.Tensor, mask: torch.Tensor,
                     keep: float) -> torch.Tensor:
    """Row-mode stochastic depth (torchvision's ``StochasticDepth``, the
    JAX package's ``_stochastic_depth``): ``where(mask[:, None, None,
    None], y / keep, 0)`` for a (B,) bool ``mask`` of the samples whose
    residual branch survives, ``keep`` rounded to y's dtype first, as
    ``y / jnp.asarray(keep, y.dtype)`` does.  ``y`` is 4-D (NCHW or
    NHWC: the batch axis leads either way)."""
    divisor = float(torch.tensor(keep).to(y.dtype))
    return torch.where(mask.reshape(-1, 1, 1, 1), y / divisor,
                       torch.zeros_like(y))


def sample_sd_masks(probs, batch: int, generator=None,
                    device=None) -> dict:
    """Each block's (B,) keep mask, Bernoulli(1 - p) per sample, for the
    ``{block name: drop probability}`` of a backbone
    (``sd_probs()``), drawn in block order from ``generator`` (a
    generator on ``device``; the default generator when None)."""
    return {name: torch.rand(batch, generator=generator,
                             device=device) < 1.0 - p
            for name, p in probs.items()}
