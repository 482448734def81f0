"""EfficientNet B0-B7 (the JAX package's ``models/efficientnet.py``).

torchvision's ``efficientnet`` architecture (MBConv: 1x1 expand ->
depthwise kxk -> squeeze-excitation -> 1x1 project, SiLU, channel and
depth scaling by ``_make_divisible`` and ceil, the B5-B7 BatchNorm eps of
1e-3) under torchvision's module names:

- ``features.0.{0,1}``: stem conv / BN;
- ``features.{s}.{j}.block.{k}`` (s in 1..7): MBConv submodules by role,
  ``expand`` (absent in stage 1, whose expand ratio is 1), ``dw``, ``se``
  (``fc1``/``fc2``, 1x1 convs with bias) and ``project``, each conv at
  ``.0`` and its BN at ``.1``;
- ``features.8.{0,1}``: the final 1x1 conv / BN.

Convs compute in the compute dtype from f32 params; BatchNorm in f32 with
its output cast back (``models/resnet.py::BatchNorm2d``).  The SE squeeze
is a mean in f32, cast to the compute dtype.

Training, as the JAX package's ``EfficientNet.__call__(train=True)``:

- stochastic depth on every residual MBConv, frozen stages included, at
  ``p * block_id / total_blocks`` (block_id counts every block), with
  the per-sample keep masks given as arguments (``sd_probs`` names the
  blocks; ``models/layers.py::sample_sd_masks`` draws them);
- ``frozen_prefix`` leading stages (and the stem, when it is > 0) run
  without autograd: the JAX package's one ``stop_gradient`` cut;
- under ``bn_stats_mode='trainable_only'`` the BN of the stem and of the
  frozen stages stays in inference form (``BatchNorm2d.frozen``), the top
  BN too when ``top_frozen``; under 'all' every BN collects batch
  statistics;
- ``remat_blocks`` recomputes each trainable block in the backward
  (``models/resnet.py::remat_call``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from irp_tpu_torch.models.layers import (Conv2d, at_least_f32, flax_init_,
                                         global_pool, stochastic_depth)
from irp_tpu_torch.models.resnet import BatchNorm2d, frozen_scope, remat_call

# torchvision _efficientnet_conf base table (expand_ratio, kernel, stride,
# input_channels, out_channels, num_layers), scaled per variant by
# (width_mult, depth_mult) with _make_divisible / ceil rounding.
_BASE_SETTING = (
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
)

# (width_mult, depth_mult, default train resolution, torchvision head
# dropout).  B5-B7 additionally use the TF-port BatchNorm constants.
EFFICIENTNET_VARIANTS = {
    "b0": dict(width_mult=1.0, depth_mult=1.0, resolution=224, dropout=0.2),
    "b1": dict(width_mult=1.0, depth_mult=1.1, resolution=240, dropout=0.2),
    "b2": dict(width_mult=1.1, depth_mult=1.2, resolution=260, dropout=0.3),
    "b3": dict(width_mult=1.2, depth_mult=1.4, resolution=300, dropout=0.3),
    "b4": dict(width_mult=1.4, depth_mult=1.8, resolution=380, dropout=0.4),
    "b5": dict(width_mult=1.6, depth_mult=2.2, resolution=456, dropout=0.4),
    "b6": dict(width_mult=1.8, depth_mult=2.6, resolution=528, dropout=0.5),
    "b7": dict(width_mult=2.0, depth_mult=3.1, resolution=600, dropout=0.5),
}
_TF_BN_VARIANTS = ("b5", "b6", "b7")  # eps 1e-3, torch momentum 0.01

STAGE_COUNT = len(_BASE_SETTING)


def make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision.models._utils._make_divisible (channel rounding)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def scaled_setting(width_mult: float, depth_mult: float):
    """The per-stage (expand, kernel, stride, in_ch, out_ch, layers) table
    after width/depth scaling."""
    out = []
    for expand, kernel, stride, in_ch, out_ch, layers in _BASE_SETTING:
        out.append((expand, kernel, stride,
                    make_divisible(in_ch * width_mult),
                    make_divisible(out_ch * width_mult),
                    int(math.ceil(layers * depth_mult))))
    return tuple(out)


def top_channels(width_mult: float) -> int:
    """features.8's output width: 4x the last stage's (scaled) width."""
    return 4 * make_divisible(_BASE_SETTING[-1][4] * width_mult)


def bn_constants(width_mult: float, depth_mult: float):
    """(epsilon, flax momentum) of a variant's BatchNorm layers: B5-B7
    (from the TF port) eps 1e-3 and torch momentum 0.01, the others
    nn.BatchNorm2d's defaults.  Keyed by the multipliers, so conversion
    needs no variant name."""
    for name in _TF_BN_VARIANTS:
        v = EFFICIENTNET_VARIANTS[name]
        if (v["width_mult"], v["depth_mult"]) == (width_mult, depth_mult):
            return 1e-3, 0.99
    return 1e-5, 0.9


def efficientnet_model_config(variant: str = "b0", **overrides):
    """ModelConfig for a named torchvision EfficientNet size
    (family='efficientnet'): the variant's train resolution is the
    default image_size and its head dropout the default dropout_rate;
    ``overrides`` take precedence."""
    from irp_tpu_torch.config import ModelConfig

    if variant not in EFFICIENTNET_VARIANTS:
        raise ValueError(f"unknown EfficientNet variant {variant!r} "
                         f"(one of {sorted(EFFICIENTNET_VARIANTS)})")
    v = EFFICIENTNET_VARIANTS[variant]
    return ModelConfig(family="efficientnet",
                       **{**dict(width_mult=v["width_mult"],
                                 depth_mult=v["depth_mult"],
                                 image_size=v["resolution"],
                                 dropout_rate=v["dropout"]),
                          **overrides})


def efficientnet_default_trainable_stages() -> tuple:
    """The EfficientNet analog of freeze-all-but-layer4: the last MBConv
    stage and the final 1x1 conv."""
    return ("stage7", "top")


def _conv_bn(cin, cout, kernel, stride, groups, dtype, eps, momentum,
             act):
    """torchvision's Conv2dNormActivation: conv (no bias) at index 0, BN
    (with the variant's eps and momentum) at 1, SiLU at 2 when ``act``."""
    bn = BatchNorm2d(cout, dtype)
    bn.eps, bn.momentum = eps, momentum
    layers = [Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups,
                     compute_dtype=dtype), bn]
    if act:
        layers.append(nn.SiLU())
    return nn.Sequential(*layers)


class SqueezeExcitation(nn.Module):
    """SE with SiLU: mean in f32 (cast back), fc1 1x1, SiLU, fc2 1x1,
    sigmoid scale.  The squeeze width is the block INPUT's // 4."""

    def __init__(self, channels, squeeze, dtype):
        super().__init__()
        self.fc1 = Conv2d(channels, squeeze, 1, bias=True,
                          compute_dtype=dtype)
        self.fc2 = Conv2d(squeeze, channels, 1, bias=True,
                          compute_dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        s = at_least_f32(x).mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = self.fc2(F.silu(self.fc1(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Inverted residual with squeeze-excitation; the residual when the
    stride is 1 and the widths match, its branch dropped per sample where
    ``sd_mask`` (a (B,) bool keep mask) is False."""

    def __init__(self, in_ch, out_ch, expand_ratio, kernel, stride, dtype,
                 eps, momentum, sd_prob: float = 0.0):
        super().__init__()
        self.sd_prob = sd_prob
        expanded = (make_divisible(in_ch * expand_ratio)
                    if expand_ratio != 1 else in_ch)
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(in_ch, expanded, 1, 1, 1, dtype, eps,
                                   momentum, True))
        layers.append(_conv_bn(expanded, expanded, kernel, stride, expanded,
                               dtype, eps, momentum, True))
        layers.append(SqueezeExcitation(expanded, max(1, in_ch // 4),
                                        dtype))
        layers.append(_conv_bn(expanded, out_ch, 1, 1, 1, dtype, eps,
                               momentum, False))
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x, sd_mask=None):
        y = self.block(x)
        if not self.use_res:
            return y
        if sd_mask is not None:
            y = stochastic_depth(y, sd_mask, 1.0 - self.sd_prob)
        return y + x


class EfficientNet(nn.Module):
    """Headless EfficientNet returning globally pooled features (B, C);
    input NCHW.  ``frozen_prefix`` (0-7) leading MBConv stages are frozen
    (the stem with them when > 0); ``top_frozen`` sets the top BN's form
    under 'trainable_only'."""

    def __init__(self, width_mult=1.0, depth_mult=1.0,
                 dtype=torch.bfloat16, frozen_prefix: int = 0,
                 top_frozen: bool = False,
                 bn_stats_mode: str = "trainable_only",
                 stochastic_depth_prob: float = 0.0,
                 remat_blocks: bool = False):
        super().__init__()
        if bn_stats_mode not in ("trainable_only", "all"):
            raise ValueError(f"unknown bn_stats_mode {bn_stats_mode!r}")
        setting = scaled_setting(width_mult, depth_mult)
        eps, flax_momentum = bn_constants(width_mult, depth_mult)
        momentum = round(1.0 - flax_momentum, 6)
        self.compute_dtype = dtype
        self.num_features = top_channels(width_mult)
        self.frozen_prefix = frozen_prefix
        self.remat_blocks = remat_blocks
        total_blocks = sum(s[5] for s in setting)
        features = [_conv_bn(3, setting[0][3], 3, 2, 1, dtype, eps, momentum,
                             True)]
        block_id = 0
        for expand, kernel, stride, in_ch, out_ch, layers in setting:
            blocks = []
            for j in range(layers):
                blocks.append(MBConv(
                    in_ch if j == 0 else out_ch, out_ch, expand, kernel,
                    stride if j == 0 else 1, dtype, eps, momentum,
                    stochastic_depth_prob * block_id / total_blocks))
                block_id += 1
            features.append(nn.Sequential(*blocks))
        features.append(_conv_bn(setting[-1][4], self.num_features, 1, 1, 1,
                                 dtype, eps, momentum, True))
        self.features = nn.Sequential(*features)
        # which BNs stay in inference form under .train(): the stem with
        # any frozen stage, the frozen stages, the top when top_frozen
        trainable_only = bn_stats_mode == "trainable_only"
        frozen_parts = [frozen_prefix > 0] + [
            s <= frozen_prefix for s in range(1, len(setting) + 1)] + [
            top_frozen]
        for part, frozen in zip(self.features, frozen_parts):
            for mod in part.modules():
                if isinstance(mod, BatchNorm2d):
                    mod.frozen = trainable_only and frozen

    def sd_probs(self) -> dict:
        """``{'stage<s>_block<j>': p}`` of the blocks whose residual branch
        stochastic depth may drop (p > 0), in forward order."""
        return {f"stage{s}_block{j}": blk.sd_prob
                for s, stage in enumerate(self.features[1:-1], 1)
                for j, blk in enumerate(stage)
                if blk.use_res and blk.sd_prob > 0}

    def init_weights(self, generator=None) -> None:
        """flax's initializers (``models/layers.py::flax_init_``)."""
        flax_init_(self, generator)

    def forward_spatial(self, x, sd_masks=None):
        """The final conv's map (B, C, h, w) before the global pool;
        ``sd_masks`` (block name -> (B,) keep mask) drop residual branches
        (train mode)."""
        masks = sd_masks or {}
        stem, *stages, top = self.features
        remat = self.remat_blocks and torch.is_grad_enabled()
        with frozen_scope(self.frozen_prefix > 0):
            x = stem(x.to(self.compute_dtype))
        for s, stage in enumerate(stages, 1):
            frozen = s <= self.frozen_prefix
            with frozen_scope(frozen):
                for j, blk in enumerate(stage):
                    mask = masks.get(f"stage{s}_block{j}")
                    x = (remat_call(blk, x, mask) if remat and not frozen
                         else blk(x, mask))
        return top(x)

    def pool(self, spatial):
        return global_pool(spatial, self.compute_dtype)

    def forward(self, x, sd_masks=None):
        return self.pool(self.forward_spatial(x, sd_masks))
