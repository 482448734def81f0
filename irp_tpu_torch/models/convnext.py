"""ConvNeXt Tiny-Large (the JAX package's ``models/convnext.py``).

torchvision's ``convnext`` architecture (a 4x4/4 patchify stem with
LayerNorm; four stages of CNBlocks, 7x7 depthwise conv -> LayerNorm ->
Linear 4x -> exact GELU -> Linear -> per-channel ``layer_scale`` ->
residual; LayerNorm + 2x2/2 conv downsamples between stages; a LayerNorm
on the pooled features) under torchvision's module names:

- ``features.0.{0,1}``: stem conv / LayerNorm;
- ``features.{2s-1}.{j}`` (s in 1..4): CNBlock, ``block.0`` (depthwise),
  ``block.2`` (LayerNorm), ``block.3`` / ``block.5`` (Linear), and
  ``layer_scale`` of shape (C, 1, 1);
- ``features.{2s-2}.{0,1}`` (s in 2..4): the LayerNorm / conv downsample
  into stage s;
- ``ln``: the post-pool LayerNorm (torchvision's ``classifier.0``; the
  port's head owns ``classifier.*``, so it sits in the backbone, as in
  the JAX package's ``.pth`` exports).

The maps are held in channels_last memory, so each LayerNorm and Linear
runs on the NHWC view with no copy (torchvision's Permute pair is a
view here).

Training, as the JAX package's ``ConvNeXt.__call__(train=True)``:
stochastic depth after the layer scale of every block, frozen stages
included, at ``p * block_id / max(total_blocks - 1, 1)`` (torchvision's
scaling, which differs from EfficientNet's), with the per-sample keep
masks given as arguments (``sd_probs`` names the blocks); the stem and
the first ``frozen_prefix`` stages, each with the downsample into it,
run without autograd (the JAX package's one ``stop_gradient`` cut);
``remat_blocks`` recomputes each trainable block in the backward.  There
is no BatchNorm, so no batch statistics.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from irp_tpu_torch.models.layers import (Conv2d, LayerNorm, Linear,
                                         flax_init_, global_pool, nchw, nhwc,
                                         stochastic_depth)
from irp_tpu_torch.models.resnet import frozen_scope, remat_call

STAGE_COUNT = 4

# torchvision.models.convnext block settings: per-stage channel dims and
# block depths, and each variant's stochastic_depth_prob default.
CONVNEXT_VARIANTS = {
    "tiny": dict(convnext_dims=(96, 192, 384, 768),
                 convnext_depths=(3, 3, 9, 3), stochastic_depth=0.1),
    "small": dict(convnext_dims=(96, 192, 384, 768),
                  convnext_depths=(3, 3, 27, 3), stochastic_depth=0.4),
    "base": dict(convnext_dims=(128, 256, 512, 1024),
                 convnext_depths=(3, 3, 27, 3), stochastic_depth=0.5),
    "large": dict(convnext_dims=(192, 384, 768, 1536),
                  convnext_depths=(3, 3, 27, 3), stochastic_depth=0.5),
}


def convnext_model_config(variant: str = "tiny", **overrides):
    """ModelConfig for a named torchvision ConvNeXt size
    (family='convnext'); ``overrides`` take precedence."""
    from irp_tpu_torch.config import ModelConfig

    if variant not in CONVNEXT_VARIANTS:
        raise ValueError(f"unknown ConvNeXt variant {variant!r} "
                         f"(one of {sorted(CONVNEXT_VARIANTS)})")
    return ModelConfig(family="convnext",
                       **{**CONVNEXT_VARIANTS[variant], **overrides})


def convnext_default_trainable_stages() -> tuple:
    """The ConvNeXt analog of freeze-all-but-layer4: the last stage and
    the final LayerNorm."""
    return ("stage4", "ln")


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of an NCHW map, on its NHWC view."""

    def forward(self, x):
        return nchw(super().forward(nhwc(x)))


class CNBlock(nn.Module):
    """dw 7x7 -> LN -> Linear 4x -> GELU -> Linear -> layer_scale ->
    stochastic depth (where ``sd_mask``, a (B,) bool keep mask, is given)
    -> residual."""

    def __init__(self, dim, dtype, sd_prob: float = 0.0):
        super().__init__()
        self.sd_prob = sd_prob
        # indices 1 and 6 are torchvision's Permutes, 4 its GELU
        self.block = nn.Sequential(
            Conv2d(dim, dim, 7, 1, 3, groups=dim, bias=True,
                   compute_dtype=dtype),
            nn.Identity(), LayerNorm(dim, 1e-6, dtype),
            Linear(dim, 4 * dim, dtype), nn.GELU(),
            Linear(4 * dim, dim, dtype))
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), 1e-6))

    def forward(self, x, sd_mask=None):
        dw, _, ln, fc1, gelu, fc2 = self.block
        y = fc2(gelu(fc1(ln(nhwc(dw(x))))))
        y = y * self.layer_scale.reshape(-1).to(y.dtype)
        if sd_mask is not None:
            y = stochastic_depth(y, sd_mask, 1.0 - self.sd_prob)
        return x + nchw(y)


class ConvNeXt(nn.Module):
    """Headless ConvNeXt returning pooled, LayerNormed features (B, C);
    input NCHW.  ``frozen_prefix`` (0-4) leading stages are frozen, the
    stem with them when > 0."""

    def __init__(self, dims=(96, 192, 384, 768), depths=(3, 3, 9, 3),
                 dtype=torch.bfloat16, frozen_prefix: int = 0,
                 stochastic_depth_prob: float = 0.0,
                 remat_blocks: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self.num_features = dims[-1]
        self.frozen_prefix = frozen_prefix
        self.remat_blocks = remat_blocks
        total = sum(depths)
        features = [nn.Sequential(
            Conv2d(3, dims[0], 4, 4, bias=True, compute_dtype=dtype),
            LayerNorm2d(dims[0], 1e-6, dtype))]
        block_id = 0
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            if i > 0:
                features.append(nn.Sequential(
                    LayerNorm2d(dims[i - 1], 1e-6, dtype),
                    Conv2d(dims[i - 1], dim, 2, 2, bias=True,
                           compute_dtype=dtype)))
            blocks = []
            for _ in range(depth):
                blocks.append(CNBlock(dim, dtype, stochastic_depth_prob
                                      * block_id / max(total - 1.0, 1.0)))
                block_id += 1
            features.append(nn.Sequential(*blocks))
        self.features = nn.Sequential(*features)
        self.ln = LayerNorm(dims[-1], 1e-6, dtype)

    def _stages(self):
        """(s, downsample into stage s or None, stage s's blocks)."""
        f = self.features
        for s in range(1, (len(f) + 1) // 2 + 1):
            yield s, (f[2 * s - 2] if s > 1 else None), f[2 * s - 1]

    def sd_probs(self) -> dict:
        """``{'stage<s>_block<j>': p}`` of the blocks stochastic depth may
        drop (p > 0), in forward order."""
        return {f"stage{s}_block{j}": blk.sd_prob
                for s, _, blocks in self._stages()
                for j, blk in enumerate(blocks) if blk.sd_prob > 0}

    def init_weights(self, generator=None) -> None:
        """flax's initializers; layer_scale 1e-6."""
        flax_init_(self, generator)
        for mod in self.modules():
            if isinstance(mod, CNBlock):
                with torch.no_grad():
                    mod.layer_scale.fill_(1e-6)

    def forward_spatial(self, x, sd_masks=None):
        """The last stage's map (B, C, h, w) before the pool;
        ``sd_masks`` (block name -> (B,) keep mask) drop residual branches
        (train mode)."""
        masks = sd_masks or {}
        remat = self.remat_blocks and torch.is_grad_enabled()
        with frozen_scope(self.frozen_prefix > 0):
            x = self.features[0](x.to(self.compute_dtype))
        for s, down, blocks in self._stages():
            frozen = s <= self.frozen_prefix
            with frozen_scope(frozen):
                if down is not None:
                    x = down(x)
                for j, blk in enumerate(blocks):
                    mask = masks.get(f"stage{s}_block{j}")
                    x = (remat_call(blk, x, mask) if remat and not frozen
                         else blk(x, mask))
        return x

    def pool(self, spatial):
        """The global pool and then the final LayerNorm (that LayerNorm
        sits after the pool): the features the head reads."""
        return self.ln(global_pool(spatial, self.compute_dtype))

    def forward(self, x, sd_masks=None):
        return self.pool(self.forward_spatial(x, sd_masks))
