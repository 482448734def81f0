"""Vision Transformer (the JAX package's ``models/vit.py``).

torchvision's ``vision_transformer`` architecture (pre-LN encoder blocks,
LayerNorm eps 1e-6, exact-erf GELU, CLS-token pooling) under torchvision's
module names, so a torchvision ``vit_*`` state_dict loads as it is:

- ``conv_proj`` (patch embedding), ``class_token``,
  ``encoder.pos_embedding``;
- ``encoder.layers.encoder_layer_{i}``: ``ln_1``,
  ``self_attention.in_proj_weight``/``in_proj_bias`` (q, k and v packed,
  (3E, E)), ``self_attention.out_proj``, ``ln_2``, ``mlp.0``, ``mlp.3``;
- ``encoder.ln`` (final LayerNorm).

The JAX package keeps q, k and v as three Dense layers
(``attn_q/k/v``); ``models/convert.py`` splits ``in_proj`` into them and
joins them back.

Numerics as the JAX package's: parameters f32, matmuls and the residual
stream in the compute dtype, attention scores in the compute dtype and
their softmax in f32, cast back before the product with V.

``prefix_tokens`` / ``suffix_feature`` split the forward around the LAST
encoder block: the Grad-CAM surface (``explain.py``) differentiates the
last block, the final LayerNorm and the head with respect to the tokens
entering that block; neither applies the cut below.

Training: the train-mode forward is the eval one (no dropout inside the
encoder, no BatchNorm, no stochastic depth).  The embedding and the first
``frozen_prefix`` blocks run without autograd (the JAX package's one
``stop_gradient`` cut after block ``frozen_prefix - 1``), and
``remat_blocks`` recomputes each trainable block in the backward.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from irp_tpu_torch.models.layers import (Conv2d, LayerNorm, Linear,
                                         flax_init_, global_pool,
                                         lecun_normal_, nhwc)
from irp_tpu_torch.models.resnet import frozen_scope, remat_call

# torchvision.models.vision_transformer's published sizes.  vit_h_14 is
# the one family member whose head_dim is not 64 (1280/16 = 80), so it
# carries an explicit num_heads; the others leave 0 = embed_dim // 64.
VIT_VARIANTS = {
    "b_16": dict(patch_size=16, embed_dim=768, num_layers=12, mlp_dim=3072),
    "b_32": dict(patch_size=32, embed_dim=768, num_layers=12, mlp_dim=3072),
    "l_16": dict(patch_size=16, embed_dim=1024, num_layers=24,
                 mlp_dim=4096),
    "l_32": dict(patch_size=32, embed_dim=1024, num_layers=24,
                 mlp_dim=4096),
    "h_14": dict(patch_size=14, embed_dim=1280, num_layers=32,
                 mlp_dim=5120, num_heads=16),
}


def vit_model_config(variant: str = "b_16", **overrides):
    """ModelConfig for a named torchvision ViT size (family='vit');
    ``overrides`` take precedence over the variant's geometry."""
    from irp_tpu_torch.config import ModelConfig

    if variant not in VIT_VARIANTS:
        raise ValueError(f"unknown ViT variant {variant!r} "
                         f"(one of {sorted(VIT_VARIANTS)})")
    return ModelConfig(family="vit", **{**VIT_VARIANTS[variant],
                                        **overrides})


def resolve_num_heads(cfg) -> int:
    """``num_heads=0`` means head_dim 64 (every torchvision ViT but
    h_14)."""
    return cfg.num_heads or cfg.embed_dim // 64


def vit_default_trainable_stages(num_layers: int) -> tuple:
    """The ViT analog of freeze-all-but-layer4: the last encoder block and
    the final LayerNorm."""
    return (f"block{num_layers - 1}", "ln")


class SelfAttention(nn.Module):
    """torchvision's ``nn.MultiheadAttention`` parameter layout (packed
    ``in_proj``, ``out_proj``) with the JAX package's numerics."""

    def __init__(self, embed_dim, num_heads, compute_dtype):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, compute_dtype)
        self.compute_dtype = compute_dtype

    def qkv(self, y):
        """(B, S, E) -> q, k, v as (B, H, S, D) in the compute dtype."""
        dt = self.compute_dtype
        b, s, e = y.shape
        h = self.num_heads
        qkv = F.linear(y.to(dt), self.in_proj_weight.to(dt),
                       self.in_proj_bias.to(dt))
        return qkv.view(b, s, 3, h, e // h).permute(2, 0, 3, 1, 4).unbind(0)

    def forward(self, y):
        q, k, v = self.qkv(y)
        b, h, s, d = q.shape
        scores = (q @ k.transpose(-1, -2)) * (d ** -0.5)
        attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        o = (attn @ v).transpose(1, 2).reshape(b, s, h * d)
        return self.out_proj(o)


class EncoderBlock(nn.Module):
    """Pre-LN block: x = x + attn(ln_1(x)); x = x + mlp(ln_2(x)).  The
    residual adds run in the promoted dtype of their operands, as in the
    JAX package (an f32 token input keeps an f32 stream)."""

    def __init__(self, embed_dim, num_heads, mlp_dim, compute_dtype):
        super().__init__()
        self.ln_1 = LayerNorm(embed_dim, 1e-6, compute_dtype)
        self.self_attention = SelfAttention(embed_dim, num_heads,
                                            compute_dtype)
        self.ln_2 = LayerNorm(embed_dim, 1e-6, compute_dtype)
        # torchvision's MLPBlock: 0 Linear, 1 GELU, 2 Dropout, 3 Linear,
        # 4 Dropout (keys mlp.0 and mlp.3)
        self.mlp = nn.Sequential(
            Linear(embed_dim, mlp_dim, compute_dtype), nn.GELU(),
            nn.Identity(), Linear(mlp_dim, embed_dim, compute_dtype),
            nn.Identity())

    def forward(self, x):
        x = x + self.self_attention(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Encoder(nn.Module):
    def __init__(self, seq_length, num_layers, embed_dim, num_heads,
                 mlp_dim, compute_dtype):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length,
                                                      embed_dim))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}",
             EncoderBlock(embed_dim, num_heads, mlp_dim, compute_dtype))
            for i in range(num_layers)))
        self.ln = LayerNorm(embed_dim, 1e-6, compute_dtype)


class VisionTransformer(nn.Module):
    """Headless ViT returning the CLS-token feature (B, E) in the compute
    dtype; input NCHW."""

    def __init__(self, patch_size=16, embed_dim=768, num_layers=12,
                 num_heads=12, mlp_dim=3072, image_size=224,
                 dtype=torch.bfloat16, frozen_prefix: int = 0,
                 remat_blocks: bool = False):
        super().__init__()
        self.frozen_prefix = frozen_prefix
        self.remat_blocks = remat_blocks
        self.patch_size = patch_size
        self.image_size = image_size
        self.compute_dtype = dtype
        self.num_features = embed_dim
        self.conv_proj = Conv2d(3, embed_dim, patch_size, patch_size,
                                bias=True, compute_dtype=dtype)
        self.class_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        grid = image_size // patch_size
        self.encoder = Encoder(grid * grid + 1, num_layers, embed_dim,
                               num_heads, mlp_dim, dtype)

    def init_weights(self, generator=None) -> None:
        """flax's initializers: lecun_normal kernels, zero biases and
        class token, pos_embedding N(0, 0.02)."""
        flax_init_(self, generator)
        e = self.num_features
        for blk in self.encoder.layers:
            # flax initializes q, k and v as three (E, E) Dense kernels
            w = blk.self_attention.in_proj_weight
            for j in range(3):
                lecun_normal_(w.data[j * e:(j + 1) * e], e, generator)
            blk.self_attention.in_proj_bias.data.zero_()
        with torch.no_grad():
            self.class_token.zero_()
            self.encoder.pos_embedding.normal_(0.0, 0.02,
                                               generator=generator)

    def embed(self, x):
        """Patchify, prepend CLS, add positions: NCHW -> (B, S, E)."""
        x = self.conv_proj(x)
        b, e, gh, gw = x.shape
        if gh * gw + 1 != self.encoder.pos_embedding.shape[1]:
            raise ValueError(
                f"input gives a {gh}x{gw} patch grid but pos_embedding "
                f"was built for image_size={self.image_size} "
                f"(patch {self.patch_size})")
        x = nhwc(x).reshape(b, gh * gw, e)
        cls = self.class_token.to(x.dtype).expand(b, 1, e)
        x = torch.cat([cls, x], dim=1)
        return x + self.encoder.pos_embedding.to(x.dtype)

    def sd_probs(self) -> dict:
        """No block of a ViT has stochastic depth."""
        return {}

    def encode(self, x):
        """Embed and every block, the embedding and the first
        ``frozen_prefix`` blocks without autograd: (B, S, E) before the
        final LayerNorm."""
        remat = self.remat_blocks and torch.is_grad_enabled()
        with frozen_scope(self.frozen_prefix > 0):
            x = self.embed(x)
        for i, blk in enumerate(self.encoder.layers):
            frozen = i < self.frozen_prefix
            with frozen_scope(frozen):
                x = remat_call(blk, x) if remat and not frozen else blk(x)
        return x

    def forward(self, x, sd_masks=None):
        del sd_masks  # no stochastic depth in a ViT
        return self.encoder.ln(self.encode(x)[:, 0])

    def forward_spatial(self, x):
        """The post-LN patch-token grid (B, E, gh, gw) (the CLS token is
        the classification feature, not a pool of this grid)."""
        x = self.encoder.ln(self.encode(x))[:, 1:]
        b, s, e = x.shape
        g = math.isqrt(s)
        return x.reshape(b, g, g, e).permute(0, 3, 1, 2)

    def prefix_tokens(self, x):
        """Embed and blocks 0..L-2: the tokens entering the last block,
        (B, S, E)."""
        x = self.embed(x)
        for blk in list(self.encoder.layers)[:-1]:
            x = blk(x)
        return x

    def suffix_feature(self, tokens):
        """The last block, the final LayerNorm and the CLS pick: (B, S, E)
        -> (B, E); ``suffix_feature(prefix_tokens(x)) == forward(x)``.
        The LayerNorm is per token, so it runs on the CLS row alone."""
        x = self.encoder.layers[-1](tokens)
        return self.encoder.ln(x[:, 0])

    def pool(self, spatial):
        """Global average pool of a (B, E, gh, gw) grid in f32, cast to
        the compute dtype (the JAX package's generic ``head_from_spatial``
        for this family)."""
        return global_pool(spatial, self.compute_dtype)
