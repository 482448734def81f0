"""Vision transformers, torchvision's ``vit_b_*`` layout and names:
pre-LayerNorm blocks (eps 1e-6), exact-erf GELU, softmax over the scaled
scores, the CLS token's feature after the final LayerNorm."""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

from benchmark.reference.models import conv, frozen, linear
from benchmark.reference.precision import operand

LN_EPS = 1e-6


def specs(cfg) -> "OrderedDict":
    e, p, m = cfg["embed_dim"], cfg["patch_size"], cfg["mlp_dim"]
    seq = (cfg["image_size"] // p) ** 2 + 1
    s = OrderedDict()
    s["backbone.class_token"] = ((1, 1, e), "embed")
    s["backbone.conv_proj.weight"] = ((e, 3, p, p), "kernel")
    s["backbone.conv_proj.bias"] = ((e,), "bias")
    s["backbone.encoder.pos_embedding"] = ((1, seq, e), "embed")

    def ln(name):
        s[f"{name}.weight"] = ((e,), "scale")
        s[f"{name}.bias"] = ((e,), "bias")

    for i in range(cfg["num_layers"]):
        pre = f"backbone.encoder.layers.encoder_layer_{i}"
        ln(f"{pre}.ln_1")
        s[f"{pre}.self_attention.in_proj_weight"] = ((3 * e, e), "kernel")
        s[f"{pre}.self_attention.in_proj_bias"] = ((3 * e,), "bias")
        s[f"{pre}.self_attention.out_proj.weight"] = ((e, e), "kernel")
        s[f"{pre}.self_attention.out_proj.bias"] = ((e,), "bias")
        ln(f"{pre}.ln_2")
        s[f"{pre}.mlp.0.weight"] = ((m, e), "kernel")
        s[f"{pre}.mlp.0.bias"] = ((m,), "bias")
        s[f"{pre}.mlp.3.weight"] = ((e, m), "kernel")
        s[f"{pre}.mlp.3.bias"] = ((e,), "bias")
    ln("backbone.encoder.ln")
    return s


def num_features(cfg) -> int:
    return cfg["embed_dim"]


def stage_of(parts, cfg) -> str:
    """'embed', 'block<i>' or 'ln'."""
    if parts[0] in ("class_token", "conv_proj") or parts[1] == "pos_embedding":
        return "embed"
    if parts[1] == "layers":
        return "block" + parts[2][len("encoder_layer_"):]
    return "ln"


def _frozen_blocks(cfg) -> int:
    """Blocks before the first trainable one."""
    for i in range(cfg["num_layers"]):
        if f"block{i}" in cfg["trainable_stages"]:
            return i
    return cfg["num_layers"]


def _layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def _block(p, pre, x, heads, prec):
    b, s, e = x.shape
    d = e // heads
    y = _layer_norm(x, p, f"{pre}.ln_1")
    qkv = linear(y, p[f"{pre}.self_attention.in_proj_weight"],
                 p[f"{pre}.self_attention.in_proj_bias"], prec)
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    scores = operand(q, prec) @ operand(k, prec).transpose(-1, -2)
    attn = torch.softmax(scores * d ** -0.5, dim=-1)
    o = (operand(attn, prec) @ operand(v, prec)).transpose(1, 2)
    x = x + linear(o.reshape(b, s, e),
                   p[f"{pre}.self_attention.out_proj.weight"],
                   p[f"{pre}.self_attention.out_proj.bias"], prec)
    y = _layer_norm(x, p, f"{pre}.ln_2")
    y = F.gelu(linear(y, p[f"{pre}.mlp.0.weight"], p[f"{pre}.mlp.0.bias"],
                      prec))
    return x + linear(y, p[f"{pre}.mlp.3.weight"], p[f"{pre}.mlp.3.bias"],
                      prec)


def features(p, cfg, x, prec, train, stats_out):
    n_frozen = _frozen_blocks(cfg)
    heads = cfg["num_heads"] or cfg["embed_dim"] // 64
    with frozen(train and n_frozen > 0):
        x = conv(x, p["backbone.conv_proj.weight"], prec,
                 stride=cfg["patch_size"]) \
            + p["backbone.conv_proj.bias"][:, None, None]
        x = x.flatten(2).transpose(1, 2)
        cls = p["backbone.class_token"].expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + p["backbone.encoder.pos_embedding"]
    for i in range(cfg["num_layers"]):
        with frozen(train and i < n_frozen):
            x = _block(p, f"backbone.encoder.layers.encoder_layer_{i}", x,
                       heads, prec)
    return _layer_norm(x[:, 0], p, "backbone.encoder.ln")


def products(cfg):
    p, e, m = cfg["patch_size"], cfg["embed_dim"], cfg["mlp_dim"]
    n = (cfg["image_size"] // p) ** 2
    s = n + 1
    out = [("embed", 2 * n * e * 3 * p * p, True)]
    for i in range(cfg["num_layers"]):
        blk = (2 * s * e * 3 * e + 2 * 2 * s * s * e + 2 * s * e * e
               + 2 * 2 * s * e * m)
        out.append((f"block{i}", blk, True))
    return out, e
