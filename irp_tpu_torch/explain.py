"""Grad-CAM over a :class:`~irp_tpu_torch.infer.Predictor` (the JAX
package's ``explain.py``), for the four model families.

Class-discriminative maps (Grad-CAM, Selvaraju et al. 2017): which regions
of an image drove a prediction.  For each image the backbone runs to a map
A (the Predictor's own eval preprocess, K2 on the card, and its backbone,
K1 in a ResNet's frozen identity blocks); the head gives the logits; the
channel weights are a_k = GAP(d logit_c / dA_k); the map is
ReLU(sum_k a_k A_k), min-max normalized per image and upsampled (bilinear)
to the eval crop.

The derivative is written out in closed form, in float32, not taken by
autograd: it runs under ``torch.inference_mode()`` with no graph kept,
and ``torch.export`` takes it as plain ops, so an ``.irpx`` can bake the
explain program (``export.py``).  ReLU's derivative at 0 is 0, as in both
frameworks.

- ResNet, EfficientNet: A is the pre-pool map (B, C, h, w); the eval head
  is Linear -> ReLU -> Linear on the global average pool, so with
  z = dense1(pool(A)), d logit_c / d pool(A) = W1^T ((z > 0) * W2[c]),
  and d logit_c / dA is that over h*w at every position.
- ConvNeXt: the final LayerNorm sits between the pool and the head, so
  that vector goes back through the LayerNorm
  (:func:`layer_norm_vjp`) first.
- ViT: only the CLS token reaches the head, so A is the token sequence
  entering the LAST encoder block; the derivative runs back through the
  head, the final LayerNorm, the last block's MLP and its attention
  (:func:`vit_logits_and_token_grad`): the CLS row's query, and the keys
  and values of every token.  The CLS token is dropped and the patch
  tokens, reshaped to the grid, are the map.

``tests/test_torch_explain.py`` and ``tests/test_torch_{vit,efficientnet,
convnext}.py`` hold the derivatives against ``torch.autograd`` and the
maps against the JAX package's VJP.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from irp_tpu_torch.infer import input_dtype
from irp_tpu_torch.models.layers import global_pool
from irp_tpu_torch.ops.preprocess import eval_preprocess_batch


def layer_norm_vjp(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   g: torch.Tensor) -> torch.Tensor:
    """d/dx of sum(g * LayerNorm(x)) over the last axis, in float32."""
    x = x.float()
    xc = x - x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    gx = g * weight.float()
    return rstd * (gx - gx.mean(dim=-1, keepdim=True)
                   - xhat * (gx * xhat).mean(dim=-1, keepdim=True))


def _target(logits: torch.Tensor, class_idx: torch.Tensor) -> torch.Tensor:
    return torch.where(class_idx < 0, logits.argmax(dim=-1),
                       class_idx.to(torch.int64))


def _head_grad(model, feats: torch.Tensor, target: torch.Tensor):
    """d logit_target / d feats (B, C) float32 of the eval head on the
    features ``feats`` it reads."""
    dense1, dense2 = model.classifier[1], model.classifier[4]
    z = dense1(feats)
    gate = (z > 0).to(torch.float32) * dense2.weight.float()[target]
    return gate @ dense1.weight.float()


def head_logits_and_grad(model, acts: torch.Tensor, class_idx: torch.Tensor):
    """Eval-form logits of the map ``acts`` (B, C, h, w) float32 and the
    derivative of each row's selected logit by the pooled map, (B, C)
    float32.  ``class_idx`` (B,) int: -1 selects the argmax class.  A
    ConvNeXt's pool is followed by its final LayerNorm, which the
    derivative goes back through."""
    backbone = model.backbone
    logits = model.head_from_spatial(acts)
    target = _target(logits, class_idx)
    d_feats = _head_grad(model, backbone.pool(acts), target)
    if model.config.family == "convnext":
        pooled = global_pool(acts, backbone.compute_dtype)
        d_feats = layer_norm_vjp(pooled, backbone.ln.weight, backbone.ln.eps,
                                 d_feats)
    return logits, d_feats


def _ln(x: torch.Tensor, ln) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


def _gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d gelu(u) / du of the exact (erf) GELU."""
    return (0.5 * (1.0 + torch.erf(u * 0.5 ** 0.5))
            + u * torch.exp(-0.5 * u * u) * (2.0 * torch.pi) ** -0.5)


def vit_logits_and_token_grad(model, tokens: torch.Tensor,
                              class_idx: torch.Tensor):
    """ViT: the eval-form logits of the tokens (B, S, E) entering the last
    block, and d logit_target / d tokens (B, S, E) float32.

    The logits are the model's own (``vit_logits_from_tokens``).  The
    derivative recomputes the suffix in float32 (last block, final
    LayerNorm of the CLS row, head) and runs it backward by hand: head ->
    final LayerNorm -> MLP residual -> attention residual of the CLS row
    -> softmax over the CLS row's scores -> the CLS query, and the keys
    and values of every token -> the packed projection -> ln_1.
    """
    logits = model.vit_logits_from_tokens(tokens)
    target = _target(logits, class_idx)
    blk = model.backbone.encoder.layers[-1]
    attn = blk.self_attention
    fc1, fc2 = blk.mlp[0], blk.mlp[3]
    x = tokens.float()
    b, s, e = x.shape
    h = attn.num_heads
    d = e // h
    scale = d ** -0.5
    # forward of what reaches the CLS feature, float32
    w_in = attn.in_proj_weight.float()
    y1 = _ln(x, blk.ln_1)
    qkv = (y1 @ w_in.T + attn.in_proj_bias.float()).view(b, s, 3, h, d)
    q0 = qkv[:, 0, 0]  # the CLS query, (B, H, D)
    k = qkv[:, :, 1].transpose(1, 2)  # (B, H, S, D)
    v = qkv[:, :, 2].transpose(1, 2)
    a = torch.softmax((k @ q0[..., None])[..., 0] * scale, dim=-1)
    o = (a[:, :, None, :] @ v)[:, :, 0].reshape(b, e)
    wo = attn.out_proj.weight.float()
    x0 = x[:, 0] + o @ wo.T + attn.out_proj.bias.float()
    u = _ln(x0, blk.ln_2) @ fc1.weight.float().T + fc1.bias.float()
    x1 = x0 + F.gelu(u) @ fc2.weight.float().T + fc2.bias.float()
    ln_f = model.backbone.encoder.ln
    # backward
    g_feats = _head_grad(model, _ln(x1, ln_f), target)
    g_x1 = layer_norm_vjp(x1, ln_f.weight, ln_f.eps, g_feats)
    g_u = (g_x1 @ fc2.weight.float()) * _gelu_grad(u)
    g_x0 = g_x1 + layer_norm_vjp(x0, blk.ln_2.weight, blk.ln_2.eps,
                                 g_u @ fc1.weight.float())
    g_o = (g_x0 @ wo).view(b, h, 1, d)
    g_a = (v @ g_o.transpose(-1, -2))[..., 0]  # (B, H, S)
    g_s = a * (g_a - (a * g_a).sum(dim=-1, keepdim=True)) * scale
    g_q0 = (g_s[:, :, None, :] @ k)  # (B, H, 1, D)
    g_k = g_s[..., None] * q0[:, :, None, :]
    g_v = a[..., None] * g_o
    g_q = torch.cat([g_q0, g_q0.new_zeros((b, h, s - 1, d))], dim=2)
    g_qkv = torch.stack([g_q, g_k, g_v], dim=2)  # (B, H, 3, S, D)
    g_y1 = g_qkv.permute(0, 3, 2, 1, 4).reshape(b, s, 3 * e) @ w_in
    g_x = layer_norm_vjp(x, blk.ln_1.weight, blk.ln_1.eps, g_y1)
    g_x = g_x + F.pad(g_x0[:, None], (0, 0, 0, s - 1))
    return logits, g_x


def cam_forward(model, images_u8: torch.Tensor, class_idx: torch.Tensor):
    """(B, H, W, 3) uint8 and (B,) class indices on the model's device ->
    (cams (B, crop, crop) float32 in [0, 1], logits (B, K) float32)."""
    cfg = model.config
    x = eval_preprocess_batch(images_u8, cfg.image_size, input_dtype(cfg),
                              IMAGENET_MEAN, IMAGENET_STD).permute(0, 3, 1, 2)
    if cfg.family == "vit":
        tokens = model.vit_tokens(x).float()
        logits, d_tokens = vit_logits_and_token_grad(model, tokens,
                                                     class_idx)
        b, s, e = tokens.shape
        g = cfg.image_size // cfg.patch_size
        # drop CLS; the patch tokens are the (g x g) map
        acts = tokens[:, 1:].reshape(b, g, g, e).permute(0, 3, 1, 2)
        alpha = d_tokens[:, 1:].mean(dim=1)  # GAP of d logit / dA
    else:
        acts = model.spatial_features(x).float()
        logits, d_pooled = head_logits_and_grad(model, acts, class_idx)
        h, w = acts.shape[2:]
        alpha = d_pooled / (h * w)  # GAP of d logit / dA: uniform here
    cam = torch.relu((alpha[:, :, None, None] * acts).sum(dim=1))
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    cam = (cam - lo) / (hi - lo).clamp_min(1e-12)
    cam = F.interpolate(cam[:, None], size=(cfg.image_size, cfg.image_size),
                        mode="bilinear", align_corners=False,
                        antialias=False)[:, 0]
    # bilinear weights between [0, 1] samples stay in [0, 1]; the clamp
    # guards rounding only
    return cam.clamp(0.0, 1.0), logits


class GradCAM:
    """Grad-CAM for the images a Predictor scores, in padded batches of
    ``batch_size`` (the predictor's by default; the daemon explains single
    images at a small batch, as padding each to the bulk batch would
    spend that many images' device work).

    A predictor loaded from an ``.irpx`` (``export.py``) explains through
    its baked explain program, whose batch and source size were fixed at
    export: ``batch_size`` must then be omitted or equal it.
    """

    def __init__(self, predictor, batch_size: Optional[int] = None):
        self.predictor = predictor
        if predictor.exported:
            if predictor._cam_call is None:
                raise ValueError(
                    "Grad-CAM needs the model's live forward, and this "
                    "exported .irpx carries no explain program: re-export "
                    "with gradcam=True (the default), or serve Grad-CAM "
                    "from the .npz/.pth weights artifact")
            baked = int(predictor._cam_batch_size)
            if batch_size is not None and int(batch_size) != baked:
                raise ValueError(
                    f"this artifact's Grad-CAM program fixes "
                    f"batch_size={baked} (exported via gradcam_batch_size); "
                    f"got {batch_size}")
            self.batch_size = baked
            self._call = predictor._cam_call
            return
        self.batch_size = (predictor.batch_size if batch_size is None
                           else int(batch_size))
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got "
                             f"{self.batch_size}")
        self._call = functools.partial(cam_forward, predictor.model)

    def explain(self, images_u8: np.ndarray,
                class_idx: Optional[np.ndarray] = None):
        """(N, H, W, 3) uint8 -> (cams (N, crop, crop) float32 in [0, 1],
        logits (N, K) float32).

        ``class_idx``: per-image class to explain, or one for all; None or
        -1 explains the argmax class.  H and W must be at least the eval
        crop (exactly the exported source size for an ``.irpx``).
        """
        p = self.predictor
        images_u8 = np.asarray(images_u8, np.uint8)
        if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
            raise ValueError(f"expected (N,H,W,3) uint8, got "
                             f"{images_u8.shape}")
        crop = p.model.config.image_size
        h, w = images_u8.shape[1:3]
        if h < crop or w < crop:
            raise ValueError(f"images are {h}x{w} but the model's eval crop "
                             f"is {crop}x{crop}")
        if (p.source_size is not None
                and (h, w) != (p.source_size, p.source_size)):
            raise ValueError(
                f"this exported program requires sources of exactly "
                f"{p.source_size}x{p.source_size}, got {h}x{w}")
        n = images_u8.shape[0]
        num_classes = p.num_classes
        if class_idx is None:
            class_idx = np.full((n,), -1, np.int32)
        else:
            class_idx = np.asarray(class_idx, np.int32)
            if class_idx.shape == ():
                class_idx = np.full((n,), int(class_idx), np.int32)
            if class_idx.shape != (n,):
                raise ValueError(f"class_idx shape {class_idx.shape} != "
                                 f"({n},)")
            if (class_idx >= num_classes).any() or (class_idx < -1).any():
                raise ValueError("class_idx entries must be -1 (argmax) or "
                                 f"in [0, {num_classes})")
        if n == 0:
            return (np.zeros((0, crop, crop), np.float32),
                    np.zeros((0, num_classes), np.float32))
        bsz = self.batch_size
        cams, logits = [], []
        for start in range(0, n, bsz):
            chunk = images_u8[start:start + bsz]
            cls = class_idx[start:start + bsz]
            if chunk.shape[0] < bsz:  # pad the tail to the batch shape
                k = bsz - chunk.shape[0]
                chunk = np.concatenate(
                    [chunk, np.broadcast_to(chunk[-1:],
                                            (k,) + chunk.shape[1:])], 0)
                cls = np.concatenate([cls, np.full((k,), -1, np.int32)])
            with torch.inference_mode():
                c, lg = self._call(
                    torch.from_numpy(np.ascontiguousarray(chunk)).to(
                        p.device),
                    torch.from_numpy(cls.astype(np.int64)).to(p.device))
                cams.append(c.cpu().numpy())
                logits.append(lg.cpu().numpy())
        return (np.concatenate(cams, 0)[:n], np.concatenate(logits, 0)[:n])


def center_crop_u8(image_u8: np.ndarray, size: int) -> np.ndarray:
    """The model's eval center crop on uint8 pixels, so that an overlay
    lies on the pixels its map was computed from."""
    h, w = image_u8.shape[-3], image_u8.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return image_u8[..., top:top + size, left:left + size, :]


def overlay_cam(image_u8: np.ndarray, cam: np.ndarray,
                alpha: float = 0.45) -> np.ndarray:
    """Blend a [0, 1] map onto an RGB uint8 image (a jet-like ramp); the
    map is resized (bilinear, PIL) to the image's H x W if needed.
    Returns (H, W, 3) uint8."""
    from PIL import Image

    image_u8 = np.asarray(image_u8, np.uint8)
    h, w = image_u8.shape[:2]
    cam = np.asarray(cam, np.float32)
    if cam.shape != (h, w):
        cam = np.asarray(Image.fromarray(cam).resize((w, h), Image.BILINEAR),
                         np.float32)
    cam = np.clip(cam, 0.0, 1.0)
    # blue -> cyan -> yellow -> red
    r = np.clip(1.5 - np.abs(4 * cam - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * cam - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * cam - 1), 0, 1)
    heat = (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)
    out = ((1 - alpha) * image_u8.astype(np.float32)
           + alpha * heat.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)
