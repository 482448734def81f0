"""Grad-CAM over a :class:`~irp_tpu_torch.infer.Predictor` (the JAX
package's ``explain.py``).

Class-discriminative maps (Grad-CAM, Selvaraju et al. 2017): which regions
of an image drove a prediction.  For each image the backbone runs to the
pre-pool map A (B, C, h, w) (the Predictor's own eval preprocess, K2 on the
card, and its backbone, K1 in the frozen identity blocks); the head gives
the logits; the channel weights are a_k = GAP(d logit_c / dA_k); the map is
ReLU(sum_k a_k A_k), min-max normalized per image and upsampled
(bilinear) to the eval crop.

The derivative is the head's, in closed form, not autograd's: the eval
head is Linear -> ReLU -> Linear on the global average pool (dropout is
the identity), so with z = dense1(pool(A)),

    d logit_c / d pool(A) = W1^T ((z > 0) * W2[c])

and d logit_c / dA is that divided by h*w at every position, in float32.
It equals the JAX package's VJP of the head (``tests/test_torch_explain.py``
holds it against ``torch.autograd`` and against JAX), runs under
``torch.inference_mode()`` with no graph kept, and ``torch.export`` takes
it as plain ops, so an ``.irpx`` can bake the explain program
(``export.py``).  ReLU's derivative at 0 is 0, as in both frameworks.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from irp_tpu_torch.infer import input_dtype
from irp_tpu_torch.ops.preprocess import eval_preprocess_batch


def head_logits_and_grad(model, acts: torch.Tensor, class_idx: torch.Tensor):
    """Eval-form logits of the map ``acts`` (B, C, h, w) float32 and the
    derivative of each row's selected logit by the pooled map, (B, C)
    float32.  ``class_idx`` (B,) int: -1 selects the argmax class."""
    dense1, dense2 = model.classifier[1], model.classifier[4]
    logits = model.head_from_spatial(acts)
    z = dense1(model.backbone.pool(acts))
    target = torch.where(class_idx < 0, logits.argmax(dim=-1),
                         class_idx.to(torch.int64))
    gate = (z > 0).to(torch.float32) * dense2.weight.float()[target]
    return logits, gate @ dense1.weight.float()


def cam_forward(model, images_u8: torch.Tensor, class_idx: torch.Tensor):
    """(B, H, W, 3) uint8 and (B,) class indices on the model's device ->
    (cams (B, crop, crop) float32 in [0, 1], logits (B, K) float32)."""
    cfg = model.config
    x = eval_preprocess_batch(images_u8, cfg.image_size, input_dtype(cfg),
                              IMAGENET_MEAN, IMAGENET_STD)
    acts = model.spatial_features(x.permute(0, 3, 1, 2)).float()
    logits, d_pooled = head_logits_and_grad(model, acts, class_idx)
    h, w = acts.shape[2:]
    alpha = d_pooled / (h * w)  # GAP of d logit / dA: the same everywhere
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
