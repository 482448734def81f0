"""Train and eval steps (the JAX package's ``train/step.py``).

A train step takes a uint8 batch on the device: augmentation and
normalization (``ops/preprocess.py``), optional mixup/CutMix
(``ops/mix.py``), the forward in train mode (the frozen prefix without
autograd, its identity bottlenecks through K1 on the card under
``fused_frozen_blocks`` 'auto' or 'on'), the class-weighted loss, the
backward and the optimizer update.  Its random draws come from a device
generator (per-image augmentation, stochastic-depth and dropout masks)
and a host numpy generator (the per-step mixing scalars).  An epoch is a Python loop over
the sampler's window offsets; metrics stay on the device until it ends.

Eval steps crop and normalize through K2 on the card
(``ops/preprocess.py::eval_preprocess_batch``) and return f32 logits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from irp_tpu_torch.models.classifier import (mixed_weighted_cross_entropy,
                                             weighted_cross_entropy)
from irp_tpu_torch.ops.mix import MixDraws, mix_batch, sample_mix_draws
from irp_tpu_torch.ops.preprocess import (AugmentDraws, augment_batch_fused,
                                          eval_preprocess_batch,
                                          sample_augment_draws)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """What a train step needs besides the state and the batch."""

    intensity: str = "medium"
    out_size: int = 224
    # the model's compute dtype, which augmentation also works in
    compute_dtype: torch.dtype = torch.bfloat16
    label_smoothing: float = 0.0
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    grad_accum: int = 1
    dropout_rate: float = 0.0

    @property
    def mixing(self) -> bool:
        return self.mixup_alpha > 0 or self.cutmix_alpha > 0


def _nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    """The NHWC batch as the model's NCHW input in channels_last memory
    (a view)."""
    return x_nhwc.permute(0, 3, 1, 2)


def augment_mix(images_u8, labels, cfg: StepConfig,
                aug_draws: AugmentDraws, mix_draws: Optional[MixDraws]):
    """Augment -> normalize -> (optional) mix.  Returns (x NHWC, labels_a,
    labels_b, lam); labels_b and lam are None when mixing is off."""
    x = augment_batch_fused(images_u8, aug_draws, cfg.intensity,
                            cfg.out_size, dtype=cfg.compute_dtype,
                            work_dtype=cfg.compute_dtype)
    if not cfg.mixing:
        return x, labels, None, None
    x, y_a, y_b, lam = mix_batch(x, labels, mix_draws, cfg.mixup_alpha,
                                 cfg.cutmix_alpha)
    return x, y_a, y_b, lam


def _loss(logits, labels_a, labels_b, lam, class_weights, smoothing,
          denom=None):
    if labels_b is None:
        return weighted_cross_entropy(logits, labels_a, class_weights,
                                      smoothing, denom=denom)
    return mixed_weighted_cross_entropy(logits, labels_a, labels_b, lam,
                                        class_weights, smoothing,
                                        denom_a=denom, denom_b=denom)


def _correct(logits, labels_a, labels_b, lam):
    """Correct predictions against the dominant label of each blend."""
    ref = labels_a if labels_b is None or lam >= 0.5 else labels_b
    return (logits.argmax(dim=-1) == ref).sum()


def loss_and_grads(model, x_nhwc, labels, cfg: StepConfig,
                   class_weights=None, labels_b=None, lam=None,
                   generator: Optional[torch.Generator] = None,
                   dropout_masks=None, sd_masks=None):
    """Forward and backward of one batch in train mode: the trainable
    parameters' grads accumulate into ``.grad``.  Returns the loss and the
    count of correct predictions, as device tensors.

    ``dropout_masks`` (the head's pair) and ``sd_masks`` (block name ->
    (B,) keep mask) are given draws, else drawn from ``generator``.

    With ``cfg.grad_accum`` = k > 1 the batch runs as k sequential
    micro-batches, each loss over the full batch's denominator (the batch
    size, or the class-weight sum over the whole batch), so the summed
    grads are the full batch's; BatchNorm layers that collect statistics
    see the micro-batches' in turn.  The masks are drawn per micro-batch;
    given ones are then sequences of k, one per micro-batch.
    """
    k = int(cfg.grad_accum)
    b = x_nhwc.shape[0]
    if k <= 1:
        logits = model(_nchw(x_nhwc), cfg.dropout_rate, dropout_masks,
                       generator, sd_masks)
        loss = _loss(logits, labels, labels_b, lam, class_weights,
                     cfg.label_smoothing)
        with model.precision_scope(x_nhwc):
            loss.backward()
        return loss.detach(), _correct(logits.detach(), labels, labels_b,
                                       lam)
    if b % k:
        raise ValueError(f"grad_accum_steps={k} needs the batch ({b}) "
                         f"divisible by it")
    for given in (dropout_masks, sd_masks):
        if given is not None and len(given) != k:
            raise ValueError(f"grad_accum_steps={k} takes one set of masks "
                             f"per micro-batch, got {len(given)}")
    if class_weights is None:
        denom = float(b)
    else:
        denom = class_weights.float()[labels.long()].sum().clamp_min(1e-8)
    blk = b // k
    loss_sum = torch.zeros((), dtype=torch.float32, device=x_nhwc.device)
    correct = torch.zeros((), dtype=torch.int64, device=x_nhwc.device)
    for c in range(k):
        sl = slice(c * blk, (c + 1) * blk)
        lb = None if labels_b is None else labels_b[sl]
        logits = model(_nchw(x_nhwc[sl]), cfg.dropout_rate,
                       None if dropout_masks is None else dropout_masks[c],
                       generator, None if sd_masks is None else sd_masks[c])
        loss = _loss(logits, labels[sl], lb, lam, class_weights,
                     cfg.label_smoothing, denom)
        with model.precision_scope(x_nhwc):
            loss.backward()
        loss_sum += loss.detach()
        correct += _correct(logits.detach(), labels[sl], lb, lam)
    return loss_sum, correct


def train_step(state, images_u8, labels, cfg: StepConfig,
               class_weights=None,
               generator: Optional[torch.Generator] = None,
               mix_rng: Optional[np.random.Generator] = None,
               aug_draws: Optional[AugmentDraws] = None,
               mix_draws: Optional[MixDraws] = None, dropout_masks=None,
               sd_masks=None):
    """One optimizer step on a uint8 batch (B, H, W, 3) on the device.

    Draws (augmentation, mixing, the head's dropout masks and the
    backbone's stochastic-depth masks) come from ``generator`` (a
    generator on the batch's device) and ``mix_rng`` unless given.
    Returns {'loss', 'accuracy'} as device scalars."""
    b, h, w = images_u8.shape[:3]
    if aug_draws is None:
        aug_draws = sample_augment_draws(generator, b, h, w, cfg.intensity)
    if cfg.mixing and mix_draws is None:
        mix_draws = sample_mix_draws(mix_rng, cfg.mixup_alpha,
                                     cfg.cutmix_alpha, cfg.out_size,
                                     cfg.out_size)
    x, y_a, y_b, lam = augment_mix(images_u8, labels, cfg, aug_draws,
                                   mix_draws)
    state.optimizer.zero_grad()
    loss, correct = loss_and_grads(state.model, x, y_a, cfg, class_weights,
                                   y_b, lam, generator, dropout_masks,
                                   sd_masks)
    state.apply_gradients()
    return {"loss": loss, "accuracy": correct.float() / b}


def epoch_step(state, hbm, offsets, batch_size: int, cfg: StepConfig,
               class_weights=None,
               generator: Optional[torch.Generator] = None,
               mix_rng: Optional[np.random.Generator] = None):
    """A train epoch over the resident set's windows of ``batch_size`` at
    ``offsets`` (the sampler's): returns {'loss', 'accuracy'} as (steps,)
    device tensors."""
    losses, accs = [], []
    for off in offsets:
        images, labels = hbm.window(int(off), batch_size)
        m = train_step(state, images, labels, cfg, class_weights,
                       generator, mix_rng)
        losses.append(m["loss"])
        accs.append(m["accuracy"])
    return {"loss": torch.stack(losses), "accuracy": torch.stack(accs)}


@torch.no_grad()
def eval_step(model, images_u8, out_size: int = 224,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Center crop + normalize (K2 on the card) + forward in eval form:
    f32 logits on the device."""
    x = eval_preprocess_batch(images_u8, out_size, compute_dtype)
    return model(_nchw(x))


@torch.no_grad()
def eval_epoch(model, hbm_eval, out_size: int = 224,
               compute_dtype=torch.bfloat16) -> np.ndarray:
    """Eval over a resident eval set: (steps, B, C) f32 logits on the
    host, one copy at the end."""
    bl = hbm_eval.batch_size
    logits = [eval_step(model, hbm_eval.images[off:off + bl], out_size,
                        compute_dtype) for off in hbm_eval.offsets]
    return torch.stack(logits).cpu().numpy()
