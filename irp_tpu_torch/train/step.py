"""Train and eval steps (the JAX package's ``train/step.py``).

A train step takes a uint8 batch on the device: augmentation and
normalization (``ops/preprocess.py``), optional mixup/CutMix
(``ops/mix.py``), the forward in train mode (the frozen prefix without
autograd, its identity bottlenecks through K1 on the card under
``fused_frozen_blocks`` 'auto' or 'on'), the class-weighted loss, the
backward and the optimizer update, each a span (``utils/monitor.py``:
``train.step`` holding ``train.augment``, ``train.forward`` and
``train.backward`` per micro-batch, and ``train.optimizer``; the models
add ``train.forward.frozen``).  Its random draws come from a device
generator (per-image augmentation, stochastic-depth and dropout masks)
and a host numpy generator (the per-step mixing scalars).  An epoch is a Python loop over
the sampler's window offsets; metrics stay on the device until it ends.

Eval steps crop and normalize through K2 on the card
(``ops/preprocess.py::eval_preprocess_batch``) and return f32 logits.

Over a process mesh (``parallel/mesh.py``; ``mesh=``) each rank's step
takes its rows of the global batch B and computes the JAX package's step
on the sharded global batch: every draw is the global batch's, drawn
alike on every rank from generators seeded alike, and each rank takes
its rows, so the sample stream does not depend on D; BatchNorm's moments
are the global batch's (``models/resnet.py::sync_batch_stats``, which
the caller sets); the loss is the global weighted mean, its denominator
summed over the ranks before the backward; the gradients are then
summed over the ranks with one flat all-reduce (SUM, not the mean
``DistributedDataParallel`` takes: each rank's loss is already its
share of the global mean); the loss and the correct count are summed
over the ranks.

With a model axis (``MeshConfig(data=D, model=M)``) "the ranks" above are
the data group's (``mesh.group``, ``mesh.size`` = D, ``mesh.index`` this
rank's data index): the M ranks of a model group hold the same rows and
draws, run the Megatron layers' collectives over the model group inside
the forward and backward (``parallel/tensor.py``), and end a step with the
same replicated gradients; the head's second dropout mask is drawn for
the whole hidden width and sliced to the rank's columns
(``Classifier.head``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from irp_tpu_torch.models.classifier import (mixed_weighted_cross_entropy,
                                             weighted_cross_entropy)
from irp_tpu_torch.models.layers import sample_sd_masks
from irp_tpu_torch.ops.mix import MixDraws, mix_batch, sample_mix_draws
from irp_tpu_torch.parallel.distributed import (all_reduce_grads,
                                                all_reduce_sum)
from irp_tpu_torch.parallel.mesh import gather_rows
from irp_tpu_torch.ops.preprocess import (AugmentDraws, augment_batch_fused,
                                          eval_preprocess_batch,
                                          sample_augment_draws)
from irp_tpu_torch.utils import monitor


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


def _rank_rows(mesh, b: int) -> slice:
    """This rank's rows of a global batch of ``b`` local rows a rank."""
    return slice(mesh.index * b, (mesh.index + 1) * b)


def _global_masks(model, rate: float, generator, b: int, mesh, device,
                  drop=None, sd=None):
    """(dropout masks, stochastic-depth masks): the given ones, and the
    others drawn for the global batch (D x ``b`` rows) as the model draws
    them (the blocks' first, then the head's two), this rank's rows of
    each."""
    rows = _rank_rows(mesh, b)
    big = b * mesh.size
    if sd is None and model.config.family != "resnet":
        sd = {k: v[rows] for k, v in sample_sd_masks(
            model.sd_probs(), big, generator, device).items()}
    keep = 1.0 - float(rate)
    if drop is None and keep < 1.0:
        widths = (model.backbone.num_features, model.config.hidden_dim)
        drop = tuple((torch.rand((big, w), generator=generator,
                                 device=device) < keep)[rows]
                     for w in widths)
    return drop, sd


def _denominator(labels, class_weights, mesh):
    """The loss's denominator over the global batch: its size, or the
    class-weight sum (summed over the ranks in f32)."""
    d = 1 if mesh is None else mesh.size
    if class_weights is None:
        return float(labels.shape[0] * d)
    denom = class_weights.float()[labels.long()].sum()
    if mesh is not None:
        denom = all_reduce_sum(denom, mesh.group)
    return denom.clamp_min(1e-8)


def loss_and_grads(model, x_nhwc, labels, cfg: StepConfig,
                   class_weights=None, labels_b=None, lam=None,
                   generator: Optional[torch.Generator] = None,
                   dropout_masks=None, sd_masks=None, mesh=None):
    """Forward and backward of one batch in train mode: the trainable
    parameters' grads accumulate into ``.grad``.  Returns the loss and the
    count of correct predictions, as device tensors.

    ``dropout_masks`` (the head's pair) and ``sd_masks`` (block name ->
    (B,) keep mask) are given draws, else drawn from ``generator``.

    With ``cfg.grad_accum`` = k > 1 the batch runs as k sequential
    micro-batches, each loss over the full batch's denominator (the batch
    size, or the class-weight sum over the whole batch), so the summed
    grads are the full batch's; BatchNorm layers that collect statistics
    see the micro-batches' in turn.  Micro-batch c is the batch's c-th
    slice of B/k rows; over a process mesh the batch is this rank's
    shard, so the chunks are shard-local.  The masks are drawn per
    micro-batch; given ones are then sequences of k, one per micro-batch.

    ``mesh`` (a process mesh): ``x_nhwc`` holds this rank's rows; the
    loss is this rank's share of the global weighted mean (its
    denominator summed over the ranks); masks not given are drawn for the
    global (micro-)batch and this rank's rows taken; given masks are the
    global (micro-)batch's.  Returns the local loss and count: the caller
    sums them and the gradients over the ranks.
    """
    k = int(cfg.grad_accum)
    b = x_nhwc.shape[0]
    if mesh is not None:
        rows = _rank_rows(mesh, b if k <= 1 else b // k)
        if dropout_masks is not None:
            dropout_masks = ([tuple(m[rows] for m in ms)
                              for ms in dropout_masks] if k > 1
                             else tuple(m[rows] for m in dropout_masks))
        if sd_masks is not None:
            sd_masks = ([{n: m[rows] for n, m in ms.items()}
                         for ms in sd_masks] if k > 1
                        else {n: m[rows] for n, m in sd_masks.items()})
    if k <= 1:
        if mesh is not None:
            dropout_masks, sd_masks = _global_masks(
                model, cfg.dropout_rate, generator, b, mesh, x_nhwc.device,
                dropout_masks, sd_masks)
        with monitor.span("train.forward"):
            logits = model(_nchw(x_nhwc), cfg.dropout_rate, dropout_masks,
                           generator, sd_masks)
            denom = None if mesh is None else _denominator(
                labels, class_weights, mesh)
            loss = _loss(logits, labels, labels_b, lam, class_weights,
                         cfg.label_smoothing, denom)
        with monitor.span("train.backward"), model.precision_scope(x_nhwc):
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
    denom = _denominator(labels, class_weights, mesh)
    blk = b // k
    loss_sum = torch.zeros((), dtype=torch.float32, device=x_nhwc.device)
    correct = torch.zeros((), dtype=torch.int64, device=x_nhwc.device)
    for c in range(k):
        sl = slice(c * blk, (c + 1) * blk)
        lb = None if labels_b is None else labels_b[sl]
        drop = None if dropout_masks is None else dropout_masks[c]
        sd = None if sd_masks is None else sd_masks[c]
        if mesh is not None:
            drop, sd = _global_masks(model, cfg.dropout_rate, generator,
                                     blk, mesh, x_nhwc.device, drop, sd)
        with monitor.span("train.forward"):
            logits = model(_nchw(x_nhwc[sl]), cfg.dropout_rate, drop,
                           generator, sd)
            loss = _loss(logits, labels[sl], lb, lam, class_weights,
                         cfg.label_smoothing, denom)
        with monitor.span("train.backward"), model.precision_scope(x_nhwc):
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
               sd_masks=None, mesh=None):
    """One optimizer step on a uint8 batch (B, H, W, 3) on the device.

    Draws (augmentation, mixing, the head's dropout masks and the
    backbone's stochastic-depth masks) come from ``generator`` (a
    generator on the batch's device) and ``mix_rng`` unless given.
    Returns {'loss', 'accuracy'} as device scalars.

    ``mesh`` (a process mesh): the batch is this rank's B/D rows, given
    draws are the global batch's, and the step is the global batch's (the
    module docstring); every rank returns the global loss and accuracy.
    """
    b, h, w = images_u8.shape[:3]
    d = 1 if mesh is None else mesh.size
    with monitor.span("train.step"):
        with monitor.span("train.augment"):
            if aug_draws is None:
                aug_draws = sample_augment_draws(generator, b * d, h, w,
                                                 cfg.intensity)
            if mesh is not None:
                aug_draws = aug_draws.rows(_rank_rows(mesh, b))
            if cfg.mixing and mix_draws is None:
                mix_draws = sample_mix_draws(mix_rng, cfg.mixup_alpha,
                                             cfg.cutmix_alpha, cfg.out_size,
                                             cfg.out_size)
            x, y_a, y_b, lam = augment_mix(images_u8, labels, cfg,
                                           aug_draws, mix_draws)
        state.optimizer.zero_grad()
        loss, correct = loss_and_grads(state.model, x, y_a, cfg,
                                       class_weights, y_b, lam, generator,
                                       dropout_masks, sd_masks, mesh)
        if mesh is not None:
            all_reduce_grads(state.optimizer.params.values(), mesh.group)
            both = all_reduce_sum(torch.stack([loss,
                                               correct.to(loss.dtype)]),
                                  mesh.group)
            loss, correct = both[0], both[1]
        with monitor.span("train.optimizer"):
            state.apply_gradients()
        return {"loss": loss, "accuracy": correct.float() / (b * d)}


def epoch_step(state, hbm, offsets, batch_size: int, cfg: StepConfig,
               class_weights=None,
               generator: Optional[torch.Generator] = None,
               mix_rng: Optional[np.random.Generator] = None, mesh=None):
    """A train epoch over the resident set's windows of ``batch_size``
    (this rank's rows of each global batch) at ``offsets`` (the
    sampler's): returns {'loss', 'accuracy'} as (steps,) device
    tensors."""
    losses, accs = [], []
    for off in offsets:
        images, labels = hbm.window(int(off), batch_size)
        m = train_step(state, images, labels, cfg, class_weights,
                       generator, mix_rng, mesh=mesh)
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
               compute_dtype=torch.bfloat16, mesh=None) -> np.ndarray:
    """Eval over a resident eval set: (steps, B, C) f32 logits on the
    host, one copy at the end; over a process mesh each step's B is the
    ranks' windows in rank order, gathered on every rank."""
    bl = hbm_eval.per_device
    logits = torch.stack([eval_step(model, hbm_eval.images[off:off + bl],
                                    out_size, compute_dtype)
                          for off in hbm_eval.offsets])
    if mesh is not None and mesh.is_process:
        steps, d = logits.shape[0], mesh.size
        pos = (np.arange(steps)[:, None] * d * bl + mesh.index * bl
               + np.arange(bl)[None, :]).reshape(-1)
        logits = gather_rows(mesh, logits.reshape(steps * bl, -1),
                             steps * d * bl, pos).reshape(steps, d * bl, -1)
    return logits.cpu().numpy()
