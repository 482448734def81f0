"""Backbone + MLP-head classifier (the JAX package's
``models/classifier.py``).

The head is ``Sequential(Dropout, Linear, ReLU, Dropout, Linear)``, so its
keys are ``classifier.1`` / ``classifier.4`` as in the reference stack's
AnimalClassifier; the backbone sits under ``backbone.``.  Only the ResNet
family is ported so far.

Training: the head's dropout takes its rate at run time and its mask from
the caller or from a generator the caller gives (:class:`Dropout`);
parameters outside the trainable stages get ``requires_grad=False``
(:func:`resolve_trainable_stages`); the losses are the JAX package's
class-weighted cross-entropies (:func:`weighted_cross_entropy`,
:func:`mixed_weighted_cross_entropy`).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import FUSED_MODES, ModelConfig
from irp_tpu_torch.models.resnet import (BOTTLENECK_DEPTHS, STAGE_NAMES,
                                         ResNet, at_least_f32, lecun_normal_)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


class Linear(nn.Linear):
    """Dense layer computed in ``compute_dtype`` from f32 params."""

    def __init__(self, fin, fout, compute_dtype=torch.bfloat16):
        super().__init__(fin, fout)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Dropout(nn.Module):
    """Inverted dropout with a rate given at run time:
    ``where(mask, x / keep, 0)`` with keep = 1 - rate, ``x / keep``
    rounded to x.dtype.  The mask is the caller's, or Bernoulli(keep)
    drawn from ``generator`` (the default generator when None)."""

    def forward(self, x, rate: float, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        keep = 1.0 - float(rate)
        if mask is None:
            if keep >= 1.0:
                return x
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
        divisor = float(torch.tensor(max(keep, 1e-6)).to(x.dtype))
        return torch.where(mask, x / divisor, torch.zeros_like(x))


def resolve_trainable_stages(cfg: ModelConfig) -> tuple:
    """The effective trainable-stage tuple of a config (the ResNet family
    takes ``trainable_stages`` literally)."""
    if cfg.family != "resnet":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue 1, "
            f"A13: the other model families)")
    return tuple(cfg.trainable_stages)


def is_trainable(name: str, stages: Sequence[str]) -> bool:
    """Whether the parameter ``name`` (a state_dict key) trains: the head
    always; a backbone parameter when its stage is in ``stages`` (the stem
    is in none)."""
    parts = name.split(".")
    if parts[0] != "backbone":
        return True
    return len(parts) > 2 and parts[1] in stages


def _frozen_prefix(cfg: ModelConfig) -> int:
    if cfg.head_only:
        return 4
    trainable = set(cfg.trainable_stages)
    prefix = 0
    for name in STAGE_NAMES:
        if name in trainable:
            break
        prefix += 1
    return prefix


def _check_fused_on(cfg: ModelConfig) -> None:
    """'on' means forced: reject configurations the kernel cannot serve
    instead of running unfused ('auto' degrades silently by design)."""
    problems = []
    if cfg.depth not in BOTTLENECK_DEPTHS:
        problems.append(f"depth {cfg.depth} has no bottlenecks")
    if cfg.bn_stats_mode != "trainable_only":
        problems.append("bn_stats_mode must be 'trainable_only'")
    if cfg.compute_dtype != "bfloat16":
        problems.append("compute_dtype must be 'bfloat16'")
    if cfg.precision != "default":
        problems.append("precision must be 'default'")
    if cfg.groups != 1 or cfg.width_per_group != 64:
        problems.append("ResNeXt/Wide variants have no fused kernel (plain "
                        "ResNet blocks only)")
    if problems:
        raise ValueError("fused_frozen_blocks='on' is incompatible with this "
                         "config: " + "; ".join(problems))


class Classifier(nn.Module):
    """ResNet backbone + 2-layer MLP head; input NCHW (channels_last),
    output f32 logits."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        if cfg.family in ("vit", "efficientnet", "convnext"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md, "
                f"Queue 1, A13: the other model families)")
        if cfg.family != "resnet":
            raise ValueError(f"unknown model family {cfg.family!r}")
        if cfg.fused_frozen_blocks not in FUSED_MODES:
            raise ValueError(f"fused_frozen_blocks must be one of "
                             f"{FUSED_MODES}, got {cfg.fused_frozen_blocks!r}")
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype "
                             f"{cfg.compute_dtype!r}")
        if cfg.precision not in ("default", "highest"):
            raise ValueError(f"unsupported precision {cfg.precision!r}")
        if cfg.fused_frozen_blocks == "on":
            _check_fused_on(cfg)
        self.config = cfg
        dtype = _DTYPES[cfg.compute_dtype]
        self.backbone = ResNet(depth=cfg.depth, groups=cfg.groups,
                               width_per_group=cfg.width_per_group,
                               dtype=dtype,
                               frozen_prefix=_frozen_prefix(cfg),
                               bn_stats_mode=cfg.bn_stats_mode,
                               precision=cfg.precision,
                               fused_frozen_blocks=cfg.fused_frozen_blocks,
                               remat_blocks=cfg.remat_trainable_blocks)
        self.classifier = nn.Sequential(
            Dropout(),
            Linear(self.backbone.num_features, cfg.hidden_dim, dtype),
            nn.ReLU(),
            Dropout(),
            Linear(cfg.hidden_dim, cfg.num_classes, dtype))
        stages = () if cfg.head_only else resolve_trainable_stages(cfg)
        for name, p in self.named_parameters():
            p.requires_grad_(is_trainable(name, stages))

    def precision_scope(self, x):
        """The context a forward on ``x`` runs in, and its backward must
        run in too: with ``precision='highest'`` on a card, cuDNN's convs
        without TF32 (the forward's scope ends before ``backward()``
        runs its convs)."""
        if self.config.precision == "highest" and x.is_cuda:
            return torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False)
        return contextlib.nullcontext()

    def forward(self, x, dropout_rate: Optional[float] = None,
                dropout_masks=None,
                generator: Optional[torch.Generator] = None):
        """f32 logits.  In train mode the head's two dropouts run at
        ``dropout_rate`` (the config's when None), with ``dropout_masks``
        (a pair of bool tensors) or masks drawn from ``generator``."""
        with self.precision_scope(x):
            return self.head(self.backbone(x), dropout_rate, dropout_masks,
                             generator)

    def head(self, feats, dropout_rate: Optional[float] = None,
             dropout_masks=None,
             generator: Optional[torch.Generator] = None):
        """The MLP head on pooled features (B, C) -> f32 (B, classes);
        dropout only in train mode."""
        drop1, dense1, relu, drop2, dense2 = self.classifier
        rate = (self.config.dropout_rate if dropout_rate is None
                else dropout_rate)
        masks = dropout_masks or (None, None)
        y = feats
        if self.training:
            y = drop1(y, rate, masks[0], generator)
        y = relu(dense1(y))
        if self.training:
            y = drop2(y, rate, masks[1], generator)
        return at_least_f32(dense2(y))

    def features(self, x):
        """Headless forward in eval form (inference BN), f32 (B, F): the
        outlier-detection feature extractor's forward."""
        training = self.training
        if training:
            self.eval()
        try:
            with self.precision_scope(x):
                return at_least_f32(self.backbone(x))
        finally:
            if training:
                self.train()

    def spatial_features(self, x):
        """The pre-pool map of the last stage (B, C, h, w), in eval form
        (inference BN): the Grad-CAM surface (``explain.py``)."""
        training = self.training
        if training:
            self.eval()
        try:
            with self.precision_scope(x):
                return self.backbone.forward_spatial(x)
        finally:
            if training:
                self.train()

    def head_from_spatial(self, spatial):
        """A pre-pool map (B, C, h, w) -> eval-form f32 logits: the pool
        and the head without dropout, so that
        ``head_from_spatial(spatial_features(x))`` equals ``forward(x)``
        in eval mode, bit for bit."""
        dense1, relu, dense2 = (self.classifier[1], self.classifier[2],
                                self.classifier[4])
        return at_least_f32(dense2(relu(dense1(self.backbone.pool(spatial)))))

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initializers: lecun_normal kernels, zero Dense biases."""
        self.backbone.init_weights(generator)
        for mod in self.classifier:
            if isinstance(mod, Linear):
                lecun_normal_(mod.weight, mod.in_features, generator)
                with torch.no_grad():
                    mod.bias.zero_()


def get_classifier(cfg: ModelConfig, device=None) -> Classifier:
    """An uninitialized-weights Classifier on ``device`` (CUDA unless the
    caller asks for the CPU), in channels_last memory."""
    dev = resolve_device(device)
    model = Classifier(cfg)
    return model.to(device=dev, memory_format=torch.channels_last)


def init_classifier(cfg: ModelConfig,
                    generator: torch.Generator | None = None,
                    device=None) -> Classifier:
    """A Classifier with weights drawn from ``generator`` (a CPU
    ``torch.Generator``; the default generator when None)."""
    dev = resolve_device(device)
    model = Classifier(cfg)
    model.init_weights(generator)
    return model.to(device=dev, memory_format=torch.channels_last)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           label_smoothing: float = 0.0, denom=None):
    """Per-class-weighted softmax cross-entropy, torch
    ``CrossEntropyLoss(weight=w)``'s weighted mean sum(w_i ce_i) /
    sum(w_i), with label smoothing.  ``denom`` replaces the denominator
    (the batch size, or the weight sum when weighted): gradient
    accumulation passes the full batch's so that micro-batch losses sum
    to the full-batch loss."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) \
            + label_smoothing / num_classes
    ce = -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    if class_weights is None:
        return ce.mean() if denom is None else ce.sum() / denom
    w = class_weights.to(logits.dtype)[labels.long()]
    d = w.sum().clamp_min(1e-8) if denom is None else denom
    return (w * ce).sum() / d


def mixed_weighted_cross_entropy(logits, labels_a, labels_b, lam: float,
                                 class_weights=None,
                                 label_smoothing: float = 0.0,
                                 denom_a=None, denom_b=None):
    """The mixup/CutMix loss ``lam * CE(y_a) + (1 - lam) * CE(y_b)``, each
    term with its own weighted-mean denominator (``ops/mix.py``)."""
    loss_a = weighted_cross_entropy(logits, labels_a, class_weights,
                                    label_smoothing, denom=denom_a)
    loss_b = weighted_cross_entropy(logits, labels_b, class_weights,
                                    label_smoothing, denom=denom_b)
    lam = float(torch.tensor(lam, dtype=loss_a.dtype))
    return lam * loss_a + (1.0 - lam) * loss_b
