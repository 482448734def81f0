"""Backbone + MLP-head classifier (the JAX package's
``models/classifier.py``).

The head is ``Sequential(Dropout, Linear, ReLU, Dropout, Linear)``, so its
keys are ``classifier.1`` / ``classifier.4`` as in the reference stack's
AnimalClassifier; the backbone sits under ``backbone.``.  Only the ResNet
family is ported so far.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import FUSED_MODES, ModelConfig
from irp_tpu_torch.models.resnet import (BOTTLENECK_DEPTHS, STAGE_NAMES,
                                         ResNet, lecun_normal_)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Linear(nn.Linear):
    """Dense layer computed in ``compute_dtype`` from f32 params."""

    def __init__(self, fin, fout, compute_dtype=torch.bfloat16):
        super().__init__(fin, fout)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


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
                               fused_frozen_blocks=cfg.fused_frozen_blocks)
        self.classifier = nn.Sequential(
            nn.Dropout(cfg.dropout_rate),
            Linear(self.backbone.num_features, cfg.hidden_dim, dtype),
            nn.ReLU(),
            nn.Dropout(cfg.dropout_rate),
            Linear(cfg.hidden_dim, cfg.num_classes, dtype))

    def _precision(self, x):
        if self.config.precision == "highest" and x.is_cuda:
            return torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False)
        return contextlib.nullcontext()

    def forward(self, x):
        with self._precision(x):
            return self.classifier(self.backbone(x)).float()

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
