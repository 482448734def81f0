"""Backbone + MLP-head classifier (the JAX package's
``models/classifier.py``).

The head is ``Sequential(Dropout, Linear, ReLU, Dropout, Linear)``, so its
keys are ``classifier.1`` / ``classifier.4`` as in the reference stack's
AnimalClassifier; the backbone sits under ``backbone.``.  Four families:
ResNet (``models/resnet.py``), ViT (``models/vit.py``), EfficientNet
(``models/efficientnet.py``) and ConvNeXt (``models/convnext.py``), with
the JAX package's stage names and freezing rules
(:func:`resolve_trainable_stages`).  The fused frozen-block kernel is a
ResNet bottleneck kernel: ``fused_frozen_blocks='on'`` is refused for the
other families and 'auto' runs them unfused.

Training (every family): the head's dropout takes its rate at run time
and its mask from the caller or from a generator the caller gives
(:class:`Dropout`); stochastic depth (EfficientNet, ConvNeXt) takes each
block's per-sample keep mask from the caller (``sd_masks``) or draws them
from the same generator before the forward
(``models/layers.py::sample_sd_masks``); parameters outside the trainable
stages get ``requires_grad=False`` by the family's stage names
(:func:`backbone_stage`, the JAX package's ``trainable_mask``); the losses
are the JAX package's class-weighted cross-entropies
(:func:`weighted_cross_entropy`, :func:`mixed_weighted_cross_entropy`).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import FUSED_MODES, ModelConfig
from irp_tpu_torch.models.convnext import (STAGE_COUNT as _CNX_STAGES,
                                           ConvNeXt,
                                           convnext_default_trainable_stages)
from irp_tpu_torch.models.efficientnet import (
    STAGE_COUNT as _EFF_STAGES, EfficientNet,
    efficientnet_default_trainable_stages)
from irp_tpu_torch.models.layers import (Linear, at_least_f32, lecun_normal_,
                                         sample_sd_masks)
from irp_tpu_torch.models.resnet import BOTTLENECK_DEPTHS, STAGE_NAMES, ResNet
from irp_tpu_torch.models.vit import (VisionTransformer, resolve_num_heads,
                                      vit_default_trainable_stages)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


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
    """The effective trainable-stage tuple of a config.  For the other
    families the untouched ResNet default ('layer4',) means the family's
    last-stage recipe (ViT: the last block and the final LayerNorm;
    EfficientNet: stage7 and the top conv; ConvNeXt: stage4 and the final
    LayerNorm); anything else is taken literally."""
    if tuple(cfg.trainable_stages) == ("layer4",):
        if cfg.family == "vit":
            return vit_default_trainable_stages(cfg.num_layers)
        if cfg.family == "efficientnet":
            return efficientnet_default_trainable_stages()
        if cfg.family == "convnext":
            return convnext_default_trainable_stages()
    return tuple(cfg.trainable_stages)


def _vit_frozen_prefix(cfg: ModelConfig, stages: tuple) -> int:
    """Leading encoder blocks with no trainable stage at or before them
    ('embed' trainable: 0, the embedding sits before block 0)."""
    if cfg.head_only:
        return cfg.num_layers
    if "embed" in stages:
        return 0
    blocks = []
    for name in stages:
        if name.startswith("block"):
            idx = int(name[len("block"):])
            if not 0 <= idx < cfg.num_layers:
                raise ValueError(
                    f"trainable stage {name!r} out of range for "
                    f"num_layers={cfg.num_layers}")
            blocks.append(idx)
        elif name != "ln":
            raise ValueError(
                f"unknown ViT trainable stage {name!r} (expected "
                f"'block<i>', 'ln', or 'embed')")
    return min(blocks) if blocks else cfg.num_layers


def _stage_prefix(stages: tuple, count: int, family: str,
                  last: str) -> int:
    """Leading 'stage<i>' stages (1..count) with no trainable stage at or
    before them; besides 'stage<i>' and 'stem', only ``last`` is a known
    stage name."""
    indices = []
    for name in stages:
        if name.startswith("stage"):
            idx = int(name[len("stage"):])
            if not 1 <= idx <= count:
                raise ValueError(
                    f"trainable stage {name!r} out of range "
                    f"(stage1..stage{count})")
            indices.append(idx)
        elif name != last:
            raise ValueError(
                f"unknown {family} trainable stage {name!r} (expected "
                f"'stage<i>', 'stem', or '{last}')")
    return min(indices) - 1 if indices else count


def _efficientnet_freezing(cfg: ModelConfig, stages: tuple):
    """(frozen_prefix, top_frozen) of an EfficientNet config: the leading
    MBConv stages with no trainable stage at or before them ('stem'
    trainable: 0), and whether the top conv is frozen."""
    if cfg.head_only:
        return _EFF_STAGES, True
    top_frozen = "top" not in stages
    if "stem" in stages:
        return 0, top_frozen
    return _stage_prefix(stages, _EFF_STAGES, "EfficientNet",
                         "top"), top_frozen


def _convnext_freezing(cfg: ModelConfig, stages: tuple) -> int:
    """The frozen prefix of a ConvNeXt config: leading stages with no
    trainable stage at or before them ('stem' trainable: 0).  The final
    LayerNorm ('ln') is after the pool and never moves it."""
    if cfg.head_only:
        return _CNX_STAGES
    if "stem" in stages:
        return 0
    return _stage_prefix(stages, _CNX_STAGES, "ConvNeXt", "ln")


_VIT_EMBED = ("conv_proj", "class_token", "encoder.pos_embedding")


def backbone_stage(name: str, family: str) -> str:
    """The JAX package's stage name of a backbone state_dict key (without
    ``backbone.``), as ``train/state.py::trainable_mask`` reads it off the
    flax path: ResNet ``layer<i>`` (the stem's ``conv1``/``bn1`` are in no
    stage); ViT ``embed`` (conv_proj, class token, position embedding),
    ``block<i>``, ``ln``; EfficientNet ``stem``, ``stage<s>``, ``top``;
    ConvNeXt ``stem``, ``stage<s>`` (with the downsample into it),
    ``ln``."""
    parts = name.split(".")
    if family == "vit":
        if name.startswith(_VIT_EMBED):
            return "embed"
        if parts[1] == "layers":  # encoder.layers.encoder_layer_<i>.
            return "block" + parts[2][len("encoder_layer_"):]
        return "ln"  # encoder.ln
    if family in ("efficientnet", "convnext"):
        if parts[0] == "ln":
            return "ln"
        idx = int(parts[1])  # features.<idx>.
        if idx == 0:
            return "stem"
        if family == "efficientnet":
            return "top" if idx == _EFF_STAGES + 1 else f"stage{idx}"
        # odd: stage (idx + 1) // 2; even: the downsample into idx // 2 + 1
        return f"stage{(idx + 1) // 2 if idx % 2 else idx // 2 + 1}"
    return parts[0]


def is_trainable(name: str, stages: Sequence[str], family: str) -> bool:
    """Whether the parameter ``name`` (a state_dict key) trains: the head
    always; a backbone parameter when its stage (:func:`backbone_stage`)
    is in ``stages``."""
    if not name.startswith("backbone."):
        return True
    return backbone_stage(name[len("backbone."):], family) in stages


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


def _build_backbone(cfg: ModelConfig, dtype: torch.dtype) -> nn.Module:
    """The family's backbone, with the family's freezing rules."""
    if cfg.family == "resnet":
        if cfg.fused_frozen_blocks == "on":
            _check_fused_on(cfg)
        return ResNet(depth=cfg.depth, groups=cfg.groups,
                      width_per_group=cfg.width_per_group, dtype=dtype,
                      frozen_prefix=_frozen_prefix(cfg),
                      bn_stats_mode=cfg.bn_stats_mode,
                      precision=cfg.precision,
                      fused_frozen_blocks=cfg.fused_frozen_blocks,
                      remat_blocks=cfg.remat_trainable_blocks)
    if cfg.fused_frozen_blocks == "on":
        raise ValueError(f"fused_frozen_blocks='on' is a ResNet bottleneck "
                         f"kernel; not available for family={cfg.family!r}")
    stages = resolve_trainable_stages(cfg)
    remat = cfg.remat_trainable_blocks
    if cfg.family == "vit":
        return VisionTransformer(
            patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            num_layers=cfg.num_layers, num_heads=resolve_num_heads(cfg),
            mlp_dim=cfg.mlp_dim, image_size=cfg.image_size, dtype=dtype,
            frozen_prefix=_vit_frozen_prefix(cfg, stages),
            remat_blocks=remat)
    if cfg.family == "efficientnet":
        frozen_prefix, top_frozen = _efficientnet_freezing(cfg, stages)
        return EfficientNet(width_mult=cfg.width_mult,
                            depth_mult=cfg.depth_mult, dtype=dtype,
                            frozen_prefix=frozen_prefix,
                            top_frozen=top_frozen,
                            bn_stats_mode=cfg.bn_stats_mode,
                            stochastic_depth_prob=cfg.stochastic_depth,
                            remat_blocks=remat)
    return ConvNeXt(dims=tuple(cfg.convnext_dims),
                    depths=tuple(cfg.convnext_depths), dtype=dtype,
                    frozen_prefix=_convnext_freezing(cfg, stages),
                    stochastic_depth_prob=cfg.stochastic_depth,
                    remat_blocks=remat)


class Classifier(nn.Module):
    """Backbone (ResNet, ViT, EfficientNet or ConvNeXt) + 2-layer MLP head;
    input NCHW (channels_last), output f32 logits."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        if cfg.family not in ("resnet", "vit", "efficientnet", "convnext"):
            raise ValueError(f"unknown model family {cfg.family!r}")
        if cfg.fused_frozen_blocks not in FUSED_MODES:
            raise ValueError(f"fused_frozen_blocks must be one of "
                             f"{FUSED_MODES}, got {cfg.fused_frozen_blocks!r}")
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype "
                             f"{cfg.compute_dtype!r}")
        if cfg.precision not in ("default", "highest"):
            raise ValueError(f"unsupported precision {cfg.precision!r}")
        self.config = cfg
        dtype = _DTYPES[cfg.compute_dtype]
        self.backbone = _build_backbone(cfg, dtype)
        self.classifier = nn.Sequential(
            Dropout(),
            Linear(self.backbone.num_features, cfg.hidden_dim, dtype),
            nn.ReLU(),
            Dropout(),
            Linear(cfg.hidden_dim, cfg.num_classes, dtype))
        stages = () if cfg.head_only else resolve_trainable_stages(cfg)
        for name, p in self.named_parameters():
            p.requires_grad_(is_trainable(name, stages, cfg.family))

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
                generator: Optional[torch.Generator] = None,
                sd_masks=None):
        """f32 logits.  In train mode the head's two dropouts run at
        ``dropout_rate`` (the config's when None), with ``dropout_masks``
        (a pair of bool tensors) or masks drawn from ``generator``, and
        the backbone's stochastic depth with ``sd_masks`` (block name ->
        (B,) bool keep mask, :meth:`sd_probs` names the blocks) or masks
        drawn from ``generator`` first.  In the JAX package's order of
        draws: the blocks in forward order, then the head's two."""
        with self.precision_scope(x):
            if self.config.family == "resnet":
                feats = self.backbone(x)
            else:
                if self.training and sd_masks is None:
                    sd_masks = sample_sd_masks(self.sd_probs(), x.shape[0],
                                               generator, x.device)
                feats = self.backbone(x, sd_masks if self.training
                                      else None)
            return self.head(feats, dropout_rate, dropout_masks, generator)

    def sd_probs(self) -> dict:
        """``{block name: drop probability}`` of the backbone's blocks with
        stochastic depth (p > 0; the JAX package's block names), in
        forward order; empty for ResNet and ViT."""
        probs = getattr(self.backbone, "sd_probs", None)
        return probs() if probs is not None else {}

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

    def head_eval(self, feats):
        """The eval-form head (no dropout): (B, C) -> f32 (B, classes)."""
        dense1, relu, dense2 = (self.classifier[1], self.classifier[2],
                                self.classifier[4])
        return at_least_f32(dense2(relu(dense1(feats))))

    @contextlib.contextmanager
    def _eval_form(self, x):
        """Eval mode (inference BN) and the precision scope for one
        surface call, restoring train mode after."""
        training = self.training
        if training:
            self.eval()
        try:
            with self.precision_scope(x):
                yield
        finally:
            if training:
                self.train()

    def features(self, x):
        """Headless forward in eval form (inference BN), f32 (B, F): the
        outlier-detection feature extractor's forward."""
        with self._eval_form(x):
            return at_least_f32(self.backbone(x))

    def spatial_features(self, x):
        """The pre-pool map (B, C, h, w) in eval form: the Grad-CAM
        surface of the ResNet, EfficientNet and ConvNeXt families
        (``explain.py``).  For ViT, the post-LayerNorm patch-token grid
        (B, E, gh, gw); its Grad-CAM reads :meth:`vit_tokens` instead."""
        with self._eval_form(x):
            return self.backbone.forward_spatial(x)

    def head_from_spatial(self, spatial):
        """A pre-pool map (B, C, h, w) -> eval-form f32 logits: the pool
        (for ConvNeXt, the pool and then its final LayerNorm) and the head
        without dropout, so that ``head_from_spatial(spatial_features(x))``
        equals ``forward(x)`` in eval mode, bit for bit."""
        return self.head_eval(self.backbone.pool(spatial))

    def vit_tokens(self, x):
        """ViT's Grad-CAM surface: the tokens (B, S, E) entering the last
        encoder block, in eval form."""
        with self._eval_form(x):
            return self.backbone.prefix_tokens(x)

    def vit_logits_from_tokens(self, tokens):
        """The last block, the final LayerNorm, the CLS pick and the
        eval-form head: (B, S, E) -> f32 (B, K);
        ``vit_logits_from_tokens(vit_tokens(x))`` equals ``forward(x)`` in
        eval mode, bit for bit."""
        with self._eval_form(tokens):
            return self.head_eval(self.backbone.suffix_feature(tokens))

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initializers: lecun_normal kernels, zero Dense biases
        (each family's ``init_weights`` for its backbone)."""
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
