"""ResNet family (v1.5 bottleneck placement, torchvision module names).

Counterpart of the JAX package's ``models/resnet.py``.  Modules are
logically NCHW and meant to be held in ``channels_last`` memory; module
names follow torchvision (``conv1``, ``bn1``, ``layer{1..4}.{j}.conv{k}``,
``downsample.{0,1}``), so torchvision-layout state_dicts load as they are.

- Parameters are f32.  Each conv casts its input and weight to the
  compute dtype (bf16 by default) per op; BatchNorm computes in f32 and
  casts its output back, as flax's ``dtype``/``param_dtype`` pair does.
- ``frozen_prefix`` leading stages (and the stem, when it is > 0) run
  without autograd: the counterpart of the JAX package's single
  ``stop_gradient`` cut after the last frozen stage.
- ``bn_stats_mode='trainable_only'`` keeps the frozen stages' BN in
  inference form even under ``.train()``; 'all' follows ``.train()``.
- ``remat_blocks`` recomputes each trainable block's activations in the
  backward (``torch.utils.checkpoint``) instead of storing them, as the
  JAX package's ``nn.remat`` does; the recompute does not move BN's
  running statistics a second time.
- Frozen identity bottlenecks (j > 0 in a frozen stage) may run through
  the fused kernel (``ops/cuda_resnet.py``), under the JAX package's
  eligibility rule: bottleneck depth, plain width, inference-form BN, bf16
  compute, default precision.  Under the same rule the frozen stages'
  blocks 0 and the stem run with their BN folded into their convs, each
  conv followed by one epilogue pass (bias, residual, ReLU, the stem's
  max-pool).  The parameter tree is the same either way.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from irp_tpu_torch.models.layers import (Conv2d, at_least_f32, flax_init_,
                                         nchw, nhwc)
from irp_tpu_torch.parallel.distributed import all_reduce_sum_autograd
from irp_tpu_torch.ops.cuda_resnet import (fold_bn_into_conv,
                                           frozen_epilogue,
                                           fused_identity_bottleneck)
from irp_tpu_torch.utils import monitor

STAGE_SIZES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK_DEPTHS = (50, 101, 152)
STAGE_NAMES = ("layer1", "layer2", "layer3", "layer4")


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm in f32 (f64 for f64 inputs), output cast to ``compute_dtype``.  ``frozen``
    keeps it in inference form (running stats, no updates) under
    ``.train()``.

    In train mode the batch statistics are flax's: mean and the biased
    variance ``E[x^2] - E[x]^2`` (clipped at 0) in f32 over (N, H, W), and
    the running buffers move by ``momentum`` toward that mean and biased
    variance.  ``F.batch_norm`` would move ``running_var`` toward the
    unbiased variance (n / (n - 1) larger), which the JAX package never
    does.  ``hold_stats`` (set while a checkpointed block recomputes its
    forward) leaves the running buffers where they are.

    ``group`` (a process group, set by :func:`sync_batch_stats`): the
    moments are the global batch's, as the JAX package's forward on the
    sharded global array takes them.  Every path splits its batches
    evenly over the ranks, so the global mean and mean square are the
    ranks' own averaged: summed over the ranks in f32 (one
    differentiable all-reduce, whose backward sums the gradients) and
    divided by the rank count, before the biased variance is formed.
    """

    def __init__(self, features, compute_dtype=torch.bfloat16,
                 frozen: bool = False):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.compute_dtype = compute_dtype
        self.frozen = frozen
        self.hold_stats = False
        self.group = None

    def forward(self, x):
        if not self.training or self.frozen:
            xf = at_least_f32(x)
            dt = xf.dtype
            y = F.batch_norm(xf, self.running_mean.to(dt),
                             self.running_var.to(dt), self.weight.to(dt),
                             self.bias.to(dt), False, 0.0, self.eps)
            return y.to(self.compute_dtype)
        xf = at_least_f32(x)
        if self.group is None:
            mean = xf.mean(dim=(0, 2, 3))
            ex2 = (xf * xf).mean(dim=(0, 2, 3))
        else:
            # every rank holds an equal share of the global batch: the
            # global moments are the mean of the ranks' moments (over one
            # rank, this rank's, bit for bit)
            c = xf.shape[1]
            sums = all_reduce_sum_autograd(torch.cat(
                [xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))]),
                self.group)
            ranks = torch.distributed.get_world_size(self.group)
            mean, ex2 = sums[:c] / ranks, sums[c:] / ranks
        var = (ex2 - mean * mean).clamp_min(0.0)
        if not self.hold_stats:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_(keep * self.running_var
                                       + self.momentum * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.compute_dtype)


def sync_batch_stats(model: nn.Module, group=None) -> None:
    """Take every BatchNorm2d's train-mode moments over ``group``'s
    global batch (None: this process's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group


@contextlib.contextmanager
def _stats_held(module: nn.Module):
    """While a checkpointed block recomputes its forward, its BN layers
    keep their running statistics (they moved in the first forward)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for bn in bns:
        bn.hold_stats = True
    try:
        yield
    finally:
        for bn in bns:
            bn.hold_stats = False


def _recompute_contexts(module: nn.Module):
    """``torch.utils.checkpoint``'s context pair: the first forward as
    is, the recompute with the BN statistics held."""
    return contextlib.nullcontext(), _stats_held(module)


def remat_call(block: nn.Module, *args):
    """``block(*args)`` with its activations recomputed in the backward
    instead of stored (``torch.utils.checkpoint``), its BN layers'
    running statistics held during the recompute: the JAX package's
    ``nn.remat`` of a trainable block."""
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False,
        context_fn=functools.partial(_recompute_contexts, block))


def frozen_scope(frozen: bool):
    """The scope a frozen part of a backbone runs in: no autograd (the
    counterpart of the JAX package's ``stop_gradient`` cut after the last
    frozen stage), or as is."""
    if frozen and torch.is_grad_enabled():
        return torch.no_grad()
    return contextlib.nullcontext()


class BasicBlock(nn.Module):
    """Two 3x3 convs (ResNet-18/34)."""

    expansion = 1

    def __init__(self, inplanes, planes, stride, dtype, frozen_bn,
                 groups=1, width_per_group=64):
        super().__init__()
        del groups, width_per_group  # the ResNet checks BasicBlock gets 1/64
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1,
                            compute_dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype, frozen_bn)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, compute_dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype, frozen_bn)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, compute_dtype=dtype),
                BatchNorm2d(planes, dtype, frozen_bn))

    def forward(self, x, fused: bool = False):
        del fused  # no fused kernel for basic blocks
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def folded_conv(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype):
    """(weight, bias): ``bn``'s inference form folded into ``conv`` in f32,
    the weight in F.conv2d's OIHW layout and the conv weight's memory
    format, cast to ``dtype``; the bias (C_out,) f32 (f64 stays)."""
    kernel = conv.weight.detach().permute(2, 3, 1, 0)  # OIHW->HWIO
    wf, bf = fold_bn_into_conv(kernel, bn.weight.detach(), bn.bias.detach(),
                               bn.running_mean, bn.running_var, bn.eps)
    return wf.permute(3, 2, 0, 1).to(dtype), at_least_f32(bf).contiguous()


def _nhwc(x):
    """The NHWC tensor the epilogue takes, from an NCHW map held in
    channels_last memory (a view)."""
    return nhwc(x).contiguous()


class FoldCache(nn.Module):
    """A module whose fused forward reads its inference BN folded into its
    convs (``folded_weights``) where ``foldable``; ``_cache_own_fold``
    folds once, so the fused forward does not refold per call.  train(),
    load_state_dict and device or dtype moves drop the cache; an in-place
    edit of the parameters does not."""

    foldable = False
    _folded = None

    def folded_weights(self) -> tuple:
        raise NotImplementedError

    def _cache_own_fold(self) -> None:
        with torch.no_grad():
            self._folded = self.folded_weights()

    def train(self, mode: bool = True):
        self._folded = None
        return super().train(mode)

    def _apply(self, *args, **kwargs):
        self._folded = None
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._folded = None
        super()._load_from_state_dict(*args, **kwargs)


class Bottleneck(FoldCache):
    """1x1 -> 3x3(stride) -> 1x1 with expansion 4 (ResNet-50/101/152),
    stride on the 3x3 (v1.5).  ``groups``/``width_per_group``: ResNeXt /
    Wide-ResNet.  ``foldable`` marks a block of a frozen stage that may
    run with its BN folded when the forward asks for it: an identity block
    (``fusable``) through the fused kernel, a block with a downsample as
    four folded convs and three epilogue passes."""

    expansion = 4

    def __init__(self, inplanes, planes, stride, dtype, frozen_bn,
                 groups=1, width_per_group=64, foldable: bool = False):
        super().__init__()
        width = int(planes * width_per_group / 64.0) * groups
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, width, 1, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(width, dtype, frozen_bn)
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups=groups,
                            compute_dtype=dtype)
        self.bn2 = BatchNorm2d(width, dtype, frozen_bn)
        self.conv3 = Conv2d(width, out, 1, compute_dtype=dtype)
        self.bn3 = BatchNorm2d(out, dtype, frozen_bn)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, stride, compute_dtype=dtype),
                BatchNorm2d(out, dtype, frozen_bn))
        self.compute_dtype = dtype
        self.foldable = foldable
        self.fusable = foldable and self.downsample is None

    def forward(self, x, fused: bool = False):
        if fused and self.fusable:
            return self._fused(x)
        if fused and self.foldable:
            return self._folded_forward(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)

    def folded_weights(self):
        """Each inference BN folded into its conv in f32, weights then cast
        to the compute dtype, biases kept f32.  An identity block: (w1,
        b1, w2, b2, w3, b3) in the fused kernel's layout (HWIO, 1x1
        kernels as (C_in, C_out) matrices).  A block with a downsample:
        (w1, b1, w2, b2, w3, b3, wd, bd), the weights in F.conv2d's layout
        (:func:`folded_conv`)."""
        pairs = ((self.conv1, self.bn1), (self.conv2, self.bn2),
                 (self.conv3, self.bn3))
        if self.downsample is not None:
            pairs += (tuple(self.downsample),)
        out = []
        for conv, bn in pairs:
            w, b = folded_conv(conv, bn, self.compute_dtype)
            if self.downsample is None:
                w = w.permute(2, 3, 1, 0)  # OIHW -> HWIO
                if w.shape[0] == 1:
                    w = w.reshape(w.shape[2], w.shape[3])
                w = w.contiguous()
            out += [w, b]
        return tuple(out)

    def _fused(self, x):
        # NCHW in channels_last memory is NHWC: the permute is a view
        x_nhwc = x.to(self.compute_dtype).permute(0, 2, 3, 1).contiguous()
        weights = self._folded or self.folded_weights()
        y = fused_identity_bottleneck(x_nhwc, *weights)
        return y.permute(0, 3, 1, 2)

    def _folded_forward(self, x):
        """The block with its BN folded: each conv in bf16 with no bias,
        then one epilogue pass (``relu(y + b)`` after conv1 and conv2,
        ``relu(y + r + (b3 + bd))`` at the tail)."""
        w1, b1, w2, b2, w3, b3, wd, bd = (self._folded
                                          or self.folded_weights())
        x = x.to(self.compute_dtype)
        y = nchw(frozen_epilogue(_nhwc(F.conv2d(x, w1)), b1))
        y = nchw(frozen_epilogue(_nhwc(F.conv2d(
            y, w2, None, self.conv2.stride, self.conv2.padding)), b2))
        r = _nhwc(F.conv2d(x, wd, None, self.downsample[0].stride))
        return nchw(frozen_epilogue(_nhwc(F.conv2d(y, w3)), b3, r, bd))


class ResNet(FoldCache):
    """Headless ResNet returning globally pooled features (B, C).  Its own
    fold (``foldable``, ``folded_weights``) is the stem's."""

    def __init__(self, depth: int = 50, groups: int = 1,
                 width_per_group: int = 64, dtype=torch.bfloat16,
                 frozen_prefix: int = 3,
                 bn_stats_mode: str = "trainable_only",
                 precision: str = "default",
                 fused_frozen_blocks: str = "off",
                 remat_blocks: bool = False):
        super().__init__()
        if depth not in STAGE_SIZES:
            raise ValueError(f"unsupported ResNet depth {depth}")
        if bn_stats_mode not in ("trainable_only", "all"):
            raise ValueError(f"unknown bn_stats_mode {bn_stats_mode!r}")
        block_cls = Bottleneck if depth in BOTTLENECK_DEPTHS else BasicBlock
        if (groups != 1 or width_per_group != 64) and block_cls is BasicBlock:
            raise ValueError(
                f"groups/width_per_group variants need a bottleneck depth "
                f"(50/101/152), got depth {depth}")
        self.depth = depth
        self.frozen_prefix = frozen_prefix
        self.fused_frozen_blocks = fused_frozen_blocks
        self.remat_blocks = remat_blocks
        self.compute_dtype = dtype

        def frozen_bn(frozen_stage: bool) -> bool:
            return bn_stats_mode == "trainable_only" and frozen_stage

        self.conv1 = Conv2d(3, 64, 7, 2, 3, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype, frozen_bn(frozen_prefix > 0))
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        fusable_stage = (block_cls is Bottleneck and groups == 1
                         and width_per_group == 64
                         and bn_stats_mode == "trainable_only"
                         and dtype == torch.bfloat16
                         and precision == "default")
        self.foldable = fusable_stage and frozen_prefix > 0
        inplanes = 64
        for i, num_blocks in enumerate(STAGE_SIZES[depth]):
            frozen = (i + 1) <= frozen_prefix
            planes = 64 * 2 ** i
            blocks = []
            for j in range(num_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                kwargs = {}
                if block_cls is Bottleneck:
                    kwargs["foldable"] = fusable_stage and frozen
                blocks.append(block_cls(inplanes, planes, stride, dtype,
                                        frozen_bn(frozen), groups,
                                        width_per_group, **kwargs))
                inplanes = planes * block_cls.expansion
            setattr(self, STAGE_NAMES[i], nn.Sequential(*blocks))
        self.num_features = inplanes

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initializers: lecun_normal convs, BN scale 1 / bias 0,
        running mean 0 / var 1."""
        flax_init_(self, generator)

    def fuse_active(self, x: torch.Tensor) -> bool:
        """Whether this forward routes fusable blocks through the kernel
        and runs the stem and the other foldable blocks folded: always for
        'on', on CUDA inputs for 'auto'."""
        mode = self.fused_frozen_blocks
        return mode == "on" or (mode == "auto" and x.is_cuda)

    def folded_weights(self):
        """The stem's (weight, bias): ``bn1`` folded into ``conv1``
        (:func:`folded_conv`)."""
        return folded_conv(self.conv1, self.bn1, self.compute_dtype)

    def cache_folded_weights(self) -> None:
        """Fold the BN of the stem and of every foldable block once
        (:meth:`FoldCache._cache_own_fold`); for a model kept in eval
        form, or whose BN the mode keeps in inference form."""
        if self.fused_frozen_blocks == "off":
            return
        for mod in self.modules():
            if isinstance(mod, FoldCache) and mod.foldable:
                mod._cache_own_fold()

    def forward(self, x):
        return self.forward_trainable(self.forward_frozen(x))

    def forward_frozen(self, x):
        """The stem and the first ``frozen_prefix`` stages: the stages run
        without autograd, and the stem too when the prefix is not empty.
        Only these stages hold foldable blocks.  In train mode it is the
        span ``train.forward.frozen``, which counts K1's and the
        epilogue's launches (on the card; 0 on the CPU)."""
        fused = self.fuse_active(x)
        grad = torch.is_grad_enabled()
        span = (monitor.span("train.forward.frozen") if self.training
                else monitor.NO_SPAN)
        with span:
            launches = fused_identity_bottleneck.launches
            epilogues = frozen_epilogue.launches
            with torch.set_grad_enabled(grad and self.frozen_prefix == 0):
                x = self.stem(x, fused)
            with torch.set_grad_enabled(False):
                for name in STAGE_NAMES[:self.frozen_prefix]:
                    for block in getattr(self, name):
                        x = block(x, fused)
            span.count("k1_launches",
                       fused_identity_bottleneck.launches - launches)
            span.count("epilogue_launches",
                       frozen_epilogue.launches - epilogues)
        return x

    def stem(self, x, fused: bool = False):
        """conv1, bn1, ReLU and the max-pool; with ``fused`` and a
        foldable stem, the folded conv and one epilogue pass."""
        x = x.to(self.compute_dtype)
        if fused and self.foldable:
            w, b = self._folded or self.folded_weights()
            y = F.conv2d(x, w, None, self.conv1.stride, self.conv1.padding)
            return nchw(frozen_epilogue(_nhwc(y), b, pool=True))
        return self.maxpool(F.relu(self.bn1(self.conv1(x))))

    def forward_trainable(self, x):
        """The stages after the frozen prefix and the global pool:
        ``forward(x) == forward_trainable(forward_frozen(x))``.  With
        ``remat_blocks``, each block's activations are recomputed in the
        backward instead of stored."""
        return self.pool(self.trainable_stages(x))

    def trainable_stages(self, x):
        """The stages after the frozen prefix, without the pool."""
        remat = self.remat_blocks and torch.is_grad_enabled()
        for name in STAGE_NAMES[self.frozen_prefix:]:
            for block in getattr(self, name):
                if remat:
                    x = remat_call(block, x)
                else:
                    x = block(x)
        return x

    def forward_spatial(self, x):
        """The last stage's map (B, C, h, w) before the global pool:
        ``forward(x) == pool(forward_spatial(x))``."""
        return self.trainable_stages(self.forward_frozen(x))

    def pool(self, x):
        """Global average pool in f32 (f64 stays), cast to the compute
        dtype: (B, C, h, w) -> (B, C)."""
        return at_least_f32(x).mean(dim=(2, 3)).to(self.compute_dtype)
