"""Bottleneck ResNets (v1.5: the stride on the 3x3 conv), torchvision's
layout and names.

BatchNorm of the frozen stem and stages runs in inference form (its
running statistics); BatchNorm of a trainable stage in training form,
normalizing by the batch's mean and biased variance, and moving its
running statistics by 0.1 toward that mean and that biased variance
(``reference/train.py``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

from benchmark.reference.models import conv, frozen

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BN_EPS = 1e-5


def _stages(cfg):
    if cfg["depth"] not in STAGES:
        raise ValueError(f"the reference has bottleneck ResNets only, not "
                         f"depth {cfg['depth']}")
    return STAGES[cfg["depth"]]


def specs(cfg) -> "OrderedDict":
    s = OrderedDict()

    def conv_w(name, cout, cin, k):
        s[f"backbone.{name}.weight"] = ((cout, cin, k, k), "kernel")

    def bn(name, c, scale="scale"):
        for leaf, kind in (("weight", scale), ("bias", "bias"),
                           ("running_mean", "mean"), ("running_var", "var"),
                           ("num_batches_tracked", "count")):
            s[f"backbone.{name}.{leaf}"] = ((c,) if kind != "count" else (),
                                            kind)

    conv_w("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for i, blocks in enumerate(_stages(cfg)):
        width = 64 * 2 ** i
        for j in range(blocks):
            pre = f"layer{i + 1}.{j}"
            conv_w(f"{pre}.conv1", width, cin, 1)
            bn(f"{pre}.bn1", width)
            conv_w(f"{pre}.conv2", width, width, 3)
            bn(f"{pre}.bn2", width)
            conv_w(f"{pre}.conv3", 4 * width, width, 1)
            bn(f"{pre}.bn3", 4 * width, "branch_scale")
            if j == 0:
                conv_w(f"{pre}.downsample.0", 4 * width, cin, 1)
                bn(f"{pre}.downsample.1", 4 * width)
            cin = 4 * width
    return s


def num_features(cfg) -> int:
    return 64 * 2 ** (len(_stages(cfg)) - 1) * 4


def stage_of(parts, cfg) -> str:
    """'layer<i>' or 'stem'."""
    return parts[0] if parts[0].startswith("layer") else "stem"


def _frozen_stages(cfg) -> int:
    """Stages before the first trainable one."""
    for i in range(4):
        if f"layer{i + 1}" in cfg["trainable_stages"]:
            return i
    return 4


class _Net:
    def __init__(self, p, cfg, prec, stats_out, calibrate=False):
        if cfg["bn_stats_mode"] != "trainable_only":
            raise ValueError("the reference follows bn_stats_mode "
                             "'trainable_only' only")
        self.p, self.cfg, self.prec = p, cfg, prec
        self.stats_out = stats_out
        self.calibrate = calibrate

    def bn(self, name, x, batch_stats):
        p = self.p
        w, b = p[f"backbone.{name}.weight"], p[f"backbone.{name}.bias"]
        if batch_stats or self.calibrate:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            self.stats_out[f"backbone.{name}"] = (mean.detach(),
                                                  var.detach())
        else:
            mean = p[f"backbone.{name}.running_mean"]
            var = p[f"backbone.{name}.running_var"]
        scale = w * torch.rsqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + b[:, None, None]

    def conv(self, name, x, stride=1, padding=0):
        return conv(x, self.p[f"backbone.{name}.weight"], self.prec,
                    stride=stride, padding=padding)

    def block(self, pre, x, stride, batch_stats):
        y = F.relu(self.bn(f"{pre}.bn1", self.conv(f"{pre}.conv1", x),
                           batch_stats))
        y = F.relu(self.bn(f"{pre}.bn2",
                           self.conv(f"{pre}.conv2", y, stride, 1),
                           batch_stats))
        y = self.bn(f"{pre}.bn3", self.conv(f"{pre}.conv3", y), batch_stats)
        if f"backbone.{pre}.downsample.0.weight" in self.p:
            x = self.bn(f"{pre}.downsample.1",
                        self.conv(f"{pre}.downsample.0", x, stride),
                        batch_stats)
        return F.relu(y + x)

    def features(self, x, train):
        n_frozen = _frozen_stages(self.cfg)
        with frozen(train and n_frozen > 0):
            x = self.bn("bn1", self.conv("conv1", x, 2, 3),
                        train and n_frozen == 0)
            x = F.max_pool2d(F.relu(x), 3, 2, 1)
        for i, blocks in enumerate(_stages(self.cfg)):
            batch_stats = train and i >= n_frozen
            with frozen(train and i < n_frozen):
                for j in range(blocks):
                    x = self.block(f"layer{i + 1}.{j}", x,
                                   2 if i > 0 and j == 0 else 1, batch_stats)
        return x.mean(dim=(2, 3))


def features(p, cfg, x, prec, train, stats_out):
    return _Net(p, cfg, prec, stats_out).features(x, train)


@torch.no_grad()
def calibrate(state, cfg, x) -> None:
    """Every BatchNorm's running statistics set to those of its inputs
    over ``x``: each layer then takes away the mean its inputs share, and
    the features differ from image to image as a trained network's do."""
    stats = {}
    _Net(state, cfg, "float32", stats, calibrate=True).features(x, False)
    for layer, (mean, var) in stats.items():
        state[f"{layer}.running_mean"].copy_(mean)
        state[f"{layer}.running_var"].copy_(var)


def products(cfg):
    s = cfg["image_size"]
    out = [("stem", 2 * (s // 2) ** 2 * 64 * 3 * 49, True)]
    h, cin = s // 4, 64
    for i, blocks in enumerate(_stages(cfg)):
        w = 64 * 2 ** i
        stage = f"layer{i + 1}"
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            h_out = h // stride
            first = j == 0  # its input comes from the stage before
            out.append((stage, 2 * h * h * w * cin, not first))
            out.append((stage, 2 * h_out * h_out * w * w * 9, True))
            out.append((stage, 2 * h_out * h_out * 4 * w * w, True))
            if first:
                out.append((stage, 2 * h_out * h_out * 4 * w * cin, False))
            h, cin = h_out, 4 * w
    return out, cin


def k1_blocks(cfg, batch: int):
    """K1 runs the identity bottlenecks: blocks j > 0 of the frozen
    stages."""
    h = cfg["image_size"] // 4
    out = []
    for i, blocks in enumerate(_stages(cfg)[:_frozen_stages(cfg)]):
        if i > 0:
            h //= 2
        w = 64 * 2 ** i
        out += [(batch, h, h, 4 * w, w)] * (blocks - 1)
    return out
