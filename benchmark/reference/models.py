"""Plain classifiers over a state_dict: a backbone of the configuration's
family (``families/<family>.py``) and the MLP head.

torchvision's layouts and names under ``backbone.``, and the head
``Dropout -> Linear(F, hidden) -> ReLU -> Dropout -> Linear(hidden,
classes)`` under ``classifier.1`` and ``classifier.4``.  The forward
functions read a dict of tensors; its keys are the names :func:`specs`
gives, which the benchmark's weights carry.  The frozen prefix runs
without autograd.  Dropout divides the kept activations by the keep
probability.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import families
from benchmark.reference.precision import operand

BN_MOMENTUM = 0.1
BUFFERS = ("mean", "var", "count")  # kinds of state that no gradient moves


def conv(x, w, prec, **kw):
    return F.conv2d(operand(x, prec), operand(w, prec), **kw)


def linear(x, w, b, prec):
    return F.linear(operand(x, prec), operand(w, prec), b)


def frozen(train: bool):
    """No autograd for a frozen part of a training forward."""
    return torch.no_grad() if train else contextlib.nullcontext()


def num_features(cfg) -> int:
    return families.load(cfg).num_features(cfg)


def specs(cfg):
    """Every state_dict entry of the classifier: name -> (shape, kind),
    kinds as ``synth.weights`` reads them."""
    s = families.load(cfg).specs(cfg)
    f, h, k = num_features(cfg), cfg["hidden_dim"], cfg["num_classes"]
    s["classifier.1.weight"] = ((h, f), "kernel")
    s["classifier.1.bias"] = ((h,), "bias")
    s["classifier.4.weight"] = ((k, h), "kernel")
    s["classifier.4.bias"] = ((k,), "bias")
    return s


def stage_of(name: str, cfg) -> str:
    """The stage an entry belongs to: 'head' for the classifier, else the
    family's name for its backbone stage ('layer<i>', 'block<i>', ...)."""
    if name.startswith("classifier."):
        return "head"
    return families.load(cfg).stage_of(name.split(".")[1:], cfg)


def trainable(name: str, cfg) -> bool:
    """Whether a parameter trains: the head, and the stages the
    configuration names."""
    stage = stage_of(name, cfg)
    return stage == "head" or stage in cfg["trainable_stages"]


def features(p, cfg, x, prec="float32", train=False, stats_out=None):
    """(B, F) features of an NCHW float32 batch.  ``train``: the frozen
    prefix without autograd and the trainable stages' BatchNorm, where the
    family has it, on batch statistics, each such layer's (mean, biased
    variance) put in ``stats_out`` under its name."""
    return families.load(cfg).features(
        p, cfg, x, prec, train, {} if stats_out is None else stats_out)


def head(p, feats, prec="float32", masks=None, rate: float = 0.0):
    """The MLP head: float32 logits.  ``masks`` (a pair of bool tensors)
    applies dropout at ``rate``."""
    keep = 1.0 - rate
    if masks is not None:
        feats = torch.where(masks[0], feats / keep, torch.zeros_like(feats))
    y = F.relu(linear(feats, p["classifier.1.weight"],
                      p["classifier.1.bias"], prec))
    if masks is not None:
        y = torch.where(masks[1], y / keep, torch.zeros_like(y))
    return linear(y, p["classifier.4.weight"], p["classifier.4.bias"], prec)
