"""The first steps of a fine-tune, plain: what the program's resident
training path must produce from the benchmark's inputs.

The configuration's run, as the program documents it:

- the resident set is the images in the order ``default_rng(shuffle
  seed).permutation(N)``; an epoch's batches are the windows ``[o, o +
  B)`` of that order at offsets ``roll + permutation(windows) * B``,
  ``roll`` uniform below ``min(B, N - B + 1)``, both drawn from
  ``default_rng(sampler seed)`` (``epoch_offsets``);
- each step augments (``augment.py``), runs the classifier in training
  form, takes the class-weighted mean cross-entropy ``sum(w_y ce) /
  sum(w_y)``, and updates the trainable parameters with Adam (beta 0.9 /
  0.999, eps 1e-8) whose gradient carries the coupled decay ``g + wd p``,
  at the one-cycle rate (cosine, torch's defaults) of the step's count
  over ``epochs x N // B`` steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import augment, models
from benchmark.reference.models import BN_MOMENTUM
from benchmark.reference.precision import no_tf32

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def leaf_norms(name: str, t: torch.Tensor) -> dict:
    """The norm of a leaf, an attention block's packed q, k and v
    projections taken as three leaves (the key's bias has no gradient
    under the softmax, so it only moves by rounding)."""
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        return {f"{name}.{part}": float(x.norm())
                for part, x in zip("qkv", t.chunk(3, dim=0))}
    return {name: float(t.norm())}


def diff_norms(a: dict, b: dict) -> dict:
    """Per leaf of ``b`` (q, k and v apart), the norm of ``a - b``; a leaf
    that ``a`` lacks counts as 0 there."""
    out = {}
    for k, t in b.items():
        other = a.get(k)
        d = t.float() if other is None else other.float() - t.float()
        out.update(leaf_norms(k, d))
    return out


def resident_order(n: int, shuffle_seed: int) -> np.ndarray:
    return np.random.default_rng(shuffle_seed).permutation(n)


def first_epoch_offsets(n: int, batch: int, sampler_seed: int) -> np.ndarray:
    rng = np.random.default_rng(sampler_seed)
    bound = min(batch, n - batch + 1)
    roll = int(rng.integers(0, bound)) if bound > 1 else 0
    windows = max((n - roll) // batch, 1)
    return roll + rng.permutation(windows) * batch


def onecycle(count: int, peak: float, total: int, pct: float = 0.3,
             div: float = 25.0, final_div: float = 1e4) -> float:
    """torch OneCycleLR(anneal 'cos') at step ``count`` of ``total``."""
    up = int(pct * total)
    start, top, end = peak / div, peak, peak / (div * final_div)
    if count < up:
        lo, hi, frac = start, top, count / up
    elif count < total:
        lo, hi, frac = top, end, (count - up) / (total - up)
    else:
        return end
    return hi + (lo - hi) / 2.0 * (math.cos(math.pi * frac) + 1.0)


def weighted_ce(logits, labels, weights):
    w = weights[labels]
    ce = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    return (w * ce).sum() / w.sum()


def batch_rows(n, batch, shuffle_seed, sampler_seed, steps):
    """The image indices of the first ``steps`` batches."""
    order = resident_order(n, shuffle_seed)
    offs = first_epoch_offsets(n, batch, sampler_seed)[:steps]
    return [order[o:o + batch] for o in offs]


def follow(cfg, run, weights, images, labels, class_weights, seeds,
           steps: int, device, precision: str = "float32",
           half_batch: bool = False) -> dict:
    """The first ``steps`` optimizer steps from ``weights``.

    ``run``: the traffic's training settings (batch_size, learning_rate,
    weight_decay, nominal_epochs, dropout rate in ``cfg``).  ``seeds``:
    {'shuffle', 'sampler', 'draws'}.  Returns per-step losses, the first
    step's gradient as Adam takes it (``g + wd p``) per trainable leaf,
    and each trainable leaf's and each trained BatchNorm statistic's
    change over the steps; the first step's gradients themselves too
    (``first_grad_tensors``, on the host).

    ``half_batch`` plants a fault, for reading what it does to the
    compared numbers: each step computes on the first half of its batch
    only, the loss the mean over that half."""
    b = run["batch_size"]
    n = len(labels)
    total = run["nominal_epochs"] * (n // b)
    out_px = cfg["image_size"]
    feats_w, hidden = models.num_features(cfg), cfg["hidden_dim"]
    rate = cfg["dropout_rate"]
    p = {k: v.detach().clone().to(device) for k, v in weights.items()}
    names = [k for k, (_, kind) in models.specs(cfg).items()
             if models.trainable(k, cfg) and kind not in models.BUFFERS]
    for k in names:
        p[k].requires_grad_(True)
    start = {k: p[k].detach().clone() for k in p
             if p[k].is_floating_point()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    cw = torch.as_tensor(class_weights, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds["draws"])
    losses, first_grad, first_grad_t = [], {}, {}
    rows = batch_rows(n, b, seeds["shuffle"], seeds["sampler"], steps)
    with no_tf32():
        for t, idx in enumerate(rows):
            x_u8 = torch.from_numpy(images[idx]).to(device)
            y = torch.from_numpy(labels[idx].astype(np.int64)).to(device)
            d = augment.step_draws(gen, b, x_u8.shape[1], x_u8.shape[2],
                                   feats_w, hidden, rate)
            if half_batch:
                h = b // 2
                x_u8, y = x_u8[:h], y[:h]
                d = {k: (tuple(m[:h] for m in v) if k == "masks" else v[:h])
                     for k, v in d.items()}
            x = augment.augment(x_u8, d, out_px)
            stats = {}
            f = models.features(p, cfg, x, precision, train=True,
                                stats_out=stats)
            logits = models.head(p, f, precision, d["masks"], rate)
            loss = weighted_ce(logits, y, cw)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            losses.append(float(loss.detach()))
            lr = onecycle(t, run["learning_rate"], total)
            wd = run["weight_decay"]
            with torch.no_grad():
                for k, g in zip(names, grads):
                    g = g + wd * p[k]
                    if t == 0:
                        first_grad.update(leaf_norms(k, g))
                        first_grad_t[k] = g.detach().cpu()
                    m[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                    v[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                    mh = m[k] / (1 - ADAM_B1 ** (t + 1))
                    vh = v[k] / (1 - ADAM_B2 ** (t + 1))
                    p[k] -= lr * mh / (vh.sqrt() + ADAM_EPS)
                for layer, (mean, var) in stats.items():
                    for leaf, new in (("running_mean", mean),
                                      ("running_var", var)):
                        r = p[f"{layer}.{leaf}"]
                        r.mul_(1 - BN_MOMENTUM).add_(new, alpha=BN_MOMENTUM)
    with torch.no_grad():
        change = {}
        for k in start:
            if k in names or not torch.equal(p[k], start[k]):
                change.update(leaf_norms(k, p[k] - start[k]))
    return {"losses": losses, "first_grad": first_grad,
            "first_grad_tensors": first_grad_t, "change": change,
            "trainable": names}
