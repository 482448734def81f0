#!/usr/bin/env python
"""How far one f32 train step's gradients sit from the float64 step's,
and how much of that the ReLU masks explain.

From one set of weights (``init_classifier`` at ``--seed``) and one batch
(smooth random images, normalized), one train step of
``train/step.py::loss_and_grads`` (dropout 0, class weights 1) runs:

- in f32 (``precision='highest'``, the unfused frozen blocks), recording
  every ReLU's mask (pre-activation > 0) in call order;
- in float64 (``compute_dtype='float64'``), free;
- in float64 with each ReLU held to the f32 run's mask.

It prints one JSON line: the f32 step's gaps from the free float64 step
and from the mask-held one (loss relative; max|g - g64| over layer4's
and over the head's largest |g64|), and how many ReLU elements the two
runs mask differently.  Where the first gap is large and the second
small, the f32 step is not less accurate in its arithmetic: rounding
moved pre-activations across 0, and layer4's weight gradients, sums that
cancel over the batch's positions, follow those few elements.

  python -m irp_tpu_torch.tools.step_conditioning            # the card
  python -m irp_tpu_torch.tools.step_conditioning --cpu --image-size 64
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import torch
import torch.nn.functional as F

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.models.classifier import get_classifier, init_classifier
from irp_tpu_torch.train.loop import set_mode
from irp_tpu_torch.train.step import StepConfig, loss_and_grads


@contextlib.contextmanager
def relu_masks(masks: list, record: bool):
    """``F.relu`` that appends each call's mask to ``masks`` (record) or
    applies ``masks`` in call order instead of its own (on the input's
    device), while the context is open."""
    plain, calls = F.relu, iter(masks)

    def relu(x, inplace=False):
        if record:
            masks.append(x.detach() > 0)
            return plain(x)
        return x * next(calls).to(x.device)

    F.relu = relu
    try:
        yield
    finally:
        F.relu = plain


def _step(cfg, state_dict, x, y, device):
    model = get_classifier(cfg, device=device)
    model.load_state_dict(state_dict)
    set_mode(model, True)
    dtype = getattr(torch, cfg.compute_dtype)
    scfg = StepConfig(intensity="medium", out_size=cfg.image_size,
                      compute_dtype=dtype, dropout_rate=0.0)
    loss, _ = loss_and_grads(model, x.to(dtype), y, scfg)
    return float(loss), {n: p.grad.double() for n, p in
                         model.named_parameters() if p.requires_grad}


def _gap(got, want) -> dict:
    def group(names):
        scale = max(float(want[1][n].abs().max()) for n in names)
        return max(float((got[1][n] - want[1][n]).abs().max())
                   for n in names) / max(scale, 1e-300)

    names = list(want[1])
    return {"loss_rel": abs(got[0] - want[0]) / abs(want[0]),
            "layer4": group([n for n in names if "layer4" in n]),
            "head": group([n for n in names if n.startswith("classifier")])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    f32 = ModelConfig(depth=args.depth, num_classes=10,
                      image_size=args.image_size, hidden_dim=512,
                      compute_dtype="float32", precision="highest",
                      fused_frozen_blocks="off")
    f64 = dataclasses.replace(f32, compute_dtype="float64")
    gen = torch.Generator().manual_seed(args.seed)
    state_dict = init_classifier(f32, gen, device="cpu").state_dict()
    small = torch.rand(args.batch, 3, 8, 8, generator=gen)
    x = F.interpolate(small, size=(args.image_size,) * 2, mode="bilinear",
                      align_corners=False)
    x = ((x + 0.1 * torch.randn(x.shape, generator=gen) - 0.45) / 0.25)
    x = x.permute(0, 2, 3, 1).contiguous().to(device)
    y = torch.randint(0, 10, (args.batch,), generator=gen).to(device)
    masks: list = []
    with relu_masks(masks, record=True):
        step32 = _step(f32, state_dict, x, y, device)
    free_masks: list = []
    with relu_masks(free_masks, record=True):
        step64 = _step(f64, state_dict, x, y, device)
    with relu_masks(masks, record=False):
        held = _step(f64, state_dict, x, y, device)
    flips = sum(int((a != b).sum()) for a, b in zip(masks, free_masks))
    out = {"device": str(device), "depth": args.depth,
           "image_size": args.image_size, "batch": args.batch,
           "seed": args.seed,
           "f32_vs_f64": _gap(step32, step64),
           "f32_vs_f64_on_f32_masks": _gap(step32, held),
           "relu_elements": sum(m.numel() for m in masks),
           "relu_elements_masked_differently": flips}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
