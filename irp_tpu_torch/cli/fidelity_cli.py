#!/usr/bin/env python
"""Eval-output fidelity harness of the PyTorch port (the JAX package's
``cli/fidelity_cli.py``): the port's classifier against a
torchvision-layout PyTorch executor of the SAME weights on the SAME
pixels.

The bar: eval logits within 1e-3 of the reference executor.  Samples of
the given shards are decoded to the 256x256 cache (PIL bilinear, as
``build_cache`` does), center-cropped to 224 and ImageNet-normalized in
float32 (the K2 kernel on the card, ``ops/preprocess.py``), then run
through (a) the port's classifier in float32 with precision 'highest',
the unfused forward, BN in eval form and no dropout, and (b) the
executor of ``models/torch_ref.py`` loaded with the classifier's own
state_dict (torchvision keys), in the same no-TF32 scope.  It prints max
|logit difference| and top-1 agreement, and exits 2 above
``--tolerance`` (1 when no shard matches).

  python -m irp_tpu_torch.cli.fidelity_cli \\
      --shards './data/webdataset/test-*.tar' [--checkpoint final.pth] \\
      [--samples 64] [--family resnet|vit|efficientnet|convnext] \\
      [--depth 50] [--cpu]

Every family runs at the 224 px eval geometry; without ``--checkpoint``
the weights are drawn from seed 0.
"""

from __future__ import annotations

import argparse
import glob
import sys


def reference_executor(cfg):
    """The torchvision-layout executor (``models/torch_ref.py``) of the
    classifier ``cfg`` describes."""
    from irp_tpu_torch.models import torch_ref

    if cfg.family == "vit":
        from irp_tpu_torch.models.vit import resolve_num_heads

        return torch_ref.TorchViTClassifier(
            num_classes=cfg.num_classes, hidden=cfg.hidden_dim,
            patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            num_layers=cfg.num_layers, num_heads=resolve_num_heads(cfg),
            mlp_dim=cfg.mlp_dim, image_size=cfg.image_size)
    if cfg.family == "efficientnet":
        return torch_ref.TorchEfficientNetClassifier(
            num_classes=cfg.num_classes, hidden=cfg.hidden_dim,
            width_mult=cfg.width_mult, depth_mult=cfg.depth_mult,
            stochastic_depth_prob=cfg.stochastic_depth)
    if cfg.family == "convnext":
        return torch_ref.TorchConvNeXtClassifier(
            num_classes=cfg.num_classes, hidden=cfg.hidden_dim,
            dims=tuple(cfg.convnext_dims),
            depths=tuple(cfg.convnext_depths),
            stochastic_depth_prob=cfg.stochastic_depth)
    return torch_ref.TorchAnimalClassifier(
        depth=cfg.depth, num_classes=cfg.num_classes, hidden=cfg.hidden_dim,
        groups=cfg.groups, width_per_group=cfg.width_per_group)


def compare_logits(model, images_u8):
    """(the classifier's logits, the executor's logits, the state_dict
    keys the executor did not take) of ``model`` (eval mode) on a
    (N, 256, 256, 3) uint8 batch, both as float32 numpy arrays."""
    import torch

    from irp_tpu_torch.ops.preprocess import eval_preprocess_batch

    cfg = model.config
    device = next(model.parameters()).device
    ref = reference_executor(cfg)
    missing, unexpected = ref.load_state_dict(
        {k: v.detach().to("cpu", torch.float32)
         for k, v in model.state_dict().items()}, strict=False)
    bad = list(unexpected) + [k for k in missing
                              if "num_batches_tracked" not in k]
    ref = ref.to(device).eval()
    x = eval_preprocess_batch(torch.from_numpy(images_u8).to(device),
                              out_size=cfg.image_size, dtype=torch.float32)
    x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    with torch.inference_mode():
        ours = model(x)
        with model.precision_scope(x):
            theirs = ref(x.contiguous())
    return ours.float().cpu().numpy(), theirs.float().cpu().numpy(), bad


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--shards", required=True)
    p.add_argument("--checkpoint", default=None,
                   help=".pth state_dict (torchvision layout: the port's, "
                        "the JAX package's or the reference's); random "
                        "init from seed 0 if omitted")
    p.add_argument("--samples", type=int, default=64)
    from irp_tpu_torch.cli.model_args import add_model_family_args

    add_model_family_args(p)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from irp_tpu_torch.cli.model_args import model_config_for_family
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.pipeline import build_cache
    from irp_tpu_torch.models.classifier import init_classifier
    from irp_tpu_torch.models.convert import (load_torch_checkpoint,
                                              merge_pretrained)

    shards = sorted(glob.glob(args.shards))
    if not shards:
        print(f"no shards match {args.shards}", file=sys.stderr)
        return 1
    info = analyze_webdataset(shards)
    cached = build_cache(shards, info.class_names)
    n = min(args.samples, len(cached))
    images = np.ascontiguousarray(cached.images[:n])

    # the reference's eval semantics, pinned: BN in eval form over every
    # layer, no dropout, float32 at 'highest' (no TF32), the unfused
    # forward, the 224 px eval geometry
    cfg = model_config_for_family(
        args.family, depth=args.depth, vit_variant=args.vit_variant,
        efficientnet_variant=args.efficientnet_variant,
        convnext_variant=args.convnext_variant,
        num_classes=args.num_classes, dropout_rate=0.0,
        compute_dtype="float32", precision="highest",
        bn_stats_mode="all", image_size=224, fused_frozen_blocks="off")
    model = init_classifier(cfg, torch.Generator().manual_seed(0),
                            device="cpu" if args.cpu else None)
    if args.checkpoint:
        merge_pretrained(model, load_torch_checkpoint(args.checkpoint))
    model.eval()

    ours, theirs, bad = compare_logits(model, images)
    if bad:
        print(f"state_dict mismatch loading the torch reference: {bad}",
              file=sys.stderr)
        return 2
    diff = np.abs(ours - theirs).max()
    agree = float((ours.argmax(1) == theirs.argmax(1)).mean())
    status = "PASS" if diff < args.tolerance else "FAIL"
    print(f"samples: {n}  max |logit diff|: {diff:.2e}  "
          f"top-1 agreement: {100 * agree:.1f}%  "
          f"tolerance: {args.tolerance:g}  -> {status}")
    return 0 if diff < args.tolerance else 2


if __name__ == "__main__":
    raise SystemExit(main())
