#!/usr/bin/env python
"""Batch prediction CLI of the PyTorch port, with the JAX package's
arguments (run_predict.py): load a final-weights artifact (.npz or torch
.pth, written by either package) and score image files or WebDataset
shards on the CUDA device (``--cpu`` for the CPU).

  # score a directory of images, top-3 per image, CSV out
  python -m irp_tpu_torch.cli.predict_cli --weights final_model.npz \\
      --images './photos/**/*.jpg' --classes classes.json \\
      --topk 3 --out preds.csv

  # bulk re-score a shard set (prints accuracy when shards carry labels:
  # integer labels, or class names with --classes)
  python -m irp_tpu_torch.cli.predict_cli --weights final_model.npz \\
      --shards './data/webdataset/test-*.tar'

``--export``/``--export-*`` and ``--gradcam`` (ROADMAP A11) and
``--data-parallel`` (ROADMAP A14) are not ported yet: each exits 2
before any weights are loaded.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
import time

# flags of the JAX CLI that wait for a later item of the port
_WAITING = (("export", "--export", "A11: export"),
            ("export_source_size", "--export-source-size", "A11: export"),
            ("export_batch_buckets", "--export-batch-buckets",
             "A11: export"),
            ("export_no_gradcam", "--export-no-gradcam", "A11: export"),
            ("gradcam", "--gradcam", "A11: Grad-CAM"),
            ("data_parallel", "--data-parallel", "A14: parallelism"))


def _collect_image_paths(pattern: str):
    if os.path.isdir(pattern):
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")
        return sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(pattern)
            for f in files if f.lower().endswith(exts))
    return sorted(glob.glob(pattern, recursive=True))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", required=True,
                   help="final-weights artifact (.npz or torch .pth)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--images", help="image file glob or directory")
    src.add_argument("--shards", help="WebDataset shard glob")
    p.add_argument("--export", default=None, metavar="PATH.irpx",
                   help="not ported yet (ROADMAP A11)")
    p.add_argument("--export-source-size", type=int, default=None,
                   help="not ported yet (ROADMAP A11)")
    p.add_argument("--export-batch-buckets", default=None, metavar="SPEC",
                   help="not ported yet (ROADMAP A11)")
    p.add_argument("--export-no-gradcam", action="store_true",
                   help="not ported yet (ROADMAP A11)")
    p.add_argument("--classes", default=None,
                   help="class names: JSON file or comma-separated list")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--image-size", type=int, default=None,
                   help="eval crop size; default = the npz artifact's "
                        "embedded training-time value, else 224")
    p.add_argument("--topk", type=int, default=1)
    p.add_argument("--out", default=None, help="CSV output path")
    p.add_argument("--gradcam", default=None, metavar="DIR",
                   help="not ported yet (ROADMAP A11)")
    p.add_argument("--decoder", choices=["auto", "pil"], default="auto",
                   help="both decode with PIL (the native decoder is not "
                        "ported yet)")
    p.add_argument("--data-parallel", action="store_true",
                   help="not ported yet (ROADMAP A14)")
    p.add_argument("--tta", action="store_true",
                   help="test-time augmentation: average the softmax over "
                        "the identity and the horizontal flip")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    args = p.parse_args(argv)

    # argument checks, before the weights are loaded
    for attr, flag, item in _WAITING:
        if getattr(args, attr):
            print(f"error: {flag} is not ported to irp_tpu_torch yet "
                  f"(ROADMAP.md, Queue 1, {item})", file=sys.stderr)
            return 2
    if args.weights.lower().endswith(".irpx"):
        print("error: .irpx artifacts are not ported to irp_tpu_torch yet "
              "(ROADMAP.md, Queue 1, A11: export)", file=sys.stderr)
        return 2
    if not (args.images or args.shards):
        print("error: one of --images / --shards is required",
              file=sys.stderr)
        return 2

    import numpy as np

    from irp_tpu_torch.infer import load_class_names, load_predictor

    class_names = load_class_names(args.classes) if args.classes else None
    try:
        predictor = load_predictor(args.weights, class_names=class_names,
                                   batch_size=args.batch_size,
                                   image_size=args.image_size, tta=args.tta,
                                   device="cpu" if args.cpu else None)
    except ValueError as e:  # wrong-length --classes, bad format, ...
        print(f"error: {e}", file=sys.stderr)
        return 2

    truth = None
    t0 = time.perf_counter()
    if args.images:
        paths = _collect_image_paths(args.images)
        if not paths:
            print(f"error: no images match {args.images}", file=sys.stderr)
            return 2
        result = predictor.predict_paths(paths, decoder=args.decoder)
    else:
        result, truth = predictor.predict_shards(args.shards,
                                                 decoder=args.decoder)
        if len(result) == 0:
            print(f"error: no samples in {args.shards}", file=sys.stderr)
            return 2
    elapsed = time.perf_counter() - t0

    k = min(max(1, args.topk), predictor.num_classes)
    top_idx, top_prob = result.topk(k)
    names = (result.class_names if result.class_names is not None
             else [str(i) for i in range(predictor.num_classes)])

    rows = []
    for i, key in enumerate(result.keys or range(len(result))):
        row = {"key": key, "label": int(result.labels[i]),
               "label_name": names[result.labels[i]],
               "prob": f"{result.probs[i, result.labels[i]]:.6f}"}
        for j in range(k):
            row[f"top{j + 1}"] = names[top_idx[i, j]]
            row[f"top{j + 1}_prob"] = f"{top_prob[i, j]:.6f}"
        rows.append(row)

    if args.out:
        with open(args.out, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {len(rows)} predictions to {args.out}")
    else:
        for row in rows[:20]:
            print(f"{row['key']}: {row['label_name']} ({row['prob']})")
        if len(rows) > 20:
            print(f"... {len(rows) - 20} more (use --out for the full set)")

    summary = {"n": len(rows), "elapsed_s": round(elapsed, 3),
               "imgs_per_sec": round(len(rows) / max(elapsed, 1e-9), 1)}
    if truth is not None:
        summary["accuracy"] = round(
            float(np.mean(result.labels == truth)), 4)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
