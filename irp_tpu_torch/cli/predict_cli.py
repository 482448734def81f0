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

  # Grad-CAM overlays beside the CSV (--images mode)
  python -m irp_tpu_torch.cli.predict_cli --weights final_model.npz \\
      --images './photos' --gradcam cams/

  # export the forward (and the Grad-CAM program) as one .irpx, which
  # --weights of this CLI and of serve_cli then take
  python -m irp_tpu_torch.cli.predict_cli --weights final_model.npz \\
      --export model.irpx --batch-size 64 --export-batch-buckets auto

The forward is the JAX package's unfused one; ``--fused-frozen-blocks
auto`` routes ResNet50's frozen identity bottlenecks through the fused
CUDA kernel on the card.  ``--decoder auto`` (the default) decodes JPEGs
with the native batch decoder where it builds (``data/jpeg.py``).

``--data-parallel`` splits each batch over every local card (a local
mesh, ``parallel/mesh.py``); on one card it scores as without it.  It
cannot go with ``--export``, which bakes a one-device program.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
import time


def _collect_image_paths(pattern: str):
    if os.path.isdir(pattern):
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")
        return sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(pattern)
            for f in files if f.lower().endswith(exts))
    return sorted(glob.glob(pattern, recursive=True))


def _explain_paths(predictor, paths, out_dir: str, decoder: str):
    """Score ``paths`` and write one Grad-CAM overlay PNG per image to
    ``out_dir``, in chunks as ``predict_paths`` reads them.  The CSV's
    scores come from the explain pass's own logits, so each overlay
    explains the class reported; a TTA predictor's scores come from its
    flip-averaged forward and its overlays are pinned to that class."""
    import numpy as np
    from PIL import Image

    from irp_tpu_torch.explain import GradCAM, center_crop_u8, overlay_cam
    from irp_tpu_torch.infer import PredictionResult, softmax_np

    os.makedirs(out_dir, exist_ok=True)
    gradcam = GradCAM(predictor)
    crop = predictor.model.config.image_size
    chunk = predictor._chunk()
    parts = []
    for start in range(0, len(paths), chunk):
        part = paths[start:start + chunk]
        decoded = predictor.decode_paths(part, decoder=decoder)
        if predictor.tta:
            probs = predictor.predict_probs(decoded)
            cams, _ = gradcam.explain(
                decoded, class_idx=np.argmax(probs, axis=1).astype(np.int32))
        else:
            cams, logits = gradcam.explain(decoded)
            probs = softmax_np(logits)
        parts.append(probs)
        cropped = center_crop_u8(decoded, crop)
        for j, key in enumerate(part):
            # an index prefix: two source folders may share a basename
            name = os.path.splitext(os.path.basename(key))[0]
            Image.fromarray(overlay_cam(cropped[j], cams[j])).save(
                os.path.join(out_dir, f"{start + j:04d}_{name}_gradcam.png"))
    probs = np.concatenate(parts, axis=0)
    return PredictionResult(labels=np.argmax(probs, axis=1).astype(np.int32),
                            probs=probs, class_names=predictor.class_names,
                            keys=list(paths))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", required=True,
                   help="final-weights artifact (.npz or torch .pth), or "
                        "an .irpx from --export")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--images", help="image file glob or directory")
    src.add_argument("--shards", help="WebDataset shard glob")
    p.add_argument("--export", default=None, metavar="PATH.irpx",
                   help="instead of scoring: export the forward "
                        "(torch.export, irp_tpu_torch/export.py) with the "
                        "weights and metadata as one .irpx, which --weights "
                        "here and in serve_cli take; traced on the device "
                        "this run uses")
    p.add_argument("--export-source-size", type=int, default=None,
                   help="input geometry the exported programs accept "
                        "(default: the 256 cache contract, or the eval "
                        "crop if larger)")
    p.add_argument("--export-batch-buckets", default=None, metavar="SPEC",
                   help="export a padded-batch ladder ('auto' = 1,2,4,..., "
                        "batch-size, or a comma list ending at batch-size): "
                        "one program per rung, so that serve_cli scores a "
                        "lone request with the batch-1 program")
    p.add_argument("--export-no-gradcam", action="store_true",
                   help="leave the Grad-CAM program out of the artifact "
                        "(/explain and --gradcam then need the .npz/.pth)")
    p.add_argument("--classes", default=None,
                   help="class names: JSON file or comma-separated list")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--image-size", type=int, default=None,
                   help="eval crop size; default = the npz artifact's "
                        "embedded training-time value, else 224")
    p.add_argument("--topk", type=int, default=1)
    p.add_argument("--out", default=None, help="CSV output path")
    p.add_argument("--gradcam", default=None, metavar="DIR",
                   help="write Grad-CAM overlay PNGs (the regions that "
                        "drove each prediction, irp_tpu_torch/explain.py) "
                        "to DIR; --images mode only")
    p.add_argument("--decoder", choices=["auto", "pil"], default="auto",
                   help="auto = the native batch JPEG decoder "
                        "(irp_tpu_torch/data/jpeg.py) with PIL for "
                        "non-JPEGs and its misses, pil = PIL only")
    p.add_argument("--data-parallel", action="store_true",
                   help="split each batch over every local card (on one "
                        "card the same as without it)")
    p.add_argument("--tta", action="store_true",
                   help="test-time augmentation: average the softmax over "
                        "the identity and the horizontal flip")
    p.add_argument("--fused-frozen-blocks", choices=["auto", "on", "off"],
                   default="off",
                   help="route the frozen identity bottlenecks through the "
                        "fused CUDA kernel: auto = on the card when "
                        "eligible, on = forced, off = never (the default, "
                        "the JAX package's unfused forward)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    args = p.parse_args(argv)

    # argument checks, before the weights are loaded
    is_irpx = args.weights.lower().endswith(".irpx")
    if not args.export and not (args.images or args.shards):
        print("error: one of --images / --shards is required "
              "(or --export)", file=sys.stderr)
        return 2
    if args.export and (args.images or args.shards or args.gradcam):
        print("error: --export is a standalone mode", file=sys.stderr)
        return 2
    if args.export and args.data_parallel:
        print("error: --export bakes a single-device program; "
              "drop --data-parallel", file=sys.stderr)
        return 2
    if args.gradcam and not args.images:
        print("error: --gradcam requires --images mode", file=sys.stderr)
        return 2
    for flag, value in (("--export-batch-buckets", args.export_batch_buckets),
                        ("--export-source-size", args.export_source_size),
                        ("--export-no-gradcam", args.export_no_gradcam)):
        if value and not args.export:
            print(f"error: {flag} needs --export", file=sys.stderr)
            return 2
    if args.export and is_irpx:
        print("error: --weights is already an exported artifact; export "
              "from the .npz/.pth weights", file=sys.stderr)
        return 2

    import numpy as np

    from irp_tpu_torch.infer import (load_class_names, load_predictor,
                                     serving_buckets)

    export_buckets = None
    if args.export_batch_buckets:
        try:
            export_buckets = serving_buckets(args.export_batch_buckets,
                                             args.batch_size)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.tta and is_irpx:
        # a bake-time property: a no-op when the artifact flip-averages,
        # an error when it does not
        from irp_tpu_torch.export import tta_preflight_error

        err = tta_preflight_error(args.weights, "--tta --export")
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
    class_names = load_class_names(args.classes) if args.classes else None
    try:
        mesh = None
        if args.data_parallel:
            from irp_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(devices=["cpu"] if args.cpu else None)
        predictor = load_predictor(
            args.weights, class_names=class_names,
            batch_size=args.batch_size, image_size=args.image_size,
            pad_buckets=export_buckets, tta=args.tta,
            device="cpu" if args.cpu else None, mesh=mesh,
            fused_frozen_blocks=args.fused_frozen_blocks)
    except (ValueError, OSError) as e:  # wrong-length --classes, bad
        # format, a missing file, ...
        print(f"error: {e}", file=sys.stderr)
        return 2
    if predictor.exported:  # shapes are baked
        if args.batch_size != predictor.batch_size:
            print(f"note: the artifact fixes batch_size="
                  f"{predictor.batch_size}; --batch-size {args.batch_size} "
                  "is ignored", file=sys.stderr)
        if args.image_size is not None:
            print("note: the artifact's crop is "
                  f"{predictor.model.config.image_size}; --image-size is "
                  "ignored", file=sys.stderr)
        if predictor.source_size != 256:
            print(f"error: this artifact accepts only "
                  f"{predictor.source_size}x{predictor.source_size} "
                  "sources, but --images/--shards decode to 256x256; use "
                  "the Python API or re-export with the default source "
                  "size", file=sys.stderr)
            return 2
        if args.gradcam and predictor._cam_call is None:
            print("error: this artifact carries no Grad-CAM program; "
                  "re-export without --export-no-gradcam, or point "
                  "--weights at the .npz/.pth artifact", file=sys.stderr)
            return 2

    if args.export:
        from irp_tpu_torch.export import export_predictor, read_export_meta

        out = export_predictor(predictor, args.export,
                               source_size=args.export_source_size,
                               gradcam=not args.export_no_gradcam)
        meta = read_export_meta(out)
        if meta["source_size"] != 256:
            print(f"note: this artifact accepts only {meta['source_size']}"
                  f"x{meta['source_size']} sources; the CLIs decode to the "
                  "256 cache contract, so it serves only through the Python "
                  "API (Predictor.predict_probs)", file=sys.stderr)
        print(json.dumps({
            "exported": out, "bytes": os.path.getsize(out),
            "batch_size": predictor.batch_size,
            "source_size": meta["source_size"],
            "pad_buckets": meta["pad_buckets"],
            "gradcam_batch_size": meta["gradcam_batch_size"],
            "fused_frozen_blocks": meta["fused_frozen_blocks"],
            "export_seconds": meta["export_seconds"],
            "num_classes": predictor.num_classes}))
        return 0

    from irp_tpu_torch.data.jpeg import prepare

    why = prepare(args.decoder)  # build the decoder outside the timing
    if why:
        print(f"note: the native JPEG decoder is unavailable, decoding "
              f"with PIL: {why}", file=sys.stderr)
    truth = None
    t0 = time.perf_counter()
    if args.images:
        paths = _collect_image_paths(args.images)
        if not paths:
            print(f"error: no images match {args.images}", file=sys.stderr)
            return 2
        if args.gradcam:
            result = _explain_paths(predictor, paths, args.gradcam,
                                    args.decoder)
            print(f"wrote {len(result)} Grad-CAM overlays to "
                  f"{args.gradcam}")
        else:
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
