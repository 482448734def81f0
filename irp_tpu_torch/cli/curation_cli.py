#!/usr/bin/env python
"""CLI for the offline data-curation workflow of the PyTorch port.

ingest -> analyze -> clean -> (optional) embedding outlier removal on the
card -> 224x224 WebDataset shards -> verify; the stages and flags of the
JAX package's curation CLI.

Usage:
  python -m irp_tpu_torch.cli.curation_cli --kaggle-path ~/animals10 \\
      --work-dir ./data
  python -m irp_tpu_torch.cli.curation_cli --work-dir ./data \\
      --skip-ingest --outliers            # --cpu to run on the CPU
"""

from __future__ import annotations

import argparse
import os
import sys


def load_image_dir_cache(info):
    """Decode a {class: [paths]} directory inventory into a CachedDataset.

    Preallocates the uint8 array (1x dataset RAM, not list+np.stack's 2x)
    and decodes one class at a time."""
    import numpy as np

    from irp_tpu_torch.data.pipeline import CachedDataset, decode_blobs

    class_names = sorted(info)
    n_files = sum(len(v) for v in info.values())
    images = np.empty((n_files, 256, 256, 3), np.uint8)
    labels = np.empty(n_files, np.int32)
    paths = []
    w = 0
    for ci, cls in enumerate(class_names):
        blobs = []
        for path in info[cls]:
            with open(path, "rb") as f:
                blobs.append(f.read())
        decode_blobs(blobs, 256, out=images[w:w + len(blobs)])
        labels[w:w + len(blobs)] = ci
        paths.extend(info[cls])
        w += len(blobs)
    return CachedDataset(images=images, labels=labels, keys=paths,
                         class_names=tuple(class_names))


def _outlier_model_config(args):
    """The feature extractor's configuration: the default ModelConfig
    (ResNet50/224, bf16, fused_frozen_blocks='off')."""
    from irp_tpu_torch.config import ModelConfig

    return ModelConfig(pretrained_path=args.pretrained)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--kaggle-path", default=None,
                   help="downloaded Kaggle Animals-10 root (with raw-img/)")
    p.add_argument("--work-dir", default="./data")
    p.add_argument("--skip-ingest", action="store_true")
    p.add_argument("--skip-clean", action="store_true")
    p.add_argument("--outliers", action="store_true",
                   help="run embedding-based outlier removal on the card")
    p.add_argument("--pretrained", default=None,
                   help="resnet .pth for outlier feature extraction")
    p.add_argument("--test-size", type=float, default=0.2)
    p.add_argument("--samples-per-shard", type=int, default=1000)
    p.add_argument("--target-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cpu", action="store_true",
                   help="run the outlier stage on the CPU instead of the "
                        "card")
    args = p.parse_args(argv)

    from irp_tpu_torch.data.curation import (analyze_dataset,
                                             clean_image_dataset,
                                             prepare_animal_dataset,
                                             process_dataset,
                                             verify_webdataset,
                                             write_analysis_report)

    raw = os.path.join(args.work_dir, "raw")
    cleaned = os.path.join(args.work_dir, "cleaned")
    final_src = cleaned
    wds_dir = os.path.join(args.work_dir, "webdataset")

    if not args.skip_ingest:
        if not args.kaggle_path:
            p.error("--kaggle-path required unless --skip-ingest")
        print("== Ingest ==")
        ingest = prepare_animal_dataset(args.kaggle_path, raw)
        if "error" in ingest:
            print(f"Ingest failed: {ingest['error']}", file=sys.stderr)
            return 1

    print("== Analyze ==")
    analysis = analyze_dataset(raw)
    report = write_analysis_report(
        analysis, os.path.join(args.work_dir, "dataset_analysis_report.txt"))
    print(f"Analysis report: {report}")

    if not args.skip_clean:
        print("== Clean ==")
        clean_image_dataset(
            raw, cleaned, analysis=analysis, min_resolution=128,
            report_path=os.path.join(args.work_dir,
                                     "dataset_cleaning_report.txt"))
    else:
        final_src = raw  # no cleaned/ dir exists when cleaning is skipped

    if args.outliers:
        device = "cpu" if args.cpu else "cuda"
        print(f"== Outlier detection ({device}) ==")
        import torch

        from irp_tpu_torch.data.curation import get_dataset_info
        from irp_tpu_torch.data.outliers import (create_clean_dataset,
                                                 create_embeddings,
                                                 create_results_dataframe,
                                                 detect_outliers,
                                                 extract_features,
                                                 plot_outliers, plot_umap,
                                                 print_summary)
        from irp_tpu_torch.models.classifier import init_classifier
        from irp_tpu_torch.models.convert import (load_torch_checkpoint,
                                                  merge_pretrained)

        info = get_dataset_info(final_src)
        cached = load_image_dir_cache(info)
        class_names = list(cached.class_names)
        mcfg = _outlier_model_config(args)
        model = init_classifier(mcfg, torch.Generator().manual_seed(0),
                                device="cpu")
        if args.pretrained:
            merge_pretrained(model, load_torch_checkpoint(args.pretrained))
        # uploads the dataset once when it fits in free device memory
        # (Animals-10 at 256^2 is 5.1 GB), else streams it batch by batch
        feats, labels_arr, keys = extract_features(
            cached, mcfg, state_dict=model.state_dict(), verbose=True,
            device=device)
        emb, _ = create_embeddings(feats, labels_arr, verbose=True,
                                   device=device)
        cmask, gmask, _ = detect_outliers(emb, labels_arr, device=device)
        df = create_results_dataframe(emb, labels_arr, class_names, keys,
                                      cmask, gmask)
        df["path"] = keys
        plot_umap(df, os.path.join(args.work_dir, "umap.png"))
        plot_outliers(df, os.path.join(args.work_dir, "outliers.png"))
        print_summary(df)
        outlier_src = final_src
        final_src = os.path.join(args.work_dir, "clean")
        create_clean_dataset(df, outlier_src, final_src)

    print("== Shard creation ==")
    result = process_dataset(final_src, wds_dir, test_size=args.test_size,
                             samples_per_shard=args.samples_per_shard,
                             target_size=args.target_size, seed=args.seed)
    print("== Verify ==")
    verify_webdataset(os.path.join(wds_dir, "train-*.tar"),
                      target_size=args.target_size)
    verify_webdataset(os.path.join(wds_dir, "test-*.tar"),
                      target_size=args.target_size)
    print(f"Done: {result['n_train']} train / {result['n_test']} test "
          f"samples in {wds_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
