#!/usr/bin/env python
"""CLI for final-model training from a completed sweep, with the JAX
package's arguments (run_final.py): load the SQLite study (written by
either package), retrain with the best hyperparameters on ALL train shards
for the study's recommended epoch count, evaluate the whole test set, and
write per-class metrics, the confusion matrix, the prediction galleries,
``final_model.npz`` and ``final_model.pth`` to the tracking store.  Runs
on the CUDA device unless ``--cpu`` is given.

Usage:
  python -m irp_tpu_torch.cli.final_cli --data-dir ./data/webdataset
      [--storage optuna_animals10_kfold.db] [--study-name animals10_kfold]
      [--pretrained resnet50.pth] [--checkpoint-dir ./checkpoints] [--cpu]

Exit codes: 0 done; 1 no study to train from; 2 no train shards, no
study storage, an empty study, or --resume without --checkpoint-dir.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from irp_tpu_torch.cli.model_args import (add_model_family_args,
                                          add_train_recipe_args,
                                          build_model_base, build_train_base)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default="./data/webdataset")
    p.add_argument("--storage", default="optuna_animals10_kfold.db")
    p.add_argument("--study-name", default="animals10_kfold")
    p.add_argument("--experiment", default="animals10")
    p.add_argument("--cache-dir", default="./data/cache")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for per-epoch full-state checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="continue a killed run from the latest checkpoint "
                        "in --checkpoint-dir (the optimizer's moments and "
                        "the schedule's position carry over)")
    p.add_argument("--pretrained", default=None,
                   help="torchvision-layout .pth of the --family "
                        "model (e.g. resnet50, vit_b_16) to initialize "
                        "from")
    add_model_family_args(p)
    add_train_recipe_args(p)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--fit-mode", choices=("hbm", "stream", "auto"),
                   default="hbm",
                   help="dataset residency: 'hbm' on the device (fast "
                        "path), 'stream' host batches (bigger-than-memory "
                        "sets), 'auto' picks by free device memory")
    args = p.parse_args(argv)

    if args.resume and not args.checkpoint_dir:
        print("--resume requires --checkpoint-dir", file=sys.stderr)
        return 2

    from irp_tpu_torch import tracking
    from irp_tpu_torch._kernels import resolve_device
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.pipeline import build_cache
    from irp_tpu_torch.hyperopt import create_study
    from irp_tpu_torch.train.final import train_final_model

    device = resolve_device("cpu" if args.cpu else None)
    train_shards = sorted(glob.glob(os.path.join(args.data_dir,
                                                 "train-*.tar")))
    test_shards = sorted(glob.glob(os.path.join(args.data_dir,
                                                "test-*.tar")))
    if not train_shards:
        print(f"No train shards under {args.data_dir}", file=sys.stderr)
        return 2
    if not os.path.exists(args.storage):
        print(f"No study storage at {args.storage} — run the hyperopt CLI "
              "first", file=sys.stderr)
        return 2

    study = create_study(study_name=args.study_name, storage=args.storage,
                         load_if_exists=True)
    if not study.get_trials():
        print(f"Study '{args.study_name}' has no trials", file=sys.stderr)
        return 2

    tracking.set_experiment(args.experiment)
    info = analyze_webdataset(train_shards, verbose=True)
    train_cached = build_cache(train_shards, info.class_names,
                               cache_dir=args.cache_dir)
    test_cached = build_cache(test_shards, info.class_names,
                              cache_dir=args.cache_dir)

    result = train_final_model(study, train_cached, test_cached, info,
                               model_base=build_model_base(
                                   args, info.num_classes),
                               train_base=build_train_base(args),
                               device=device, mode=args.fit_mode,
                               checkpoint_dir=args.checkpoint_dir,
                               experiment=args.experiment,
                               resume=args.resume)
    if result is None:
        return 1
    print(f"\nFinal test accuracy: {result.test_acc:.2f}%  "
          f"(loss {result.test_loss:.4f}, tracking run {result.run_id})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
