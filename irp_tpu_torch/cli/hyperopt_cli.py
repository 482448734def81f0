#!/usr/bin/env python
"""CLI for the k-fold hyperopt sweep of the PyTorch port, with the JAX
package's arguments (run_hyperopt.py): set up tracking, analyze the
shards into the dataset info, decode the cache once, and run the study
(200 trials x 3 folds, first-fold floor 95%, SQLite resume) on the card.

Usage:
  python -m irp_tpu_torch.cli.hyperopt_cli --data-dir ./data/webdataset
      [--n-trials 200] [--k-folds 3] [--storage optuna_animals10_kfold.db]
      [--quick] [--cpu] [--parallel-workers N]

--parallel-workers N runs up to N trials at once, one per local CUDA
device (with --cpu, N workers on the CPU).
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
    p.add_argument("--n-trials", type=int, default=200)
    p.add_argument("--k-folds", type=int, default=3)
    p.add_argument("--first-fold-min-acc", type=float, default=None,
                   help="tier-2 pruning floor (default 95.0; --quick "
                        "drops it to 0 so smoke trials can complete)")
    p.add_argument("--storage", default="optuna_animals10_kfold.db")
    p.add_argument("--study-name", default="animals10_kfold")
    p.add_argument("--experiment", default="animals10")
    p.add_argument("--cache-dir", default="./data/cache")
    p.add_argument("--pretrained", default=None,
                   help="torchvision-layout .pth of the --family "
                        "model (e.g. resnet50, vit_b_16) to initialize "
                        "from")
    p.add_argument("--seed", type=int, default=42)
    add_model_family_args(p)
    add_train_recipe_args(p)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--quick", action="store_true",
                   help="smoke-test space: 2 epochs, bs 16, low aug")
    p.add_argument("--pruner", choices=("median", "asha", "none"),
                   default="median",
                   help="tier-1 pruner: 'median', 'asha' (async "
                        "successive halving) or 'none'")
    p.add_argument("--asha-min-resource", type=int, default=1,
                   help="ASHA first-rung resource in epochs")
    p.add_argument("--asha-reduction-factor", type=int, default=3,
                   help="ASHA keep-top-1/N factor per rung")
    p.add_argument("--parallel-workers", type=int, default=None,
                   help="run up to this many trials concurrently, one "
                        "worker per local CUDA device (--cpu: the CPU for "
                        "each; default: sequential)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--search-optimizer", action="store_true",
                   help="add the optimizer family (adam/adamw/sgd) as an "
                        "8th categorical search dimension")
    p.add_argument("--no-hbm-pool", action="store_true",
                   help="upload each fold per fit instead of keeping one "
                        "device-resident pool of the train cache")
    args = p.parse_args(argv)

    from irp_tpu_torch import tracking
    from irp_tpu_torch._kernels import resolve_device
    from irp_tpu_torch.config import HyperoptConfig
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.pipeline import build_cache
    from irp_tpu_torch.hyperopt.objective import (HyperoptContext,
                                                  quick_space, suggest_space)
    from irp_tpu_torch.hyperopt.runner import run_kfold_optimization

    device = resolve_device("cpu" if args.cpu else None)
    tracking.set_experiment(args.experiment)

    train_shards = sorted(glob.glob(os.path.join(args.data_dir,
                                                 "train-*.tar")))
    if not train_shards:
        print(f"No train shards found in {args.data_dir}", file=sys.stderr)
        return 1
    print(f"Found {len(train_shards)} training shards")

    info = analyze_webdataset(train_shards, verbose=True)
    cached = build_cache(train_shards, info.class_names,
                         cache_dir=args.cache_dir)
    print(f"Decoded cache ready: {len(cached)} samples")

    if args.first_fold_min_acc is None:
        # 2-epoch --quick trials essentially never clear the 95% floor
        args.first_fold_min_acc = 0.0 if args.quick else 95.0
    hcfg = HyperoptConfig(
        n_trials=args.n_trials, k_folds=args.k_folds,
        first_fold_min_acc=args.first_fold_min_acc,
        pruner=args.pruner, asha_min_resource=args.asha_min_resource,
        asha_reduction_factor=args.asha_reduction_factor,
        storage=args.storage, study_name=args.study_name, seed=args.seed)
    model_base = build_model_base(args, info.num_classes)

    space_fn = quick_space if args.quick else None
    if args.search_optimizer:
        base_space = space_fn or suggest_space

        def space_fn(trial, _base=base_space):
            hp = _base(trial)
            # a TrainConfig-named dimension flows into each trial's config
            hp["optimizer"] = trial.suggest_categorical(
                "optimizer", ["adam", "adamw", "sgd"])
            return hp

    ctx = HyperoptContext(cached=cached, info=info, hcfg=hcfg,
                          model_base=model_base,
                          train_base=build_train_base(args), device=device,
                          space_fn=space_fn,
                          reuse_hbm_pool=not args.no_hbm_pool)
    workers = args.parallel_workers
    run_kfold_optimization(
        ctx, n_trials=args.n_trials, verbose=True, parallel_workers=workers,
        # torch has one CPU device: each CPU worker takes it
        devices=([device] * workers if workers and device.type == "cpu"
                 else None))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
