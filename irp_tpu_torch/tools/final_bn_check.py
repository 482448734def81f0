#!/usr/bin/env python
"""Is a final run's test accuracy held back by its weights, or by the BN
running statistics it evaluates with?

For each ``--run EPOCHS,K1,DTYPE`` (K1: ``fused_frozen_blocks``, 'off' or
'auto'; DTYPE: the model's ``compute_dtype``), the final stage's recipe
(``train/final.py::final_configs`` over the study's best trial: seed 42,
the schedule stepped once per epoch, no validation) trains for EPOCHS on
the train shards, without checkpoints or tracking.  The final weights are
then read three ways:

- in eval form, as the final stage evaluates them (each trainable BN
  layer normalizes with its running statistics): test and train
  accuracy, beside the last epoch's train loss and accuracy (augmented,
  batch statistics);
- per trainable BN layer, how far the running statistics sit from the
  statistics recomputed over the whole train set with the final weights
  (center-cropped as evaluation crops, each batch's mean and biased
  variance averaged with equal weight): the largest |mean_run - mean| /
  sqrt(var) and |ln(var_run / var)| over its channels;
- in eval form again after those recomputed statistics replace the
  running ones, the weights unchanged: test accuracy.

Where the first test accuracy is low and the last high, the weights are
sound and the eval form's statistics trail them.  One JSON line per run.

  python -m irp_tpu_torch.tools.final_bn_check --data-dir <shards> \\
      --storage <study.db> --study-name <name> \\
      --run 2,off,bfloat16 --run 2,auto,bfloat16 --run 6,off,bfloat16
  python -m irp_tpu_torch.tools.final_bn_check ... --cpu --depth 18 \\
      --image-size 56

``--data-dir`` holds ``train-*.tar`` and ``test-*.tar`` as for
``cli/final_cli.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch


def _trainable_bns(model) -> dict:
    from irp_tpu_torch.models.resnet import BatchNorm2d

    return {name: m for name, m in model.named_modules()
            if isinstance(m, BatchNorm2d) and not m.frozen}


@torch.no_grad()
def recompute_bn_stats(model, cached, device, batch_size: int,
                       out_size: int, compute_dtype) -> None:
    """Replace every trainable BN layer's running statistics by their mean
    over ``cached``'s full batches (center crop, as evaluation), with the
    model's weights as they are.  Leaves the model in eval form."""
    from irp_tpu_torch.data.pipeline import iter_host_batches
    from irp_tpu_torch.ops.preprocess import eval_preprocess_batch
    from irp_tpu_torch.train.loop import set_mode
    from irp_tpu_torch.train.step import _nchw

    bns = _trainable_bns(model)
    momenta = {name: bn.momentum for name, bn in bns.items()}
    set_mode(model, True)
    try:
        batches = iter_host_batches(cached, batch_size, drop_last=True)
        for k, (images, _, _) in enumerate(batches):
            for bn in bns.values():
                bn.momentum = 1.0 / (k + 1)  # an equal-weight mean
            x = eval_preprocess_batch(torch.from_numpy(images).to(device),
                                      out_size, compute_dtype)
            model(_nchw(x))
    finally:
        for name, bn in bns.items():
            bn.momentum = momenta[name]
        set_mode(model, False)


def _stats_gap(before: dict, model) -> dict:
    """Per trainable BN layer: the running statistics in ``before``
    against the model's (recomputed) ones."""
    gaps = {}
    for name, bn in _trainable_bns(model).items():
        mean0, var0 = before[name]
        var = bn.running_var.double()
        gaps[name] = {
            "mean_in_sd": float(((mean0 - bn.running_mean.double()).abs()
                                 / var.clamp_min(1e-12).sqrt()).max()),
            "abs_log_var_ratio": float((var0.clamp_min(1e-12).log()
                                        - var.clamp_min(1e-12).log())
                                       .abs().max())}
    return gaps


def check_run(study, train_cached, test_cached, info, epochs: int,
              k1: str, dtype: str, device, depth: int = 50,
              image_size: int = 224) -> dict:
    """One final-stage fit of ``epochs``, read as the module docstring
    says."""
    from irp_tpu_torch.config import ModelConfig
    from irp_tpu_torch.train.final import final_configs
    from irp_tpu_torch.train.fit import fit
    from irp_tpu_torch.train.loop import evaluate_full

    model_cfg, train_cfg = final_configs(
        study, info, epochs, ModelConfig(
            depth=depth, image_size=image_size,
            num_classes=info.num_classes, fused_frozen_blocks=k1,
            compute_dtype=dtype))
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    result = fit(train_cached, None, info, model_cfg, train_cfg,
                 mode="hbm", device=device)
    sync()
    fit_s = time.perf_counter() - t0
    model, batch = result.state.model, train_cfg.batch_size
    cw = np.asarray(info.class_weights)

    def accuracy(cached):
        return evaluate_full(model, result.eval_step, cached, result.device,
                             batch_size=batch, class_weights=cw)

    test, train = accuracy(test_cached), accuracy(train_cached)
    before = {name: (bn.running_mean.double().clone(),
                     bn.running_var.double().clone())
              for name, bn in _trainable_bns(model).items()}
    recompute_bn_stats(model, train_cached, result.device, batch,
                       model_cfg.image_size,
                       getattr(torch, model_cfg.compute_dtype))
    recomputed = accuracy(test_cached)
    gaps = _stats_gap(before, model)
    worst = max(gaps, key=lambda n: gaps[n]["abs_log_var_ratio"])
    return {"epochs": epochs, "fused_frozen_blocks": k1, "dtype": dtype,
            "fit_s": fit_s,
            "last_epoch_train_loss": result.history["train_loss"][-1],
            "last_epoch_train_acc": result.history["train_acc"][-1],
            "train_loss": result.history["train_loss"],
            "test_acc": test.accuracy, "test_loss": test.loss,
            "train_acc_eval_form": train.accuracy,
            "test_acc_recomputed_bn": recomputed.accuracy,
            "test_loss_recomputed_bn": recomputed.loss,
            "bn_layers": len(gaps),
            "max_abs_log_var_ratio": gaps[worst]["abs_log_var_ratio"],
            "max_mean_in_sd": max(g["mean_in_sd"] for g in gaps.values()),
            "worst_layer": worst}


def _run_spec(text: str) -> tuple:
    epochs, k1, dtype = text.split(",")
    if k1 not in ("off", "auto") or dtype not in ("bfloat16", "float32"):
        raise argparse.ArgumentTypeError(
            f"--run EPOCHS,off|auto,bfloat16|float32, got {text!r}")
    return int(epochs), k1, dtype


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--storage", required=True)
    ap.add_argument("--study-name", required=True)
    ap.add_argument("--cache-dir", default="./data/cache")
    ap.add_argument("--run", type=_run_spec, action="append",
                    help="EPOCHS,K1,DTYPE, repeatable (default "
                    "2,off,bfloat16)")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from irp_tpu_torch._kernels import resolve_device
    from irp_tpu_torch.data.analyze import analyze_webdataset
    from irp_tpu_torch.data.pipeline import build_cache
    from irp_tpu_torch.hyperopt.study import create_study

    device = resolve_device("cpu" if args.cpu else None)
    train_shards = sorted(glob.glob(os.path.join(args.data_dir,
                                                 "train-*.tar")))
    test_shards = sorted(glob.glob(os.path.join(args.data_dir,
                                                "test-*.tar")))
    info = analyze_webdataset(train_shards)
    train = build_cache(train_shards, info.class_names,
                        cache_dir=args.cache_dir)
    test = build_cache(test_shards, info.class_names,
                       cache_dir=args.cache_dir)
    study = create_study(args.study_name, args.storage, load_if_exists=True)
    rows = []
    for epochs, k1, dtype in args.run or [(2, "off", "bfloat16")]:
        row = check_run(study, train, test, info, epochs, k1, dtype, device,
                        args.depth, args.image_size)
        print(json.dumps({"final_bn_check": row}), flush=True)
        rows.append(row)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
