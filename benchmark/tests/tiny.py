"""A tiny copy of the benchmark, made from files alone, that runs on the
CPU in seconds: the same harness, loops, readers and reference, with
configurations, traffic and limits of its own."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import harness

RESNET = {"family": "resnet", "depth": 50, "num_classes": 10,
          "image_size": 32, "hidden_dim": 16, "dropout_rate": 0.3,
          "trainable_stages": ["layer4"], "bn_stats_mode": "trainable_only",
          "compute_dtype": "float32", "precision": "default",
          "fused_frozen_blocks": "auto"}
VIT = {"family": "vit", "patch_size": 8, "embed_dim": 64, "num_layers": 2,
       "num_heads": 2, "mlp_dim": 128, "num_classes": 10, "image_size": 32,
       "hidden_dim": 16, "dropout_rate": 0.3,
       "trainable_stages": ["block1", "ln"], "compute_dtype": "float32",
       "precision": "default", "fused_frozen_blocks": "auto"}
TRAIN = {"kind": "train", "images": 64, "source_px": 40,
         "class_counts": [10, 9, 8, 7, 6, 6, 5, 5, 4, 4], "batch_size": 8,
         "intensity": "medium", "optimizer": "adam", "schedule": "onecycle",
         "learning_rate": 0.001, "weight_decay": 0.0001,
         "nominal_epochs": 15, "checked_steps": 3, "traced_steps": 2}
# limits at float32 on both sides
TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "grad_diff": 1e-2,
                "update_gap": 5e-2, "bn_stats_gap": 5e-2}


def make_tree(dest: str) -> str:
    """A checkout root under ``dest``: the benchmark's folder copied, its
    cells and BENCHMARK.json replaced by tiny ones.  Returns the root."""
    root = os.path.join(dest, "root")
    bench = os.path.join(root, "benchmark")
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for sub in ("configs", "traffic", "limits"):
        shutil.rmtree(os.path.join(bench, sub))
        os.makedirs(os.path.join(bench, sub))

    def put(sub, name, obj):
        with open(os.path.join(bench, sub, f"{name}.json"), "w") as f:
            json.dump(obj, f)

    put("configs", "tiny_resnet", {"model": RESNET, "source_px": 40})
    put("configs", "tiny_vit", {"model": VIT, "source_px": 40})
    put("traffic", "train.tiny", TRAIN)
    cells = [("tiny_resnet.train", "tiny_resnet", "train.tiny"),
             ("tiny_vit.train", "tiny_vit", "train.tiny")]
    for name, config, traffic in cells:
        limits = dict(TRAIN_LIMITS)
        if config == "tiny_vit":  # no BatchNorm
            del limits["bn_stats_gap"]
        put("limits", name, limits)
    with open(os.path.join(harness.BENCH_DIR, os.pardir,
                           "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"] = [
        {"name": c, "source": "tiny", "file": f"benchmark/configs/{c}.json",
         "reduced": [], "why": "CPU test"} for c in ("tiny_resnet",
                                                     "tiny_vit")]
    manifest["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "CPU test"}
        for n, c, t in cells]
    rename = {"resnet50.train.b256": "tiny_resnet.train",
              "vit_b16.train.b256": "tiny_vit.train"}
    for section in ("end_to_end", "per_layer"):
        for m in manifest[section]:
            if "workloads" in m:
                m["workloads"] = [rename[w] for w in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


def run(root: str, cell: str, seed: int = 2**31 + 7, seconds: float = 1.0,
        trace: bool = False) -> dict:
    return harness.run(harness.load_cell(cell, seed, seconds, trace, "cpu",
                                         root))
