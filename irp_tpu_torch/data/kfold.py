"""Stratified shard-level k-fold splitting (the JAX package's
``data/kfold.py``).

Per-shard class histograms, a shuffle of the shard list by Python's
``random.Random(seed)``, then each shard goes to the fold with the fewest
samples so far.  The same draw as the JAX package's, so both packages
give the same folds shard for shard.  Folds are unions of shards, never
split samples of one shard.
"""

from __future__ import annotations

import collections
import random
from typing import Dict, List, Sequence

from irp_tpu_torch.data.tar import iter_shard


def shard_class_histogram(shard_path: str) -> collections.Counter:
    """Samples per class name in one shard."""
    counts: collections.Counter = collections.Counter()
    for sample in iter_shard(shard_path):
        cls = sample.get("cls")
        if cls is None:
            continue
        name = cls.decode("utf-8") if isinstance(cls, bytes) else cls
        counts[name] += 1
    return counts


def create_stratified_kfolds(
    shard_paths: Sequence[str],
    k: int = 5,
    seed: int = 42,
    verbose: bool = False,
    histograms: Dict[str, collections.Counter] | None = None,
) -> List[List[str]]:
    """Partition shards into k folds balancing their sample counts.

    ``histograms`` (shard -> class Counter) skips reading every shard
    again; the sweep computes them once from the decode cache."""
    if histograms is None:
        histograms = {p: shard_class_histogram(p) for p in shard_paths}

    order = list(shard_paths)
    rng = random.Random(seed)
    rng.shuffle(order)

    folds: List[List[str]] = [[] for _ in range(k)]
    fold_totals = [0] * k
    fold_class_counts = [collections.Counter() for _ in range(k)]

    for shard in order:
        idx = min(range(k), key=lambda i: fold_totals[i])
        folds[idx].append(shard)
        hist = histograms.get(shard, collections.Counter())
        fold_totals[idx] += sum(hist.values())
        fold_class_counts[idx].update(hist)

    if verbose:
        print(f"Created {k} folds:")
        for i, (fold, counts) in enumerate(zip(folds, fold_class_counts)):
            total = sum(counts.values())
            print(f"Fold {i + 1}: {len(fold)} shards, {total} samples")
            for cls, c in counts.most_common():
                print(f"  {cls}: {c} ({100.0 * c / max(total, 1):.2f}%)")

    return folds
