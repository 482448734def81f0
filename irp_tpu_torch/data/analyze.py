"""Shard analysis: the class inventory, the label mapping and the class
weights (the JAX package's ``data/analyze.py``).

One pass over the train shards counts the ``cls`` field.  Class names are
ordered most common first, ties in first-seen order
(``Counter.most_common``); that order is the label <-> index mapping.
Class weights are inverse-frequency ``n / (k * count)``.
"""

from __future__ import annotations

import collections
import glob
import os
from typing import Sequence

from irp_tpu_torch.config import DatasetInfo
from irp_tpu_torch.data.tar import iter_samples


def resolve_shards(path_pattern: str | Sequence[str]) -> list:
    """A glob, a directory or a list of shards as a sorted list of paths.
    A directory means its ``train-*.tar`` shards, else any ``*.tar``."""
    if isinstance(path_pattern, (list, tuple)):
        return list(path_pattern)
    if os.path.isdir(path_pattern):
        train = sorted(glob.glob(os.path.join(path_pattern, "train-*.tar")))
        return train or sorted(glob.glob(os.path.join(path_pattern,
                                                      "*.tar")))
    return sorted(glob.glob(path_pattern))


def analyze_webdataset(path_pattern: str | Sequence[str],
                       verbose: bool = False) -> DatasetInfo:
    """Count classes across the shards and derive the DatasetInfo."""
    shard_files = resolve_shards(path_pattern)
    if not shard_files:
        raise ValueError(f"No WebDataset shards found at {path_pattern}")

    class_counts: collections.Counter = collections.Counter()
    total = 0
    for sample in iter_samples(shard_files):
        cls = sample.get("cls")
        if cls is None:
            continue
        name = cls.decode("utf-8") if isinstance(cls, bytes) else cls
        class_counts[name] += 1
        total += 1

    ordered = class_counts.most_common()
    class_names = tuple(name for name, _ in ordered)
    counts = tuple(count for _, count in ordered)
    k = len(class_names)
    weights = tuple(total / (k * c) for c in counts)

    if verbose:
        print(f"Analyzed {len(shard_files)} shards: {total} samples, "
              f"{k} classes")
        for name, count, w in zip(class_names, counts, weights):
            print(f"  {name}: {count} ({100.0 * count / total:.2f}%), "
                  f"weight {w:.4f}")

    return DatasetInfo(num_classes=k, class_names=class_names,
                       class_weights=weights, class_counts=counts,
                       total_samples=total)
