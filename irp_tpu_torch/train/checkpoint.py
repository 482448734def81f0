"""Weights-only ``.npz`` artifacts (the JAX package's
``train/checkpoint.py``), in numpy only.

The key layout is the JAX package's: ``params/<path>`` and
``batch_stats/<path>`` with ``/``-joined flax tree paths, plus reserved
``__meta__/<name>`` keys for metadata such as ``image_size``.  So either
package reads what the other wrote.  Full training-state checkpoints come
with the training slice.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np


def _flatten(tree: Mapping, prefix: str, out: dict) -> None:
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}"
        if isinstance(value, Mapping):
            _flatten(value, path, out)
        else:
            out[path] = np.asarray(value)


def save_weights_npz(path: str, params: Mapping, batch_stats: Mapping,
                     meta: Optional[dict] = None) -> str:
    """Flat npz of a ``{'params', 'batch_stats'}`` tree.

    ``meta`` (scalars/small arrays, e.g. ``{"image_size": 224}``) rides
    along under ``__meta__/`` keys so the artifact describes itself.
    """
    flat: dict = {}
    _flatten(params, "params", flat)
    _flatten(batch_stats, "batch_stats", flat)
    for k, v in (meta or {}).items():
        flat["__meta__/" + k] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return path


def load_weights_npz(path: str, with_meta: bool = False):
    """Inverse of :func:`save_weights_npz` -> (params, batch_stats) nested
    dicts, plus the meta dict when ``with_meta``."""
    out = {"params": {}, "batch_stats": {}}
    meta = {}
    with np.load(path) as data:
        for key in data.files:
            coll, rest = key.split("/", 1)
            if coll == "__meta__":
                v = data[key]
                meta[rest] = v.item() if v.ndim == 0 else v
                continue
            if coll not in out:
                raise ValueError(f"{path}: unexpected key {key!r}")
            node = out[coll]
            parts = rest.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    if with_meta:
        return out["params"], out["batch_stats"], meta
    return out["params"], out["batch_stats"]


def load_weights_meta(path: str) -> dict:
    """The ``meta`` dict a :func:`save_weights_npz` artifact carries (empty
    for artifacts without one)."""
    return load_weights_npz(path, with_meta=True)[2]
