"""Weights-only ``.npz`` artifacts (the JAX package's
``train/checkpoint.py``), in numpy only.

The key layout is the JAX package's: ``params/<path>`` and
``batch_stats/<path>`` with ``/``-joined flax tree paths, plus reserved
``__meta__/<name>`` keys for metadata such as ``image_size``.  So either
package reads what the other wrote.

Full training-state checkpoints (:func:`save_checkpoint`,
:func:`latest_checkpoint`, :func:`restore_checkpoint`) hold what a resumed
``fit`` needs: parameters and BN statistics, the optimizer's moments and
step count, lr and wd, and the EMA, as plain tensors in one
``torch.save`` file per epoch, ``<dir>/step_<8 digits>.pt``.
"""

from __future__ import annotations

import os
import re
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


def save_checkpoint(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    """Write ``state`` (a ``train/state.py::TrainState``) to
    ``ckpt_dir/step_<step>.pt`` (``step`` defaults to the optimizer's step
    count); returns the path."""
    import torch

    step = state.step if step is None else int(step)
    os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str):
    """The newest checkpoint in ``ckpt_dir`` as ``(path, next_epoch)``, the
    resume point for ``fit(restore_from=path, start_epoch=next_epoch)``;
    ``(None, 0)`` when there is none."""
    best = None
    if os.path.isdir(ckpt_dir):
        for entry in os.listdir(ckpt_dir):
            m = re.fullmatch(r"step_(\d{8})\.pt", entry)
            if m and (best is None or int(m.group(1)) > best[1]):
                best = (os.path.join(ckpt_dir, entry), int(m.group(1)))
    if best is None:
        return None, 0
    return best[0], best[1] + 1


def restore_checkpoint(path: str, state):
    """Load a :func:`save_checkpoint` file into ``state`` in place (the
    tensors keep their devices); returns ``state``."""
    import torch

    state.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
    return state
