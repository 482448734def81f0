"""Weights between the JAX package's variable tree and the port's
state_dict (ResNet family).

The JAX package keeps ``{'params', 'batch_stats'}`` trees in flax layout
(``backbone/layer1_block0/conv1/kernel`` HWIO, Dense kernels (in, out),
BN ``scale/bias`` + ``mean/var``); its ``.npz`` artifacts store that tree.
The port's modules follow torchvision names under ``backbone.`` and a
``classifier.{1,4}`` head.  Layout rules:

- conv kernel HWIO <-> weight OIHW (transpose 3, 2, 0, 1);
- Dense kernel (in, out) <-> Linear weight (out, in);
- BN params.scale/bias <-> weight/bias, batch_stats.mean/var <->
  running_mean/running_var.

:func:`load_torch_checkpoint` and :func:`merge_pretrained` bring a
torchvision-layout ``.pth`` (a pretrained backbone) into a port model;
:func:`optax_state_to_optimizer_state` turns the JAX package's optimizer
state into the port's (``train/state.py::Optimizer.state_dict``), so both
packages can start from one mid-training state.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from irp_tpu_torch.models.resnet import STAGE_SIZES

_BN_FIELDS = (("weight", "params", "scale"), ("bias", "params", "bias"),
              ("running_mean", "batch_stats", "mean"),
              ("running_var", "batch_stats", "var"))


def jax_variables_to_state_dict(variables: Mapping,
                                depth: int = 50) -> Dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` numpy tree -> the port's state_dict
    (f32 CPU tensors, keys ``backbone.*`` and ``classifier.{1,4}.*``)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def put_conv(tkey, kernel):
        sd[tkey] = np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)

    def put_bn(tprefix, pnode, snode):
        for tname, coll, fname in _BN_FIELDS:
            node = pnode if coll == "params" else snode
            sd[f"{tprefix}.{tname}"] = np.asarray(node[fname], np.float32)

    b = params["backbone"]
    bs = stats.get("backbone", {})
    put_conv("backbone.conv1.weight", b["conv1"]["kernel"])
    put_bn("backbone.bn1", b["bn1"], bs["bn1"])
    for i, n_blocks in enumerate(STAGE_SIZES[depth]):
        for j in range(n_blocks):
            fkey = f"layer{i + 1}_block{j}"
            tbase = f"backbone.layer{i + 1}.{j}"
            node, snode = b[fkey], bs[fkey]
            for conv_name in sorted(k for k in node if k.startswith("conv")):
                put_conv(f"{tbase}.{conv_name}.weight",
                         node[conv_name]["kernel"])
                bn_name = "bn" + conv_name[-1]
                put_bn(f"{tbase}.{bn_name}", node[bn_name], snode[bn_name])
            if "downsample_conv" in node:
                put_conv(f"{tbase}.downsample.0.weight",
                         node["downsample_conv"]["kernel"])
                put_bn(f"{tbase}.downsample.1", node["downsample_bn"],
                       snode["downsample_bn"])
    for idx, dense in (("1", "head_dense1"), ("4", "head_dense2")):
        sd[f"classifier.{idx}.weight"] = np.asarray(
            params[dense]["kernel"], np.float32).T
        sd[f"classifier.{idx}.bias"] = np.asarray(params[dense]["bias"],
                                                  np.float32)
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def _set(tree: Dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def state_dict_to_jax_variables(state_dict: Mapping) -> Dict[str, Dict]:
    """Inverse of :func:`jax_variables_to_state_dict`: a ResNet state_dict
    (the port's, the JAX package's ``export_torch_pth`` output, or the
    reference stack's AnimalClassifier; ``backbone.`` prefix optional) ->
    ``{'params', 'batch_stats'}`` numpy tree, as the ``.npz`` artifacts
    store it.  ``num_batches_tracked`` and a torchvision ``fc.*`` are
    skipped."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    bn_map = {t: (coll, f) for t, coll, f in _BN_FIELDS}
    for key, value in state_dict.items():
        key = key[len("backbone."):] if key.startswith("backbone.") else key
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        # a copy: the tree must not alias the module's tensors
        arr = np.array(value.detach().cpu().float().numpy()
                       if isinstance(value, torch.Tensor) else value,
                       np.float32)
        m = re.fullmatch(r"classifier\.(\d)\.(weight|bias)", key)
        if m:
            dense = {"1": "head_dense1", "4": "head_dense2"}.get(m.group(1))
            if dense is None:
                raise KeyError(f"unrecognized head key: {key}")
            if m.group(2) == "weight":
                _set(out["params"], (dense, "kernel"), arr.T.copy())
            else:
                _set(out["params"], (dense, "bias"), arr)
            continue
        m = re.fullmatch(r"(conv1|bn1)\.(\w+)", key)
        if m:
            base, mod, field = ("backbone",), m.group(1), m.group(2)
        else:
            m = re.fullmatch(
                r"layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.[01])\.(\w+)",
                key)
            if not m:
                raise KeyError(f"unrecognized ResNet key: {key}")
            stage, block, mod, field = m.groups()
            base = ("backbone", f"layer{stage}_block{block}")
            mod = {"downsample.0": "downsample_conv",
                   "downsample.1": "downsample_bn"}.get(mod, mod)
        if mod.startswith("conv") or mod == "downsample_conv":
            if field != "weight":
                raise KeyError(f"unexpected conv field: {key}")
            _set(out["params"], base + (mod, "kernel"),
                 arr.transpose(2, 3, 1, 0).copy())
        else:
            coll, fname = bn_map[field]
            _set(out[coll], base + (mod, fname), arr)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state_dict loaded on the CPU: a bare state_dict or a dict
    with a ``'state_dict'`` entry."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def merge_pretrained(model: torch.nn.Module,
                     state_dict: Mapping) -> torch.nn.Module:
    """Overlay a ResNet state_dict (torchvision names, ``backbone.`` prefix
    optional) onto ``model``'s weights in place; returns ``model``.

    ``fc.*``, ``num_batches_tracked`` and head keys other than
    ``classifier.{1,4}`` are skipped, so the head keeps its init when the
    checkpoint is a torchvision backbone.  An unknown key raises KeyError,
    a shape mismatch ValueError, before any weight is changed.
    """
    own = model.state_dict()
    updates = {}
    for key, value in state_dict.items():
        name = key[len("backbone."):] if key.startswith("backbone.") else key
        if name.startswith("fc.") or name.endswith("num_batches_tracked"):
            continue
        m = re.fullmatch(r"classifier\.(\d)\.(weight|bias)", name)
        if m and m.group(1) not in ("1", "4"):
            continue
        target = name if m else f"backbone.{name}"
        if target not in own:
            raise KeyError(f"pretrained key {key} is not in the model")
        want, got = tuple(own[target].shape), tuple(value.shape)
        if want != got:
            raise ValueError(f"shape mismatch at {key}: model {want}, "
                             f"pretrained {got}")
        updates[target] = value
    with torch.no_grad():
        for target, value in updates.items():
            own[target].copy_(torch.as_tensor(value))
    return model


def flax_param_name(path) -> tuple:
    """A flax ``params`` path (tuple of keys) -> (state_dict name, layout
    function): conv kernels HWIO -> OIHW, Dense kernels transposed, BN
    ``scale``/``bias`` -> ``weight``/``bias``."""
    path = tuple(path)
    if path[0] in ("head_dense1", "head_dense2"):
        idx = "1" if path[0] == "head_dense1" else "4"
        if path[1] == "kernel":
            return f"classifier.{idx}.weight", lambda a: a.T
        return f"classifier.{idx}.bias", lambda a: a
    if path[0] != "backbone":
        raise KeyError(f"unrecognized parameter path {path}")
    if len(path) == 3:
        prefix, (mod, field) = "backbone", path[1:]
    else:
        stage, block = re.fullmatch(r"(layer\d)_block(\d+)",
                                    path[1]).groups()
        prefix, (mod, field) = f"backbone.{stage}.{block}", path[2:]
        mod = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(mod, mod)
    if field == "kernel":
        return f"{prefix}.{mod}.weight", lambda a: a.transpose(3, 2, 0, 1)
    return f"{prefix}.{mod}.{'weight' if field == 'scale' else 'bias'}", \
        lambda a: a


def _flax_leaves(tree: Mapping, prefix=()):
    """(path, array) for every array leaf of a nested mapping; other leaves
    (optax's ``MaskedNode`` for a frozen parameter) are skipped."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _flax_leaves(value, prefix + (key,))
        elif hasattr(value, "shape") and hasattr(value, "dtype"):
            yield prefix + (key,), np.asarray(value)


def _named(tree: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for path, arr in _flax_leaves(tree):
        name, layout = flax_param_name(path)
        out[name] = torch.from_numpy(
            np.array(layout(arr.astype(np.float32)), np.float32))
    return out


def optax_state_to_optimizer_state(opt_state) -> dict:
    """The JAX package's optax state (its arrays as numpy; adam, adamw or
    sgd, masked to the trainable parameters, with or without the EMA slot)
    -> the port's ``Optimizer.state_dict()``: the step count, lr and wd,
    the masked moments ``mu``/``nu`` or ``trace`` by state_dict name, and
    the EMA of the trainable parameters.

    The state is walked by its field names (``count``, ``hyperparams``,
    ``mu``, ``nu``, ``trace``, ``ema``), so this module needs no optax.
    """
    found: Dict[str, object] = {}

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is None:
            if isinstance(node, (tuple, list)):
                for v in node:
                    walk(v)
            return
        for f in fields:
            v = getattr(node, f)
            if f in ("mu", "nu", "trace", "ema") and isinstance(v, Mapping):
                found.setdefault(f, v)
            elif f == "count":
                found.setdefault("count", int(np.asarray(v)))
            elif f == "hyperparams":
                found.setdefault("hyperparams", v)
            else:
                walk(v)

    walk(opt_state)
    kinds = ("trace",) if "trace" in found else ("mu", "nu")
    moments = {k: _named(found[k]) for k in kinds}
    ema = None
    if "ema" in found:
        trainable = set(moments[kinds[0]])
        ema = {n: t for n, t in _named(found["ema"]).items()
               if n in trainable}
    hp = found["hyperparams"]
    return {"count": found["count"],
            "learning_rate": float(np.asarray(hp["learning_rate"])),
            "weight_decay": float(np.asarray(hp["weight_decay"])),
            "moments": moments, "ema": ema}
