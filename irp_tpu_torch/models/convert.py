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
