"""Weights between the JAX package's variable tree and the port's
state_dict, for the four model families.

The JAX package keeps ``{'params', 'batch_stats'}`` trees in flax layout
(``backbone/layer1_block0/conv1/kernel`` HWIO, Dense kernels (in, out),
BN ``scale/bias`` + ``mean/var``, LayerNorm ``scale/bias``); its ``.npz``
artifacts store that tree.  The port's modules follow torchvision names
under ``backbone.`` and a ``classifier.{1,4}`` head.  Layout rules:

- conv kernel HWIO <-> weight OIHW (transpose 3, 2, 0, 1);
- Dense kernel (in, out) <-> Linear weight (out, in);
- BN params.scale/bias <-> weight/bias, batch_stats.mean/var <->
  running_mean/running_var; LayerNorm scale/bias <-> weight/bias.

Per family (the JAX package's ``models/convert.py`` maps):

- ViT: ``block{i}/attn_q|attn_k|attn_v`` <-> rows of the packed
  ``encoder.layers.encoder_layer_{i}.self_attention.in_proj_*``
  (q, k, v in that order); ``ln1/ln2`` <-> ``ln_1/ln_2``;
  ``mlp_dense1/2`` <-> ``mlp.0/3``; ``attn_out`` <-> ``out_proj``.
- EfficientNet: ``stem_*``/``top_*`` <-> ``features.0``/``features.8``;
  ``stage{s}_block{j}/{expand,dw,project}_{conv,bn}`` and ``se_fc1/2``
  <-> ``features.{s}.{j}.block.{k}`` by the fixed role table (stage 1
  has no expand conv).
- ConvNeXt: ``stem_conv/stem_ln`` <-> ``features.0.{0,1}``;
  ``stage{s}_block{j}`` <-> ``features.{2s-1}.{j}`` (``dw_conv``
  block.0, ``ln`` block.2, ``mlp_dense1/2`` block.3/5, ``layer_scale``
  (C,) <-> (C, 1, 1)); ``stage{s}_downsample_ln/_conv`` <->
  ``features.{2s-2}.{0,1}``; the final ``ln`` <-> ``ln`` (torchvision's
  ``classifier.0`` is read too).

A torchvision-layout ``.pth`` is recognized by its keys (ViT by
``class_token``/``encoder.``, ConvNeXt by ``layer_scale``, EfficientNet by
``features.<s>.<j>.block.``), and other ``features.`` families are
refused by name, as in the JAX package.  torchvision's own heads
(``heads.*``, a single-Linear ``classifier.*``) are skipped.

:func:`load_torch_checkpoint` and :func:`merge_pretrained` bring a
torchvision-layout ``.pth`` of any family (a pretrained backbone, or an
``export_torch_pth`` file) into a port model; :func:`flax_param_name`
maps a flax parameter path of any family to the port's name and layout,
and :func:`optax_state_to_optimizer_state` turns the JAX package's
optimizer state into the port's (``train/state.py::Optimizer.state_dict``),
so both packages can start from one mid-training state.
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
    """``{'params', 'batch_stats'}`` numpy tree of any family -> the
    port's state_dict (f32 CPU tensors, keys ``backbone.*`` and
    ``classifier.{1,4}.*``).  The family is read off the tree (ViT by
    ``class_token``, ConvNeXt by ``stem_ln``, EfficientNet by
    ``stem_conv``); ``depth`` is the ResNet's."""
    backbone = variables["params"]["backbone"]
    if "class_token" in backbone:
        sd = _vit_to_state_dict(variables)
    elif "stem_ln" in backbone:
        sd = _convnext_to_state_dict(variables)
    elif "stem_conv" in backbone:
        sd = _efficientnet_to_state_dict(variables)
    else:
        sd = _resnet_to_state_dict(variables, depth)
    _put_head(sd, variables["params"])
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _put_head(sd: Dict, params: Mapping) -> None:
    for idx, dense in (("1", "head_dense1"), ("4", "head_dense2")):
        sd[f"classifier.{idx}.weight"] = _f32(params[dense]["kernel"]).T
        sd[f"classifier.{idx}.bias"] = _f32(params[dense]["bias"])


def _conv_weight(kernel) -> np.ndarray:
    return _f32(kernel).transpose(3, 2, 0, 1)


def _resnet_to_state_dict(variables: Mapping, depth: int) -> Dict:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def put_conv(tkey, kernel):
        sd[tkey] = _conv_weight(kernel)

    b = params["backbone"]
    bs = stats.get("backbone", {})
    put_conv("backbone.conv1.weight", b["conv1"]["kernel"])
    _put_bn(sd, "backbone.bn1", b["bn1"], bs["bn1"])
    for i, n_blocks in enumerate(STAGE_SIZES[depth]):
        for j in range(n_blocks):
            fkey = f"layer{i + 1}_block{j}"
            tbase = f"backbone.layer{i + 1}.{j}"
            node, snode = b[fkey], bs[fkey]
            for conv_name in sorted(k for k in node if k.startswith("conv")):
                put_conv(f"{tbase}.{conv_name}.weight",
                         node[conv_name]["kernel"])
                bn_name = "bn" + conv_name[-1]
                _put_bn(sd, f"{tbase}.{bn_name}", node[bn_name],
                        snode[bn_name])
            if "downsample_conv" in node:
                put_conv(f"{tbase}.downsample.0.weight",
                         node["downsample_conv"]["kernel"])
                _put_bn(sd, f"{tbase}.downsample.1", node["downsample_bn"],
                        snode["downsample_bn"])
    return sd


def _put_bn(sd: Dict, tprefix: str, pnode: Mapping,
            snode: Mapping) -> None:
    for tname, coll, fname in _BN_FIELDS:
        node = pnode if coll == "params" else snode
        sd[f"{tprefix}.{tname}"] = _f32(node[fname])


def _put_ln(sd: Dict, tprefix: str, node: Mapping) -> None:
    sd[f"{tprefix}.weight"] = _f32(node["scale"])
    sd[f"{tprefix}.bias"] = _f32(node["bias"])


def _put_dense(sd: Dict, tprefix: str, node: Mapping) -> None:
    sd[f"{tprefix}.weight"] = _f32(node["kernel"]).T
    sd[f"{tprefix}.bias"] = _f32(node["bias"])


def _vit_to_state_dict(variables: Mapping) -> Dict:
    b = variables["params"]["backbone"]
    sd: Dict[str, np.ndarray] = {
        "backbone.class_token": _f32(b["class_token"]),
        "backbone.conv_proj.weight": _conv_weight(b["conv_proj"]["kernel"]),
        "backbone.conv_proj.bias": _f32(b["conv_proj"]["bias"]),
        "backbone.encoder.pos_embedding": _f32(b["pos_embedding"])}
    for name in (k for k in b if re.fullmatch(r"block\d+", k)):
        node = b[name]
        t = f"backbone.encoder.layers.encoder_layer_{name[len('block'):]}"
        _put_ln(sd, f"{t}.ln_1", node["ln1"])
        _put_ln(sd, f"{t}.ln_2", node["ln2"])
        qkv = ("attn_q", "attn_k", "attn_v")
        sd[f"{t}.self_attention.in_proj_weight"] = np.concatenate(
            [_f32(node[p]["kernel"]).T for p in qkv], 0)
        sd[f"{t}.self_attention.in_proj_bias"] = np.concatenate(
            [_f32(node[p]["bias"]) for p in qkv], 0)
        _put_dense(sd, f"{t}.self_attention.out_proj", node["attn_out"])
        _put_dense(sd, f"{t}.mlp.0", node["mlp_dense1"])
        _put_dense(sd, f"{t}.mlp.3", node["mlp_dense2"])
    _put_ln(sd, "backbone.encoder.ln", b["ln"])
    return sd


# torchvision MBConv submodule roles by index inside ``block``: stage 1
# (expand ratio 1) has no expand conv; every other stage does.
_EFF_ROLES_NO_EXPAND = {"0": "dw", "1": "se", "2": "project"}
_EFF_ROLES_EXPAND = {"0": "expand", "1": "dw", "2": "se", "3": "project"}


def _stage_block(key: str):
    stage, block = key.split("_block")
    return int(stage[len("stage"):]), int(block)


def _efficientnet_to_state_dict(variables: Mapping) -> Dict:
    b = variables["params"]["backbone"]
    bs = variables.get("batch_stats", {}).get("backbone", {})
    sd: Dict[str, np.ndarray] = {}

    for name, idx in (("stem", 0), ("top", 8)):
        sd[f"backbone.features.{idx}.0.weight"] = _conv_weight(
            b[f"{name}_conv"]["kernel"])
        _put_bn(sd, f"backbone.features.{idx}.1", b[f"{name}_bn"],
                bs[f"{name}_bn"])
    for fkey in (k for k in b if re.fullmatch(r"stage\d+_block\d+", k)):
        s, j = _stage_block(fkey)
        tbase = f"backbone.features.{s}.{j}.block"
        roles = _EFF_ROLES_NO_EXPAND if s == 1 else _EFF_ROLES_EXPAND
        idx_of = {v: k for k, v in roles.items()}
        node, snode = b[fkey], bs[fkey]
        for role in ("expand", "dw", "project"):
            if f"{role}_conv" in node:
                k = idx_of[role]
                sd[f"{tbase}.{k}.0.weight"] = _conv_weight(
                    node[f"{role}_conv"]["kernel"])
                _put_bn(sd, f"{tbase}.{k}.1", node[f"{role}_bn"],
                        snode[f"{role}_bn"])
        for fc in ("fc1", "fc2"):
            sd[f"{tbase}.{idx_of['se']}.{fc}.weight"] = _conv_weight(
                node[f"se_{fc}"]["kernel"])
            sd[f"{tbase}.{idx_of['se']}.{fc}.bias"] = _f32(
                node[f"se_{fc}"]["bias"])
    return sd


def _convnext_to_state_dict(variables: Mapping) -> Dict:
    b = variables["params"]["backbone"]
    sd: Dict[str, np.ndarray] = {}

    def put_conv(tprefix, node):
        sd[f"{tprefix}.weight"] = _conv_weight(node["kernel"])
        sd[f"{tprefix}.bias"] = _f32(node["bias"])

    put_conv("backbone.features.0.0", b["stem_conv"])
    _put_ln(sd, "backbone.features.0.1", b["stem_ln"])
    for fkey in (k for k in b if re.fullmatch(r"stage\d+_block\d+", k)):
        s, j = _stage_block(fkey)
        t = f"backbone.features.{2 * s - 1}.{j}"
        node = b[fkey]
        put_conv(f"{t}.block.0", node["dw_conv"])
        _put_ln(sd, f"{t}.block.2", node["ln"])
        _put_dense(sd, f"{t}.block.3", node["mlp_dense1"])
        _put_dense(sd, f"{t}.block.5", node["mlp_dense2"])
        sd[f"{t}.layer_scale"] = _f32(node["layer_scale"]).reshape(-1, 1, 1)
    for s in range(2, 5):
        if f"stage{s}_downsample_ln" in b:
            _put_ln(sd, f"backbone.features.{2 * s - 2}.0",
                    b[f"stage{s}_downsample_ln"])
            put_conv(f"backbone.features.{2 * s - 2}.1",
                     b[f"stage{s}_downsample_conv"])
    _put_ln(sd, "backbone.ln", b["ln"])
    return sd


def _set(tree: Dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _strip(key: str) -> str:
    return key[len("backbone."):] if key.startswith("backbone.") else key


def _is_vit_state_dict(state_dict) -> bool:
    return any(_strip(k) == "class_token" or _strip(k).startswith("encoder.")
               for k in state_dict)


def _is_convnext_state_dict(state_dict) -> bool:
    # layer_scale is ConvNeXt's alone among torchvision families (checked
    # before EfficientNet: ConvNeXt's blocks also sit under features.)
    return any(_strip(k).endswith("layer_scale") for k in state_dict)


def _is_efficientnet_state_dict(state_dict) -> bool:
    # the MBConv layout features.<s>.<j>.block.<k>., not just features.
    # (VGG, DenseNet and MobileNet have that too)
    return any(re.match(r"^features\.\d+\.\d+\.block\.", _strip(k))
               for k in state_dict)


def state_dict_to_jax_variables(state_dict: Mapping) -> Dict[str, Dict]:
    """Inverse of :func:`jax_variables_to_state_dict`: a state_dict of any
    family (the port's, the JAX package's ``export_torch_pth`` output, the
    reference stack's AnimalClassifier or a torchvision checkpoint;
    ``backbone.`` prefix optional) -> ``{'params', 'batch_stats'}`` numpy
    tree, as the ``.npz`` artifacts store it.  The family is read off the
    keys; ``num_batches_tracked`` and torchvision's own heads (``fc.*``,
    ``heads.*``, a single-Linear ``classifier``) are skipped.  A
    ``features.`` state_dict of another torchvision family raises
    ``ValueError``."""
    if _is_vit_state_dict(state_dict):
        return _vit_from_state_dict(state_dict)
    if _is_convnext_state_dict(state_dict):
        return _convnext_from_state_dict(state_dict)
    if _is_efficientnet_state_dict(state_dict):
        return _efficientnet_from_state_dict(state_dict)
    if any(_strip(k).startswith("features.") for k in state_dict):
        raise ValueError(
            "state_dict has 'features.'-prefixed keys but neither the "
            "EfficientNet MBConv layout ('features.<s>.<j>.block.<k>.') "
            "nor ConvNeXt layer_scale keys: this looks like an "
            "unsupported torchvision family (e.g. VGG, DenseNet, "
            "MobileNet). Supported families: ResNet/ResNeXt/Wide-ResNet "
            "(conv1/layer*), ViT (class_token/encoder.*), EfficientNet "
            "(features.*.*.block.*), ConvNeXt (features.* + layer_scale)")
    return _resnet_from_state_dict(state_dict)


def _arr(value) -> np.ndarray:
    """A float32 numpy copy (the tree must not alias a module's
    tensors)."""
    return np.array(value.detach().cpu().float().numpy()
                    if isinstance(value, torch.Tensor) else value,
                    np.float32)


def _take_head(key: str, arr: np.ndarray, params: Dict) -> bool:
    """Put a ``classifier.{1,4}`` head tensor into ``params``; whether
    ``key`` was one."""
    m = re.fullmatch(r"classifier\.([14])\.(weight|bias)", key)
    if not m:
        return False
    dense = "head_dense1" if m.group(1) == "1" else "head_dense2"
    if m.group(2) == "weight":
        _set(params, (dense, "kernel"), arr.T.copy())
    else:
        _set(params, (dense, "bias"), arr)
    return True


def _has_mlp_head(state_dict) -> bool:
    return any(_strip(k).startswith("classifier.4.") for k in state_dict)


def _ln_leaf(field: str) -> str:
    return "scale" if field == "weight" else "bias"


def _conv_kernel(arr: np.ndarray) -> np.ndarray:
    return arr.transpose(2, 3, 1, 0).copy()


def _vit_from_state_dict(state_dict) -> Dict[str, Dict]:
    params: Dict = {}
    b: Dict = {}
    for key, value in state_dict.items():
        key = _strip(key)
        if key.startswith("heads."):
            continue  # torchvision's own classification head
        arr = _arr(value)
        if _take_head(key, arr, params):
            continue
        if key == "class_token":
            b["class_token"] = arr
        elif key == "encoder.pos_embedding":
            b["pos_embedding"] = arr
        elif key == "conv_proj.weight":
            _set(b, ("conv_proj", "kernel"), _conv_kernel(arr))
        elif key == "conv_proj.bias":
            _set(b, ("conv_proj", "bias"), arr)
        elif key in ("encoder.ln.weight", "encoder.ln.bias"):
            _set(b, ("ln", _ln_leaf(key.split(".")[-1])), arr)
        else:
            m = re.fullmatch(r"encoder\.layers\.encoder_layer_(\d+)\.(.+)",
                             key)
            if not m:
                raise KeyError(f"unrecognized ViT torch key: {key}")
            block, rest = f"block{m.group(1)}", m.group(2)
            mod, _, field = rest.rpartition(".")
            if mod in ("ln_1", "ln_2"):
                _set(b, (block, mod.replace("_", ""), _ln_leaf(field)), arr)
            elif rest.startswith("self_attention.in_proj_"):
                e = arr.shape[0] // 3
                leaf = "kernel" if rest.endswith("weight") else "bias"
                for j, proj in enumerate(("attn_q", "attn_k", "attn_v")):
                    part = arr[j * e:(j + 1) * e]
                    _set(b, (block, proj, leaf),
                         part.T.copy() if leaf == "kernel" else part.copy())
            elif mod in ("self_attention.out_proj", "mlp.0", "mlp.3"):
                dense = {"self_attention.out_proj": "attn_out",
                         "mlp.0": "mlp_dense1", "mlp.3": "mlp_dense2"}[mod]
                _set(b, (block, dense,
                         "kernel" if field == "weight" else "bias"),
                     arr.T.copy() if field == "weight" else arr)
            else:
                raise KeyError(f"unrecognized ViT torch key: {key}")
    params["backbone"] = b
    return {"params": params, "batch_stats": {}}


def _efficientnet_from_state_dict(state_dict) -> Dict[str, Dict]:
    params: Dict = {}
    b: Dict = {}
    bs: Dict = {}
    bn_map = {t: (coll, f) for t, coll, f in _BN_FIELDS}
    mlp_head = _has_mlp_head(state_dict)

    def put(path_conv, path_bn, sub, field, arr):
        if sub == "0":
            _set(b, path_conv + ("kernel",), _conv_kernel(arr))
        else:
            coll, leaf = bn_map[field]
            _set(b if coll == "params" else bs, path_bn + (leaf,), arr)

    for key, value in state_dict.items():
        key = _strip(key)
        if key.endswith("num_batches_tracked"):
            continue
        arr = _arr(value)
        if key.startswith("classifier."):
            if mlp_head:
                _take_head(key, arr, params)
            continue  # torchvision's own 1000-way head is not ours
        m = re.fullmatch(r"features\.(\d+)\.(.+)", key)
        if not m:
            raise KeyError(f"unrecognized EfficientNet torch key: {key}")
        fidx, rest = int(m.group(1)), m.group(2)
        if fidx in (0, 8):  # stem / top Conv2dNormActivation
            name = "stem" if fidx == 0 else "top"
            sub, field = rest.split(".", 1)
            put((f"{name}_conv",), (f"{name}_bn",), sub, field, arr)
            continue
        m = re.fullmatch(r"(\d+)\.block\.(\d+)\.(.+)", rest)
        roles = _EFF_ROLES_NO_EXPAND if fidx == 1 else _EFF_ROLES_EXPAND
        role = roles.get(m.group(2)) if m else None
        if role is None:
            raise KeyError(f"unrecognized EfficientNet torch key: {key}")
        block = f"stage{fidx}_block{m.group(1)}"
        sub, field = m.group(3).split(".", 1)
        if role == "se":
            _set(b, (block, f"se_{sub}", "kernel" if field == "weight"
                     else "bias"),
                 _conv_kernel(arr) if field == "weight" else arr)
        else:
            put((block, f"{role}_conv"), (block, f"{role}_bn"), sub, field,
                arr)
    params["backbone"] = b
    return {"params": params, "batch_stats": {"backbone": bs}}


def _convnext_from_state_dict(state_dict) -> Dict[str, Dict]:
    params: Dict = {}
    b: Dict = {}
    mlp_head = _has_mlp_head(state_dict)

    def put_conv(path, field, arr):
        _set(b, path + ("kernel" if field == "weight" else "bias",),
             _conv_kernel(arr) if field == "weight" else arr)

    for key, value in state_dict.items():
        key = _strip(key)
        arr = _arr(value)
        if key in ("ln.weight", "ln.bias"):  # the port's and irp_tpu's
            _set(b, ("ln", _ln_leaf(key.split(".")[1])), arr)
            continue
        if key.startswith("classifier."):
            m = re.fullmatch(r"classifier\.(\d+)\.(weight|bias)", key)
            if m is None:
                raise KeyError(f"unrecognized ConvNeXt torch key: {key}")
            if m.group(1) == "0":  # torchvision's post-pool LayerNorm
                _set(b, ("ln", _ln_leaf(m.group(2))), arr)
            elif mlp_head:
                _take_head(key, arr, params)
            continue  # else torchvision's own classifier.2 Linear
        m = re.fullmatch(r"features\.(\d+)\.(.+)", key)
        if not m:
            raise KeyError(f"unrecognized ConvNeXt torch key: {key}")
        fidx, rest = int(m.group(1)), m.group(2)
        if fidx == 0:  # stem conv + LayerNorm
            sub, field = rest.split(".", 1)
            if sub == "0":
                put_conv(("stem_conv",), field, arr)
            else:
                _set(b, ("stem_ln", _ln_leaf(field)), arr)
        elif fidx % 2 == 1:  # CNBlock stages
            m2 = re.fullmatch(
                r"(\d+)\.(layer_scale|block\.(\d)\.(weight|bias))", rest)
            if m2 is None:
                raise KeyError(f"unrecognized ConvNeXt torch key: {key}")
            block = f"stage{(fidx + 1) // 2}_block{m2.group(1)}"
            k, field = m2.group(3), m2.group(4)
            if m2.group(2) == "layer_scale":
                _set(b, (block, "layer_scale"), arr.reshape(-1))
            elif k == "0":
                put_conv((block, "dw_conv"), field, arr)
            elif k == "2":
                _set(b, (block, "ln", _ln_leaf(field)), arr)
            elif k in ("3", "5"):
                dense = "mlp_dense1" if k == "3" else "mlp_dense2"
                _set(b, (block, dense, "kernel" if field == "weight"
                         else "bias"),
                     arr.T.copy() if field == "weight" else arr)
            else:
                raise KeyError(f"unrecognized ConvNeXt torch key: {key}")
        else:  # 2/4/6: LayerNorm + 2x2/2 conv into stage fidx // 2 + 1
            s = fidx // 2 + 1
            sub, field = rest.split(".", 1)
            if sub == "0":
                _set(b, (f"stage{s}_downsample_ln", _ln_leaf(field)), arr)
            else:
                put_conv((f"stage{s}_downsample_conv",), field, arr)
    params["backbone"] = b
    return {"params": params, "batch_stats": {}}


def _resnet_from_state_dict(state_dict) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    bn_map = {t: (coll, f) for t, coll, f in _BN_FIELDS}
    for key, value in state_dict.items():
        key = _strip(key)
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        arr = _arr(value)
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
    """Overlay a torchvision-layout state_dict of the model's family
    (ResNet ``conv1``/``layer*``, ViT ``vit_*``, ConvNeXt ``convnext_*``,
    EfficientNet ``efficientnet_*``; ``backbone.`` prefix optional) onto
    ``model``'s weights in place; returns ``model``.

    torchvision's own heads are skipped (ResNet's ``fc.*``, ViT's
    ``heads.*``, the single-Linear ``classifier.*`` of EfficientNet and
    ConvNeXt), as are ``num_batches_tracked``; an MLP head
    ``classifier.{1,4}`` (an ``export_torch_pth`` file) is overlaid, and
    ConvNeXt's ``classifier.0`` is its post-pool LayerNorm
    (``backbone.ln``).  So the head keeps its init when the checkpoint is
    a torchvision backbone.  An unknown key raises KeyError, a shape
    mismatch ValueError, before any weight is changed.
    """
    own = model.state_dict()
    convnext = _is_convnext_state_dict(state_dict)
    # EfficientNet and ConvNeXt keep a torchvision classifier.1 / .2
    # Linear; classifier.4 tells the MLP head apart from it
    sequential_head = convnext or _is_efficientnet_state_dict(state_dict)
    mlp_head = not sequential_head or _has_mlp_head(state_dict)
    updates = {}
    for key, value in state_dict.items():
        name = _strip(key)
        if name.startswith(("fc.", "heads.")) or name.endswith(
                "num_batches_tracked"):
            continue
        m = re.fullmatch(r"classifier\.(\d)\.(weight|bias)", name)
        if m and convnext and m.group(1) == "0":
            target = f"backbone.ln.{m.group(2)}"
        elif m:
            if not (mlp_head and m.group(1) in ("1", "4")):
                continue
            target = name
        else:
            target = f"backbone.{name}"
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


def _conv_layout(a):
    return a.transpose(3, 2, 0, 1)


def _same(a):
    return a


def _dense_layout(a):
    return a.T


def _leaf(prefix: str, field: str) -> tuple:
    """(name, layout) of a conv/Dense/norm leaf of the module at
    ``prefix``: a conv kernel (4-D, HWIO -> OIHW) or a Dense kernel
    (transposed) -> ``weight``, a norm's ``scale`` -> ``weight``, a
    ``bias`` as is."""
    if field == "kernel":
        return f"{prefix}.weight", _kernel_layout
    return f"{prefix}.{'weight' if field == 'scale' else 'bias'}", _same


def _kernel_layout(a):
    return _conv_layout(a) if a.ndim == 4 else _dense_layout(a)


_VIT_BLOCK = {"ln1": "ln_1", "ln2": "ln_2",
              "attn_out": "self_attention.out_proj", "mlp_dense1": "mlp.0",
              "mlp_dense2": "mlp.3"}
# the rows of the packed in_proj that attn_q / attn_k / attn_v fill
_VIT_QKV = ("attn_q", "attn_k", "attn_v")
_CNX_BLOCK = {"dw_conv": "block.0", "ln": "block.2", "mlp_dense1": "block.3",
              "mlp_dense2": "block.5"}


def _vit_param_name(path) -> tuple:
    mod = path[1]
    if mod in ("class_token", "pos_embedding"):
        return ("backbone.class_token" if mod == "class_token"
                else "backbone.encoder.pos_embedding"), _same
    if mod == "conv_proj":
        return _leaf("backbone.conv_proj", path[2])
    if mod == "ln":
        return _leaf("backbone.encoder.ln", path[2])
    i = re.fullmatch(r"block(\d+)", mod).group(1)
    block = f"backbone.encoder.layers.encoder_layer_{i}"
    sub, field = path[2], path[3]
    if sub in _VIT_QKV:
        # one third of the rows of the packed projection
        # (flax_tree_to_named joins them in q, k, v order)
        leaf = "in_proj_weight" if field == "kernel" else "in_proj_bias"
        return f"{block}.self_attention.{leaf}", (
            _dense_layout if field == "kernel" else _same)
    return _leaf(f"{block}.{_VIT_BLOCK[sub]}", field)


def _efficientnet_param_name(path) -> tuple:
    mod = path[1]
    m = re.fullmatch(r"(stem|top)_(conv|bn)", mod)
    if m:
        idx = 0 if m.group(1) == "stem" else 8
        sub = "0" if m.group(2) == "conv" else "1"
        return _leaf(f"backbone.features.{idx}.{sub}", path[2])
    s, j = _stage_block(mod)
    roles = _EFF_ROLES_NO_EXPAND if s == 1 else _EFF_ROLES_EXPAND
    idx_of = {v: k for k, v in roles.items()}
    base = f"backbone.features.{s}.{j}.block"
    sub, field = path[2], path[3]
    if sub.startswith("se_"):
        return _leaf(f"{base}.{idx_of['se']}.{sub[len('se_'):]}", field)
    role, kind = sub.rsplit("_", 1)
    return _leaf(f"{base}.{idx_of[role]}.{'0' if kind == 'conv' else '1'}",
                 field)


def _convnext_param_name(path) -> tuple:
    mod = path[1]
    if mod in ("stem_conv", "stem_ln"):
        sub = "0" if mod == "stem_conv" else "1"
        return _leaf(f"backbone.features.0.{sub}", path[2])
    if mod == "ln":
        return _leaf("backbone.ln", path[2])
    m = re.fullmatch(r"stage(\d+)_downsample_(ln|conv)", mod)
    if m:
        s = int(m.group(1))
        return _leaf(f"backbone.features.{2 * s - 2}."
                     f"{'0' if m.group(2) == 'ln' else '1'}", path[2])
    s, j = _stage_block(mod)
    base = f"backbone.features.{2 * s - 1}.{j}"
    if path[2] == "layer_scale":
        return f"{base}.layer_scale", lambda a: a.reshape(-1, 1, 1)
    return _leaf(f"{base}.{_CNX_BLOCK[path[2]]}", path[3])


def _resnet_param_name(path) -> tuple:
    if len(path) == 3:
        prefix, (mod, field) = "backbone", path[1:]
    else:
        stage, block = re.fullmatch(r"(layer\d)_block(\d+)",
                                    path[1]).groups()
        prefix, (mod, field) = f"backbone.{stage}.{block}", path[2:]
        mod = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(mod, mod)
    if field == "kernel":
        return f"{prefix}.{mod}.weight", _conv_layout
    return f"{prefix}.{mod}.{'weight' if field == 'scale' else 'bias'}", \
        _same


_PARAM_NAMES = {"resnet": _resnet_param_name, "vit": _vit_param_name,
                "efficientnet": _efficientnet_param_name,
                "convnext": _convnext_param_name}


def flax_param_name(path, family: str = "resnet") -> tuple:
    """A flax ``params`` path (tuple of keys) of a ``family`` classifier ->
    (state_dict name, layout function): conv kernels HWIO -> OIHW, Dense
    kernels transposed, norms' ``scale``/``bias`` -> ``weight``/``bias``,
    ConvNeXt's ``layer_scale`` (C,) -> (C, 1, 1).  ViT's ``attn_q``,
    ``attn_k`` and ``attn_v`` each name the packed ``in_proj_*`` (their
    rows in that order; :func:`flax_tree_to_named` joins them)."""
    path = tuple(path)
    if path[0] in ("head_dense1", "head_dense2"):
        idx = "1" if path[0] == "head_dense1" else "4"
        if path[1] == "kernel":
            return f"classifier.{idx}.weight", _dense_layout
        return f"classifier.{idx}.bias", _same
    if path[0] != "backbone" or family not in _PARAM_NAMES:
        raise KeyError(f"unrecognized parameter path {path}")
    return _PARAM_NAMES[family](path)


def _flax_leaves(tree: Mapping, prefix=()):
    """(path, array) for every array leaf of a nested mapping; other leaves
    (optax's ``MaskedNode`` for a frozen parameter) are skipped."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _flax_leaves(value, prefix + (key,))
        elif hasattr(value, "shape") and hasattr(value, "dtype"):
            yield prefix + (key,), np.asarray(value)


def _flax_family(tree: Mapping) -> str:
    """The family of a flax ``params``-shaped tree (parameters, or an
    optimizer's moments over them), read off its backbone's keys."""
    backbone = tree.get("backbone", {})
    if "class_token" in backbone:
        return "vit"
    if "stem_ln" in backbone:
        return "convnext"
    if "stem_conv" in backbone:
        return "efficientnet"
    return "resnet"


def flax_tree_to_named(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``params``-shaped tree -> {state_dict name: f32 CPU tensor} in
    the port's layout (:func:`flax_param_name`); ViT's q, k and v rows
    joined into the packed ``in_proj_*``.  Leaves that are no arrays
    (optax's ``MaskedNode``) are skipped."""
    family = _flax_family(tree)
    out, packed = {}, {}
    for path, arr in _flax_leaves(tree):
        name, layout = flax_param_name(path, family)
        a = np.array(layout(arr.astype(np.float32)), np.float32)
        if family == "vit" and path[-2] in _VIT_QKV:
            packed.setdefault(name, {})[_VIT_QKV.index(path[-2])] = a
        else:
            out[name] = torch.from_numpy(a)
    for name, parts in packed.items():
        out[name] = torch.from_numpy(np.concatenate(
            [parts[j] for j in range(3)], 0))
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
    moments = {k: flax_tree_to_named(found[k]) for k in kinds}
    ema = None
    if "ema" in found:
        trainable = set(moments[kinds[0]])
        ema = {n: t for n, t in flax_tree_to_named(found["ema"]).items()
               if n in trainable}
    hp = found["hyperparams"]
    return {"count": found["count"],
            "learning_rate": float(np.asarray(hp["learning_rate"])),
            "weight_decay": float(np.asarray(hp["weight_decay"])),
            "moments": moments, "ema": ema}
