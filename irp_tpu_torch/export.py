"""Portable serving artifacts: ``torch.export`` programs in one ``.irpx``
zip (the JAX package's ``export.py``).

An ``.irpx`` of this package holds:

    program.pt2      ``torch.export.save`` of ``forward(weights, images_u8)
                     -> probs`` at a fixed (batch, source, source, 3) uint8
                     shape: eval preprocess (the op
                     ``irp_tpu_torch::eval_preprocess``, K2 on the card),
                     the model (any family; for a ResNet,
                     ``irp_tpu_torch::identity_bottleneck``, K1, in each
                     frozen identity block when the predictor ran them
                     fused), softmax, and the flip average when TTA is on
    program.bN.pt2   the same forward at batch N, for each other rung of
                     the predictor's ``pad_buckets`` ladder
    explain.pt2      (optional) the Grad-CAM program ``forward(weights,
                     images_u8, class_idx) -> (cams, logits)``
                     (``explain.py``)
    weights.npz      the weights (``train/checkpoint.py``'s format)
    meta.json        geometry, class names, format version, ``"runtime":
                     "torch"``, the model's config with
                     ``fused_frozen_blocks`` resolved to 'on' or 'off'

Shapes are fixed per program, as in the JAX package's artifacts:
:class:`~irp_tpu_torch.infer.Predictor` pads every chunk to a rung, and
``Predictor.source_size`` refuses any other source size.

The weights ride outside the programs: each program takes them as one
dict input, every parameter and buffer of the model by name plus, when the
model runs K1, the BN-folded weights of its fusable blocks (K1 reads the
folded weights, which the model keeps outside its state_dict).  The loader
builds that dict once, folding on the device it loads to, so no forward
refolds and the ``.pt2`` members hold graphs alone.

``fused_frozen_blocks='auto'`` fuses on a CUDA input only, so export
resolves it on the device it traces on and writes 'on' or 'off': a program
exported on the CPU stays unfused on the card.  The ops dispatch by device,
so a program moved to another device (``torch.export.passes.
move_to_device_pass``) runs there: K1 and K2 launch on the card, their
plain versions run on the CPU.

A JAX-made ``.irpx`` (StableHLO, ``program.shlo``) is refused by name.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import tempfile
import time
import zipfile
from types import SimpleNamespace
from typing import Optional, Sequence

import torch

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import ModelConfig
from irp_tpu_torch.explain import cam_forward
from irp_tpu_torch.infer import Predictor, make_predictor, probs_forward
from irp_tpu_torch.models.resnet import Bottleneck
# the programs call the ops these modules register; loading one needs them
from irp_tpu_torch.ops import cuda_image, cuda_resnet  # noqa: F401
from irp_tpu_torch.train.checkpoint import load_weights_npz, save_model_npz

FORMAT_VERSION = 1
RUNTIME = "torch"
_PROGRAM_MEMBER = "program.pt2"
_BUCKET_MEMBER_FMT = "program.b{}.pt2"
_EXPLAIN_MEMBER = "explain.pt2"
_WEIGHTS_MEMBER = "weights.npz"
_META_MEMBER = "meta.json"
_JAX_PROGRAM_MEMBER = "program.shlo"
_FOLDED = "._folded."


def resolve_fused(model, device) -> bool:
    """Whether the model's forward on ``device`` runs K1: a ResNet whose
    ``fused_frozen_blocks`` mode is active there, with fusable blocks
    (the other families never run it)."""
    if model.config.family != "resnet":
        return False
    probe = torch.empty(0, device=device)
    return model.backbone.fuse_active(probe) and any(
        isinstance(m, Bottleneck) and m.fusable for m in model.modules())


def program_inputs(model, fused: bool) -> dict:
    """The dict an exported program takes beside its images: every
    parameter and buffer of ``model`` by state name and, when ``fused``,
    the BN-folded weights of each fusable block (``cache_folded_weights``
    must have run) as ``<block>._folded.<i>``."""
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    if fused:
        for name, mod in model.named_modules():
            if isinstance(mod, Bottleneck) and mod.fusable:
                if mod._folded is None:
                    raise ValueError(f"{name} has no folded weights; call "
                                     "cache_folded_weights() first")
                for i, t in enumerate(mod._folded):
                    out[f"{name}{_FOLDED}{i}"] = t
    return out


class _Holder(torch.nn.Module):
    """Runs ``fn(model, *inputs)`` with ``model`` as a submodule, so that
    ``torch.func.functional_call`` can swap its tensors."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, *inputs):
        return self._fn(self.model, *inputs)


class _Program(torch.nn.Module):
    """The module an ``.irpx`` program is exported from: ``forward(weights,
    images_u8[, class_idx])``.  It owns no tensors (a copy of the model is
    held outside its state), so the program takes every weight from
    ``weights``."""

    def __init__(self, model, fn):
        super().__init__()
        self._held = (_Holder(copy.deepcopy(model), fn),)

    def forward(self, weights: dict, images_u8: torch.Tensor,
                class_idx: Optional[torch.Tensor] = None):
        holder = self._held[0]
        state, folded = {}, {}
        for key, t in weights.items():
            if _FOLDED in key:
                block, i = key.split(_FOLDED)
                folded.setdefault(block, {})[int(i)] = t
            else:
                state[f"model.{key}"] = t
        for name, mod in holder.model.named_modules():
            if isinstance(mod, Bottleneck):
                parts = folded.get(name)
                mod._folded = (None if parts is None else
                               tuple(parts[i] for i in range(len(parts))))
        inputs = (images_u8,) if class_idx is None else (images_u8,
                                                         class_idx)
        return torch.func.functional_call(holder, state, inputs)


def _export(model, fn, weights, inputs):
    """``torch.export`` of ``fn(model, *inputs)`` with ``model``'s tensors
    taken from ``weights``.  Traced without autograd, so that the frozen
    stages' ``set_grad_enabled(False)`` leaves no grad-mode region in the
    graph.  The dtype and device assertion export adds before each cast
    (a host call per cast at every run) is dropped: the graph's inputs
    come from :func:`program_inputs`."""
    program = _Program(model, fn)
    with torch.no_grad():
        ep = torch.export.export(program, (weights, *inputs), strict=False)
    for node in list(ep.graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            ep.graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


def _save(ep) -> bytes:
    ep.example_inputs = None  # the weights: weights.npz carries them once
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_predictor(predictor, path: str, source_size: Optional[int] = None,
                     gradcam: bool = True,
                     gradcam_batch_size: Optional[int] = None) -> str:
    """Write a live :class:`~irp_tpu_torch.infer.Predictor` as a ``.irpx``
    at ``path``; returns ``path``.

    The programs are traced on the predictor's device.  ``source_size``
    fixes the input geometry (default: the 256 cache contract, or the
    eval crop if larger; the CLIs decode to 256, so another size serves
    only through the Python API).  ``gradcam`` bakes the Grad-CAM program
    at ``gradcam_batch_size`` (default ``min(8, batch_size)``, the
    daemon's choice for live predictors).
    """
    if predictor.exported:
        raise ValueError(
            "this predictor was itself loaded from an exported artifact; "
            "re-export from the .npz/.pth weights instead of nesting "
            "programs")
    model = predictor.model
    cfg = model.config
    if source_size is None:
        source_size = max(256, cfg.image_size)
    if source_size < cfg.image_size:
        raise ValueError(f"source_size {source_size} is smaller than the "
                         f"model's eval crop {cfg.image_size}")
    cam_batch = None
    if gradcam:
        cam_batch = (min(8, predictor.batch_size) if gradcam_batch_size
                     is None else int(gradcam_batch_size))
        if cam_batch < 1:
            raise ValueError(f"gradcam_batch_size must be >= 1, got "
                             f"{cam_batch}")
    dev = predictor.device
    fused = resolve_fused(model, dev)
    weights = program_inputs(model, fused)

    def images(n):
        return torch.zeros((n, source_size, source_size, 3),
                           dtype=torch.uint8, device=dev)

    t0 = time.perf_counter()
    batches = [predictor.batch_size] + [
        int(b) for b in (predictor.pad_buckets or ())
        if b != predictor.batch_size]
    blobs = {}
    for i, n in enumerate(batches):
        member = _PROGRAM_MEMBER if i == 0 else _BUCKET_MEMBER_FMT.format(n)
        blobs[member] = _save(_export(
            model, functools.partial(probs_forward, tta=predictor.tta),
            weights, (images(n),)))
    if cam_batch is not None:
        cls = torch.full((cam_batch,), -1, dtype=torch.int64, device=dev)
        blobs[_EXPLAIN_MEMBER] = _save(_export(model, cam_forward, weights,
                                               (images(cam_batch), cls)))
    model_config = dataclasses.asdict(cfg)
    model_config["fused_frozen_blocks"] = "on" if fused else "off"
    meta = {
        "format": "irpx",
        "format_version": FORMAT_VERSION,
        "runtime": RUNTIME,
        "batch_size": int(predictor.batch_size),
        "source_size": int(source_size),
        "image_size": int(cfg.image_size),
        "num_classes": int(cfg.num_classes),
        "class_names": (list(predictor.class_names)
                        if predictor.class_names is not None else None),
        "gradcam_batch_size": cam_batch,  # None: no explain program
        "pad_buckets": (list(predictor.pad_buckets)
                        if predictor.pad_buckets is not None else None),
        "tta": bool(predictor.tta),
        "fused_frozen_blocks": model_config["fused_frozen_blocks"],
        "model_config": model_config,
        "exported_on": dev.type,
        "export_seconds": round(time.perf_counter() - t0, 3),
        "torch_version": torch.__version__,
    }
    tmp = path + ".tmp"
    try:
        with tempfile.TemporaryDirectory() as td:
            npz = save_model_npz(os.path.join(td, "w.npz"), model,
                                 meta={"image_size": int(cfg.image_size)})
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
                zf.writestr(_META_MEMBER, json.dumps(meta, indent=1))
                for member, blob in blobs.items():
                    zf.writestr(member, blob)
                zf.write(npz, _WEIGHTS_MEMBER)
        os.replace(tmp, path)  # never leave a half-written artifact
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def read_export_meta(path: str) -> dict:
    """The artifact's ``meta.json``, without loading a program.  Raises
    ``ValueError`` for a file that is not an ``.irpx`` of this package,
    naming the JAX package's format when it is one of those."""
    try:
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            meta = json.loads(zf.read(_META_MEMBER))
    except (zipfile.BadZipFile, KeyError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: not a readable irpx artifact "
                         f"({e})") from e
    if meta.get("format") != "irpx":
        raise ValueError(f"{path}: not an irpx artifact")
    if meta.get("runtime") != RUNTIME:
        fmt = ("the JAX package's StableHLO format (program.shlo, "
               f"jax {meta.get('jax_version', '?')})"
               if _JAX_PROGRAM_MEMBER in names else
               f"runtime {meta.get('runtime')!r}")
        raise ValueError(
            f"{path}: an .irpx in {fmt}, which irp_tpu_torch does not run; "
            "export it again with irp_tpu_torch from the .npz weights it "
            "carries (weights.npz)")
    return meta


def tta_preflight_error(path: str, reexport_hint: str) -> Optional[str]:
    """None when the ``.irpx`` at ``path`` bakes TTA, else a one-line
    error (unreadable artifact, or exported without TTA): the CLIs'
    check for ``--tta`` on an artifact, reading only ``meta.json``."""
    try:
        baked = bool(read_export_meta(path).get("tta"))
    except (ValueError, OSError) as e:
        return str(e)
    if not baked:
        return ("this .irpx was exported without TTA; an .irpx program "
                "bakes TTA at export time — re-export from the .npz/.pth "
                f"weights with {reexport_hint}")
    return None


def _model_config(meta: dict) -> ModelConfig:
    fields = {f.name: f for f in dataclasses.fields(ModelConfig)}
    kw = {}
    for key, value in meta["model_config"].items():
        if key in fields:
            kw[key] = tuple(value) if isinstance(value, list) else value
    return ModelConfig(**kw)


def _load_program(blob: bytes, device: torch.device, weights: dict):
    """A callable ``(*inputs) -> outputs`` of one serialized program on
    ``device``, with ``weights`` bound: the program's graph called with its
    flat inputs, in the order its signature fixed at export."""
    from torch.export.graph_signature import InputKind
    from torch.utils._pytree import tree_flatten, tree_unflatten

    ep = torch.export.load(io.BytesIO(blob))
    on = {n.meta["val"].device.type for n in ep.graph.nodes
          if n.op == "placeholder" and isinstance(n.meta.get("val"),
                                                  torch.Tensor)}
    if on != {device.type}:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, str(device))
    if any(spec.kind != InputKind.USER_INPUT
           for spec in ep.graph_signature.input_specs):
        raise ValueError("an .irpx program holds tensors of its own; its "
                         "weights must all be inputs")
    n_inputs = len(ep.graph_signature.user_inputs) - len(weights)
    leaves, spec = tree_flatten(((weights,) + (0,) * n_inputs, {}))
    if spec != ep.call_spec.in_spec:
        raise ValueError("the program's weight names differ from the "
                         "artifact's weights")
    flat = leaves[:len(weights)]
    graph, out_spec = ep.graph_module, ep.call_spec.out_spec

    def call(*inputs):
        return tree_unflatten(list(graph(*flat, *inputs)), out_spec)

    return call


def load_exported_predictor(path: str,
                            class_names: Optional[Sequence[str]] = None,
                            device=None):
    """A :class:`~irp_tpu_torch.infer.Predictor` whose forward is the
    ``.irpx``'s program, on ``device`` (CUDA unless the caller asks for
    the CPU).  It scores as the exported predictor did (same padding, same
    preprocessing, inside the program) on sources of exactly the exported
    ``source_size``; Grad-CAM works when the artifact bakes its explain
    program.  ``fused_frozen_blocks`` of its ``model.config`` is the mode
    the programs were traced with."""
    dev = resolve_device(device)
    meta = read_export_meta(path)
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(f"{path}: format_version {meta['format_version']} "
                         f"is newer than this loader ({FORMAT_VERSION})")
    batch = int(meta["batch_size"])
    buckets = [int(b) for b in meta.get("pad_buckets") or ()]
    cam_batch = meta.get("gradcam_batch_size")
    try:
        with zipfile.ZipFile(path) as zf:
            blobs = {batch: zf.read(_PROGRAM_MEMBER)}
            for b in buckets:
                if b != batch:
                    blobs[b] = zf.read(_BUCKET_MEMBER_FMT.format(b))
            explain = (zf.read(_EXPLAIN_MEMBER)
                       if _EXPLAIN_MEMBER in zf.namelist() else None)
            with tempfile.TemporaryDirectory() as td:
                params, batch_stats, _ = load_weights_npz(
                    zf.extract(_WEIGHTS_MEMBER, td), with_meta=True)
    except (zipfile.BadZipFile, KeyError) as e:
        raise ValueError(f"{path}: not a readable irpx artifact "
                         f"({e})") from e
    cfg = _model_config(meta)
    fused = cfg.fused_frozen_blocks == "on"
    # the weights dict, laid out as the live predictor's (device,
    # channels_last, folded on this device); the model itself is dropped
    live = make_predictor({"params": params, "batch_stats": batch_stats},
                          cfg=cfg, batch_size=batch, device=dev)
    weights = program_inputs(live.model, fused)
    programs = {b: _load_program(blob, dev, weights)
                for b, blob in blobs.items()}
    # a 'highest' model's convs run without TF32 on the card, as the live
    # model's precision_scope has them: the flag is the caller's state,
    # not the graph's
    highest = cfg.precision == "highest" and dev.type == "cuda"

    def scope():
        if not highest:
            return contextlib.nullcontext()
        return torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False)

    def forward(images_u8):
        with scope():
            return programs[int(images_u8.shape[0])](images_u8)

    cam_call = None
    if explain is not None and cam_batch is not None:
        cam_program = _load_program(explain, dev, weights)

        def cam_call(images_u8, class_idx):
            with scope():
                return cam_program(images_u8, class_idx)

    names = class_names if class_names is not None else meta["class_names"]
    return Predictor(
        model=SimpleNamespace(config=cfg), class_names=names,
        batch_size=batch, pad_buckets=tuple(buckets) if buckets else None,
        tta=bool(meta.get("tta", False)), device=dev,
        source_size=int(meta["source_size"]), _program=forward,
        _cam_call=cam_call,
        _cam_batch_size=int(cam_batch) if cam_call is not None else None)
