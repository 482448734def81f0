"""Batched inference for trained classifiers (the JAX package's
``infer.py``).

- Load a weights artifact of any of the four families (ResNet, ViT,
  EfficientNet, ConvNeXt): an ``.npz`` (``train/checkpoint.py``, written
  by either package) or a torch ``.pth`` state_dict (torchvision names,
  ``classifier.{1,4}`` head).
- The architecture is inferred from the weight tree itself.
- Preprocessing is the eval contract used at training time: center crop +
  ImageNet normalize from the 256x256 cache geometry
  (``ops/preprocess.py``; the CUDA kernel on the card).
- Requests of any size are cut into ``batch_size`` chunks and each chunk is
  padded to the smallest allowed bucket, as the JAX package does for its
  compiled shapes, so both packages score the same padded batches.
- The forward runs on CUDA unless the caller asks for the CPU, under
  ``torch.inference_mode()``.
- An ``.irpx`` artifact (``export.py``) loads as a Predictor whose forward
  is the exported program, at the batch and source size it was exported
  with (``source_size``); its Grad-CAM program, when it has one, serves
  ``explain.GradCAM``.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, ModelConfig

_BASIC_DEPTHS = {(2, 2, 2, 2): 18, (3, 4, 6, 3): 34}
_BOTTLENECK_DEPTHS = {(3, 4, 6, 3): 50, (3, 4, 23, 3): 101, (3, 8, 36, 3): 152}
_LATER = ("is not ported yet (ROADMAP.md, Queue 1, A14: replicas and "
          "data-parallel serving are parallelism)")


def softmax_np(logits: np.ndarray) -> np.ndarray:
    """Stable host-side softmax over the last axis (float32)."""
    logits = np.asarray(logits, np.float32)
    exps = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return (exps / exps.sum(axis=-1, keepdims=True)).astype(np.float32)


def input_dtype(cfg: ModelConfig) -> torch.dtype:
    """The dtype eval preprocessing hands the model: bf16 for a bf16
    model, else float32 (as the JAX package's predictor)."""
    return (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
            else torch.float32)


def probs_forward(model, images_u8: torch.Tensor,
                  tta: bool = False) -> torch.Tensor:
    """The predictor's forward: (B, H, W, 3) uint8 on the model's device
    -> (B, K) float32 softmax.  Eval preprocess (K2 on the card), the
    model (for a ResNet, K1 in its frozen identity blocks on the card),
    softmax; with
    ``tta`` the mean of the identity's and the horizontal flip's."""
    from irp_tpu_torch.ops.preprocess import eval_preprocess_batch

    cfg = model.config
    x = eval_preprocess_batch(images_u8, cfg.image_size, input_dtype(cfg),
                              IMAGENET_MEAN, IMAGENET_STD)
    x = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory
    p = torch.softmax(model(x).float(), dim=-1)
    if tta:
        # flip W; the center crop is symmetric, so this equals flipping
        # the source
        p = 0.5 * (p + torch.softmax(model(x.flip(3)).float(), dim=-1))
    return p


def infer_model_config(params: dict, image_size: int = 224,
                       compute_dtype: str = "bfloat16",
                       fused_frozen_blocks: str = "off") -> ModelConfig:
    """Reconstruct the ModelConfig a weight tree was trained with.

    ``params`` is the flax-layout tree an ``.npz`` stores.  ResNet: depth
    from the per-stage block counts and the block type (conv3 =>
    bottleneck), ResNeXt/Wide widths from the first block's conv shapes.
    ViT (a ``class_token``): patch, embed and mlp widths and the layer
    count from leaf shapes, the input size from the pos_embedding length
    (it overrides ``image_size``), heads embed // 64.  EfficientNet (a
    ``stem_conv``): matched against the B0-B7 ladder by structure.
    ConvNeXt (a ``stem_ln``, checked first: it has a ``stem_conv`` too):
    per-stage dims and depths from the block tree.  Head widths and the
    class count come from the head kernels.
    """
    backbone = params["backbone"]
    head = dict(hidden_dim=int(np.shape(params["head_dense1"]["kernel"])[1]),
                num_classes=int(np.shape(params["head_dense2"]["kernel"])[1]),
                compute_dtype=compute_dtype,
                fused_frozen_blocks=fused_frozen_blocks)
    if "stem_ln" in backbone:
        return _infer_convnext_config(backbone, image_size, head)
    if "stem_conv" in backbone:
        return _infer_efficientnet_config(backbone, image_size, head)
    if "class_token" in backbone:
        return _infer_vit_config(backbone, head)
    counts = [0, 0, 0, 0]
    bottleneck = False
    for key in backbone:
        if key.startswith("layer") and "_block" in key:
            stage, _ = key.split("_block")
            counts[int(stage[len("layer"):]) - 1] += 1
            bottleneck = bottleneck or "conv3" in backbone[key]
    table = _BOTTLENECK_DEPTHS if bottleneck else _BASIC_DEPTHS
    depth = table.get(tuple(counts))
    if depth is None:
        raise ValueError(f"unrecognized ResNet stage sizes {counts} "
                         f"(bottleneck={bottleneck})")
    groups, width_per_group = 1, 64
    if bottleneck:
        block0 = backbone["layer1_block0"]
        width = int(np.shape(block0["conv1"]["kernel"])[-1])
        in_per_group = int(np.shape(block0["conv2"]["kernel"])[2])
        groups = width // in_per_group
        width_per_group = width // groups
    return ModelConfig(depth=depth, image_size=image_size, groups=groups,
                       width_per_group=width_per_group, **head)


def _infer_vit_config(backbone: dict, head: dict) -> ModelConfig:
    embed = int(np.shape(backbone["class_token"])[-1])
    patch = int(np.shape(backbone["conv_proj"]["kernel"])[0])
    n_layers = sum(1 for k in backbone if k.startswith("block"))
    mlp_dim = int(np.shape(backbone["block0"]["mlp_dense1"]["kernel"])[1])
    seq = int(np.shape(backbone["pos_embedding"])[1])
    grid = int(round((seq - 1) ** 0.5))
    if grid * grid != seq - 1:
        raise ValueError(
            f"pos_embedding length {seq} is not a square grid + CLS")
    # the pos_embedding pins the geometry: trust the weights
    return ModelConfig(family="vit", patch_size=patch, embed_dim=embed,
                       num_layers=n_layers, mlp_dim=mlp_dim,
                       image_size=grid * patch, **head)


def _infer_convnext_config(backbone: dict, image_size: int,
                           head: dict) -> ModelConfig:
    depths = [0, 0, 0, 0]
    dims = [0, 0, 0, 0]
    for key in backbone:
        m = re.fullmatch(r"stage(\d)_block(\d+)", key)
        if m:
            s = int(m.group(1))
            if not 1 <= s <= 4:
                raise ValueError(f"unrecognized ConvNeXt stage in {key!r}")
            depths[s - 1] += 1
            dims[s - 1] = int(
                np.shape(backbone[key]["dw_conv"]["kernel"])[-1])
    if not all(depths):
        raise ValueError(f"incomplete ConvNeXt stage tree "
                         f"(block counts {depths})")
    return ModelConfig(family="convnext", convnext_dims=tuple(dims),
                       convnext_depths=tuple(depths), image_size=image_size,
                       **head)


def _infer_efficientnet_config(backbone: dict, image_size: int,
                               head: dict) -> ModelConfig:
    """Match the tree's per-stage block counts, stem, top and per-stage
    widths against each named variant's scaled table."""
    from irp_tpu_torch.models.efficientnet import (EFFICIENTNET_VARIANTS,
                                                   STAGE_COUNT,
                                                   scaled_setting,
                                                   top_channels)

    counts = [0] * STAGE_COUNT
    for key in backbone:
        if key.startswith("stage") and "_block" in key:
            counts[int(key.split("_block")[0][len("stage"):]) - 1] += 1
    stem_ch = int(np.shape(backbone["stem_conv"]["kernel"])[-1])
    top_ch = int(np.shape(backbone["top_conv"]["kernel"])[-1])
    stage_out = [int(np.shape(
        backbone[f"stage{s + 1}_block0"]["project_conv"]["kernel"])[-1])
        for s in range(STAGE_COUNT)]
    for v in EFFICIENTNET_VARIANTS.values():
        wm, dm = v["width_mult"], v["depth_mult"]
        setting = scaled_setting(wm, dm)
        if (counts == [s[5] for s in setting]
                and stem_ch == setting[0][3]
                and stage_out == [s[4] for s in setting]
                and top_ch == top_channels(wm)):
            return ModelConfig(family="efficientnet", width_mult=wm,
                               depth_mult=dm, image_size=image_size, **head)
    raise ValueError(
        f"EfficientNet weight tree matches no named B0-B7 variant "
        f"(stage blocks {counts}, stem {stem_ch}, top {top_ch}); "
        f"non-standard width/depth multipliers need an explicit "
        f"ModelConfig")


@dataclass
class PredictionResult:
    """Scored batch: argmax labels + full softmax probabilities."""

    labels: np.ndarray                     # (N,) int32
    probs: np.ndarray                      # (N, num_classes) float32
    class_names: Optional[Sequence[str]] = None
    keys: Optional[List[str]] = None       # file paths / shard keys

    def __len__(self):
        return int(self.labels.shape[0])

    def topk(self, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """(indices (N,k), probabilities (N,k)), descending."""
        k = min(k, self.probs.shape[1])
        idx = np.argsort(-self.probs, axis=1)[:, :k]
        return idx, np.take_along_axis(self.probs, idx, axis=1)

    def label_names(self) -> List[str]:
        if self.class_names is None:
            return [str(i) for i in self.labels]
        return [self.class_names[i] for i in self.labels]


@dataclass
class Predictor:
    """An eval-mode classifier forward over padded batches on ``device``.

    Build via :func:`load_predictor` (from a weights artifact) or
    :func:`make_predictor` (from in-memory variables).  ``pad_buckets``:
    allowed padded batch sizes (ascending, last == batch_size); a chunk
    of n images pads to the smallest bucket >= n.  ``tta`` averages the
    softmax over the identity and the horizontal flip.

    A predictor from an ``.irpx`` (``export.load_exported_predictor``) has
    ``_program`` set, the exported forward ((B, S, S, 3) uint8 on the
    device -> probabilities), and ``source_size`` S: its shapes are fixed
    and its ``model`` carries only the ``config``; ``_cam_call`` is its
    baked Grad-CAM program, if any, at ``_cam_batch_size``.
    """

    model: torch.nn.Module
    class_names: Optional[Sequence[str]] = None
    batch_size: int = 256
    pad_buckets: Optional[Tuple[int, ...]] = None
    tta: bool = False
    device: Optional[object] = None
    source_size: Optional[int] = None
    _program: object = field(default=None, repr=False)
    _cam_call: object = field(default=None, repr=False)
    _cam_batch_size: Optional[int] = field(default=None, repr=False)

    def __post_init__(self):
        if self.class_names is not None:
            n = self.model.config.num_classes
            if len(self.class_names) != n:
                raise ValueError(f"{len(self.class_names)} class names "
                                 f"for a {n}-class model")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got "
                             f"{self.batch_size}")
        if self.pad_buckets is not None:
            buckets = tuple(sorted(int(b) for b in self.pad_buckets))
            if (not buckets or buckets[0] < 1
                    or buckets[-1] != self.batch_size
                    or len(set(buckets)) != len(buckets)):
                raise ValueError(
                    f"pad_buckets must be distinct sizes in [1, "
                    f"batch_size] ending at batch_size={self.batch_size}, "
                    f"got {self.pad_buckets}")
            self.pad_buckets = buckets
        self.device = resolve_device(self.device)
        if self.exported:
            # the program fixes its shapes and its preprocessing; ``tta``
            # only records whether it flip-averages
            return
        self.model = self.model.to(device=self.device,
                                   memory_format=torch.channels_last).eval()
        if self.model.config.family == "resnet":
            self.model.backbone.cache_folded_weights()

    @property
    def num_classes(self) -> int:
        return self.model.config.num_classes

    @property
    def exported(self) -> bool:
        """Whether the forward is an exported program (an ``.irpx``)."""
        return self._program is not None

    def _forward(self, chunk: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            images = torch.from_numpy(chunk).to(self.device)
            if self.exported:
                p = self._program(images)
            else:
                p = probs_forward(self.model, images, self.tta)
            return p.cpu().numpy()

    def predict_probs(self, images_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, num_classes) float32 softmax.

        N is arbitrary: each chunk of ``batch_size`` is padded (with its
        last image) to its bucket and the pad rows are dropped.
        """
        images_u8 = np.asarray(images_u8, np.uint8)
        if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
            raise ValueError(f"expected (N,H,W,3) uint8, got {images_u8.shape}")
        out_size = self.model.config.image_size
        h, w = images_u8.shape[1:3]
        if h < out_size or w < out_size:
            raise ValueError(
                f"images are {h}x{w} but the model's eval crop is "
                f"{out_size}x{out_size}; supply sources at least that "
                "large (the cache contract decodes to 256x256, "
                "data/pipeline.py::decode_to_rgb256)")
        if (self.source_size is not None
                and (h, w) != (self.source_size, self.source_size)):
            raise ValueError(
                f"this exported program requires sources of exactly "
                f"{self.source_size}x{self.source_size}, got {h}x{w} "
                "(re-export with a different source_size, or decode to "
                "the cache geometry first)")
        n = images_u8.shape[0]
        if n == 0:
            return np.zeros((0, self.num_classes), np.float32)
        out = []
        for start in range(0, n, self.batch_size):
            chunk = images_u8[start:start + self.batch_size]
            target = self._pad_target(chunk.shape[0])
            if chunk.shape[0] < target:
                pad = np.broadcast_to(
                    chunk[-1:], (target - chunk.shape[0],) + chunk.shape[1:])
                chunk = np.concatenate([chunk, pad], axis=0)
            out.append(self._forward(np.ascontiguousarray(chunk)))
        return np.concatenate(out, axis=0)[:n]

    def _pad_target(self, n: int) -> int:
        """The padded batch size for an n-image chunk: the smallest
        allowed bucket >= n, else batch_size."""
        if self.pad_buckets is not None:
            for b in self.pad_buckets:
                if b >= n:
                    return b
        return self.batch_size

    def _result(self, probs: np.ndarray,
                keys: Optional[List[str]]) -> PredictionResult:
        return PredictionResult(
            labels=np.argmax(probs, axis=1).astype(np.int32), probs=probs,
            class_names=self.class_names, keys=keys)

    def predict(self, images_u8: np.ndarray,
                keys: Optional[List[str]] = None) -> PredictionResult:
        return self._result(self.predict_probs(images_u8), keys)

    def decode_paths(self, paths: Sequence[str],
                     decoder: str = "auto") -> np.ndarray:
        """Read and decode image files to the cache geometry
        (N, 256, 256, 3), 256x256 bilinear as
        ``data/pipeline.py::decode_blobs``, so that files score as
        cached training data does: ``decoder`` 'auto' takes the native
        batch decoder with PIL for what it cannot decode, 'pil' PIL
        only."""
        from irp_tpu_torch.data.pipeline import decode_blobs

        blobs = []
        for path in paths:
            with open(path, "rb") as f:
                blobs.append(f.read())
        return decode_blobs(blobs, decoder=decoder)

    def _chunk(self) -> int:
        """Images decoded at a time: host memory stays O(chunk), not
        O(dataset)."""
        return max(self.batch_size, 1024)

    def _probs(self, parts: List[np.ndarray]) -> np.ndarray:
        return (np.concatenate(parts, axis=0) if parts
                else np.zeros((0, self.num_classes), np.float32))

    def predict_paths(self, paths: Sequence[str],
                      decoder: str = "auto") -> PredictionResult:
        """Score image files (JPEG/PNG/...), decoded as
        :meth:`decode_paths` says, in chunks of :meth:`_chunk` images."""
        paths = list(paths)
        chunk = self._chunk()
        parts = [self.predict_probs(self.decode_paths(
            paths[start:start + chunk], decoder=decoder))
            for start in range(0, len(paths), chunk)]
        return self._result(self._probs(parts), paths)

    def _label_index(self, cls: Optional[bytes]) -> Optional[int]:
        """A shard's ``cls`` as a class index: an integer as written, or a
        class name (what the curation writer stores) looked up in
        ``class_names``; None when neither applies."""
        if cls is None:
            return None
        text = cls.decode("utf-8").strip()
        try:
            return int(text)
        except ValueError:
            pass
        if self.class_names is not None and text in self.class_names:
            return list(self.class_names).index(text)
        return None

    def predict_shards(self, shard_paths: Sequence[str] | str,
                       decoder: str = "auto"
                       ) -> Tuple[PredictionResult, Optional[np.ndarray]]:
        """Score a WebDataset shard set: (result, true labels), the labels
        from the shards' ``cls`` stream when every sample has one that
        :meth:`_label_index` reads, else None.  A string is a literal
        path when that file exists (``[`` is a legal file name
        character), else a glob; samples without an image are
        skipped."""
        from irp_tpu_torch.data.pipeline import decode_blobs
        from irp_tpu_torch.data.tar import iter_samples

        if isinstance(shard_paths, str):
            if os.path.exists(shard_paths):
                shard_paths = [shard_paths]
            elif any(c in shard_paths for c in "*?["):
                # an unmatched glob means zero samples, not a literal path
                import glob as globmod

                shard_paths = sorted(globmod.glob(shard_paths))
            else:
                shard_paths = [shard_paths]

        chunk = self._chunk()
        blobs, keys, truths, parts = [], [], [], []
        have_truth = True

        def flush():
            if blobs:
                parts.append(self.predict_probs(decode_blobs(
                    blobs, decoder=decoder)))
                blobs.clear()

        for sample in iter_samples(shard_paths):
            jpg = sample.get("jpg") or sample.get("jpeg") or sample.get("png")
            if jpg is None:
                continue
            keys.append(str(sample.get("__key__", "")))
            label = self._label_index(sample.get("cls"))
            if label is None:
                have_truth = False
            else:
                truths.append(label)
            blobs.append(jpg)
            if len(blobs) >= chunk:
                flush()
        flush()
        if not keys:
            return self._result(self._probs([]), []), None
        truth = (np.asarray(truths, np.int32)
                 if have_truth and len(truths) == len(keys) else None)
        return self._result(self._probs(parts), keys), truth


def power_of_two_buckets(max_batch: int) -> Tuple[int, ...]:
    """The 1,2,4,...,max_batch padded-size ladder (max included even when
    not a power of two)."""
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_batch))
    return tuple(buckets)


def serving_buckets(spec: str, batch_size: int,
                    n_data: int = 1) -> Tuple[int, ...]:
    """Resolve a ``--batch-buckets`` spec (``'auto'`` or a comma list) into
    a padded-size ladder whose every rung splits ``n_data`` ways."""
    if spec == "auto":
        if batch_size % n_data:
            raise ValueError(
                f"batch size {batch_size} does not split over the "
                f"{n_data}-way data axis")
        return tuple(n_data * b
                     for b in power_of_two_buckets(batch_size // n_data))
    buckets = tuple(int(b) for b in spec.split(","))
    bad = [b for b in buckets if b % n_data]
    if bad:
        raise ValueError(
            f"buckets {bad} do not split over the {n_data}-way data axis "
            f"(every bucket must be a multiple of {n_data})")
    return buckets


def replicate_predictor(pred: Predictor, devices=None,
                        n: Optional[int] = None) -> List[Predictor]:
    """One predictor per device: not in this slice."""
    raise NotImplementedError(f"replicate_predictor {_LATER}")


def make_predictor(variables: dict,
                   class_names: Optional[Sequence[str]] = None,
                   cfg: Optional[ModelConfig] = None, batch_size: int = 256,
                   mesh=None, image_size: Optional[int] = None,
                   pad_buckets: Optional[Sequence[int]] = None,
                   tta: bool = False, device=None,
                   fused_frozen_blocks: str = "off") -> Predictor:
    """Predictor from an in-memory ``{'params', 'batch_stats'}`` tree.

    ``image_size`` sets the eval crop when ``cfg`` is inferred from the
    weight tree; ``fused_frozen_blocks`` likewise applies only to an
    inferred config ('off', the JAX package's unfused forward, unless the
    caller asks for 'auto' or 'on').  Both are ignored when an explicit
    ``cfg`` is given.
    """
    from irp_tpu_torch.models.classifier import Classifier
    from irp_tpu_torch.models.convert import jax_variables_to_state_dict

    if mesh is not None:
        raise NotImplementedError(f"mesh= (data-parallel serving) {_LATER}")
    dev = resolve_device(device)
    params = variables["params"]
    if cfg is None:
        cfg = infer_model_config(params, image_size=image_size or 224,
                                 fused_frozen_blocks=fused_frozen_blocks)
    model = Classifier(cfg)
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg.depth))
    return Predictor(model=model, class_names=class_names,
                     batch_size=batch_size,
                     pad_buckets=(tuple(pad_buckets) if pad_buckets
                                  is not None else None),
                     tta=tta, device=dev)


def load_predictor(weights_path: str,
                   class_names: Optional[Sequence[str]] = None,
                   cfg: Optional[ModelConfig] = None,
                   batch_size: int = 256, mesh=None,
                   image_size: Optional[int] = None,
                   pad_buckets: Optional[Sequence[int]] = None,
                   tta: bool = False, device=None,
                   fused_frozen_blocks: str = "off") -> Predictor:
    """Predictor from a weights artifact on ``device`` (CUDA unless the
    caller asks for the CPU; with no card, asking for CUDA raises).

    ``.npz`` = ``save_weights_npz`` output of either package; ``.pt/.pth``
    = a torch state_dict of any family with a ``classifier.{1,4}`` head
    (torchvision names, ``models/convert.py``).  A
    backbone-only checkpoint is rejected: a random head must never serve.
    The eval crop comes from (highest wins) ``cfg``, ``image_size``, the
    npz's ``image_size`` metadata, then 224.

    ``.irpx`` = an artifact of this package's ``export.py``: its programs
    fix the batch, the source size, the crop, TTA and the resolved
    ``fused_frozen_blocks``, so ``cfg``, ``image_size``, ``batch_size``
    and ``fused_frozen_blocks`` are not read; ``pad_buckets`` is refused
    (the artifact serves its own ladder) and ``tta`` is refused unless
    the artifact bakes it.
    """
    if mesh is not None:
        raise NotImplementedError(f"mesh= (data-parallel serving) {_LATER}")
    dev = resolve_device(device)
    ext = os.path.splitext(weights_path)[1].lower()
    if ext == ".irpx":
        from irp_tpu_torch.export import (load_exported_predictor,
                                          tta_preflight_error)

        if pad_buckets is not None:
            raise ValueError(
                "an .irpx serves only the pad_buckets ladder baked at "
                "export time (export a predictor built with "
                "pad_buckets=...); load-time buckets need the live weights "
                "(.npz/.pth)")
        if tta:
            err = tta_preflight_error(weights_path,
                                      "a predictor built with tta=True")
            if err:
                raise ValueError(err)
        return load_exported_predictor(weights_path, class_names=class_names,
                                       device=dev)
    if ext == ".npz":
        from irp_tpu_torch.train.checkpoint import load_weights_npz

        params, batch_stats, meta = load_weights_npz(weights_path,
                                                     with_meta=True)
        variables = {"params": params, "batch_stats": batch_stats}
        if image_size is None and meta.get("image_size") is not None:
            image_size = int(meta["image_size"])
    elif ext in (".pth", ".pt"):
        from irp_tpu_torch.models.convert import state_dict_to_jax_variables

        state = torch.load(weights_path, map_location="cpu",
                           weights_only=True)
        variables = state_dict_to_jax_variables(state)
    else:
        raise ValueError(f"unsupported weights format: {weights_path} "
                         "(expected .npz, .pth or .irpx)")
    if "head_dense2" not in variables["params"]:
        raise ValueError(
            f"{weights_path} has no classifier head — it is a backbone-only "
            "checkpoint; serve a trained final-weights artifact instead")
    return make_predictor(variables, class_names=class_names, cfg=cfg,
                          batch_size=batch_size, mesh=mesh,
                          image_size=image_size, pad_buckets=pad_buckets,
                          tta=tta, device=dev,
                          fused_frozen_blocks=fused_frozen_blocks)


def load_class_names(spec: str) -> List[str]:
    """Class names from a JSON file (list, or dict with 'class_names') or a
    comma-separated literal."""
    if os.path.exists(spec):
        with open(spec) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data.get("class_names", data.get("classes"))
        if not isinstance(data, list):
            raise ValueError(f"{spec}: expected a JSON list of class names")
        return [str(x) for x in data]
    return [s.strip() for s in spec.split(",") if s.strip()]
