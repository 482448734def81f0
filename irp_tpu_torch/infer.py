"""Batched inference for trained classifiers (the JAX package's
``infer.py``).

- Load a weights artifact: an ``.npz`` (``train/checkpoint.py``, written
  by either package) or a torch ``.pth`` state_dict (torchvision ResNet
  names, ``classifier.{1,4}`` head).
- The architecture is inferred from the weight tree itself.
- Preprocessing is the eval contract used at training time: center crop +
  ImageNet normalize from the 256x256 cache geometry
  (``ops/preprocess.py``; the CUDA kernel on the card).
- Requests of any size are cut into ``batch_size`` chunks and each chunk is
  padded to the smallest allowed bucket, as the JAX package does for its
  compiled shapes, so both packages score the same padded batches.
- The forward runs on CUDA unless the caller asks for the CPU, under
  ``torch.inference_mode()``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from irp_tpu_torch._kernels import resolve_device
from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, ModelConfig

_BASIC_DEPTHS = {(2, 2, 2, 2): 18, (3, 4, 6, 3): 34}
_BOTTLENECK_DEPTHS = {(3, 4, 6, 3): 50, (3, 4, 23, 3): 101, (3, 8, 36, 3): 152}
_LATER = "is not ported yet (ROADMAP.md, Queue 1, A11: export and replicas)"


def softmax_np(logits: np.ndarray) -> np.ndarray:
    """Stable host-side softmax over the last axis (float32)."""
    logits = np.asarray(logits, np.float32)
    exps = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return (exps / exps.sum(axis=-1, keepdims=True)).astype(np.float32)


def infer_model_config(params: dict, image_size: int = 224,
                       compute_dtype: str = "bfloat16",
                       fused_frozen_blocks: str = "off") -> ModelConfig:
    """Reconstruct the ResNet ModelConfig a weight tree was trained with.

    ``params`` is the flax-layout tree an ``.npz`` stores.  Depth comes
    from the per-stage block counts and the block type (conv3 =>
    bottleneck), ResNeXt/Wide widths from the first block's conv shapes,
    head widths and class count from the head kernels.
    """
    backbone = params["backbone"]
    for probe, family in (("stem_ln", "convnext"), ("stem_conv",
                                                    "efficientnet"),
                          ("class_token", "vit")):
        if probe in backbone:
            raise NotImplementedError(
                f"a {family} weight tree: that family is not ported yet "
                f"(ROADMAP.md, Queue 1, A13)")
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
    hidden_dim = int(np.shape(params["head_dense1"]["kernel"])[1])
    num_classes = int(np.shape(params["head_dense2"]["kernel"])[1])
    return ModelConfig(depth=depth, num_classes=num_classes,
                       image_size=image_size, hidden_dim=hidden_dim,
                       groups=groups, width_per_group=width_per_group,
                       compute_dtype=compute_dtype,
                       fused_frozen_blocks=fused_frozen_blocks)


@dataclass
class PredictionResult:
    """Scored batch: argmax labels + full softmax probabilities."""

    labels: np.ndarray                     # (N,) int32
    probs: np.ndarray                      # (N, num_classes) float32
    class_names: Optional[Sequence[str]] = None

    def __len__(self):
        return int(self.labels.shape[0])


@dataclass
class Predictor:
    """An eval-mode classifier forward over padded batches on ``device``.

    Build via :func:`load_predictor` (from a weights artifact) or
    :func:`make_predictor` (from in-memory variables).  ``pad_buckets``:
    allowed padded batch sizes (ascending, last == batch_size); a chunk
    of n images pads to the smallest bucket >= n.  ``tta`` averages the
    softmax over the identity and the horizontal flip.
    """

    model: torch.nn.Module
    class_names: Optional[Sequence[str]] = None
    batch_size: int = 256
    pad_buckets: Optional[Tuple[int, ...]] = None
    tta: bool = False
    device: Optional[object] = None

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
        self.model = self.model.to(device=self.device,
                                   memory_format=torch.channels_last).eval()
        self.model.backbone.cache_folded_weights()
        cfg = self.model.config
        self._dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                       else torch.float32)

    @property
    def num_classes(self) -> int:
        return self.model.config.num_classes

    def _forward(self, chunk: np.ndarray) -> np.ndarray:
        from irp_tpu_torch.ops.preprocess import eval_preprocess_batch

        with torch.inference_mode():
            images = torch.from_numpy(chunk).to(self.device)
            x = eval_preprocess_batch(images, self.model.config.image_size,
                                      self._dtype, IMAGENET_MEAN,
                                      IMAGENET_STD)
            x = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory
            p = torch.softmax(self.model(x).float(), dim=-1)
            if self.tta:
                # flip W; the center crop is symmetric, so this equals
                # flipping the source
                p = 0.5 * (p + torch.softmax(self.model(x.flip(3)).float(),
                                             dim=-1))
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

    def predict(self, images_u8: np.ndarray) -> PredictionResult:
        probs = self.predict_probs(images_u8)
        return PredictionResult(
            labels=np.argmax(probs, axis=1).astype(np.int32), probs=probs,
            class_names=self.class_names)


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
                   fused_frozen_blocks: str = "auto") -> Predictor:
    """Predictor from an in-memory ``{'params', 'batch_stats'}`` tree.

    ``image_size`` sets the eval crop when ``cfg`` is inferred from the
    weight tree; ``fused_frozen_blocks`` likewise applies only to an
    inferred config.  Both are ignored when an explicit ``cfg`` is given.
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
                   fused_frozen_blocks: str = "auto") -> Predictor:
    """Predictor from a weights artifact on ``device`` (CUDA unless the
    caller asks for the CPU; with no card, asking for CUDA raises).

    ``.npz`` = ``save_weights_npz`` output of either package; ``.pt/.pth``
    = a torch ResNet state_dict with a ``classifier.{1,4}`` head.  A
    backbone-only checkpoint is rejected: a random head must never serve.
    The eval crop comes from (highest wins) ``cfg``, ``image_size``, the
    npz's ``image_size`` metadata, then 224.
    """
    dev = resolve_device(device)
    ext = os.path.splitext(weights_path)[1].lower()
    if ext == ".irpx":
        raise NotImplementedError(f".irpx artifacts: export {_LATER}")
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
                         "(expected .npz or .pth)")
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
