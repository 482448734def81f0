"""Configuration of the PyTorch port.

The port's own copy of the constants and of ``DataConfig``,
``ModelConfig``, ``DatasetInfo`` and ``TrainConfig`` from the JAX
package's ``config.py``: the same fields with the same defaults, so that
a configuration means the same model and the same training run in both
packages.  All four families (ResNet, ViT, EfficientNet, ConvNeXt)
serve and train.  ``MeshConfig`` sizes the device mesh
(``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

# ImageNet normalization constants.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

IMAGE_SIZE = 224  # training/eval resolution (the crop)
EVAL_RESIZE = 256  # the eval path's Resize(256, 256): the cache geometry

FUSED_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    """Class inventory of a dataset.

    ``class_names`` are ordered by descending frequency (that order is the
    label <-> index mapping); ``class_weights`` are inverse-frequency
    ``n / (k * freq)``, aligned with ``class_names``.
    """

    num_classes: int
    class_names: tuple
    class_weights: tuple
    class_counts: tuple
    total_samples: int

    @property
    def name_to_index(self) -> Mapping[str, int]:
        return {n: i for i, n in enumerate(self.class_names)}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Shard paths + input pipeline settings.

    ``placement`` 'hbm' keeps the decoded dataset resident in device
    memory (``data/pipeline.py::HBMDataset``), 'stream' copies host batches
    to the device; ``cache_dir`` is where the decoded uint8 cache
    (``build_cache``) lives."""

    train_shards: tuple = ()
    test_shards: tuple = ()
    image_size: int = IMAGE_SIZE
    eval_resize: int = EVAL_RESIZE
    shuffle_buffer: int = 1000
    samples_per_shard: int = 1000
    mean: tuple = IMAGENET_MEAN
    std: tuple = IMAGENET_STD
    placement: str = "hbm"
    cache_dir: str | None = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone (``family``: 'resnet', 'vit', 'efficientnet' or
    'convnext') + MLP-head classifier.

    ``fused_frozen_blocks`` routes the frozen identity bottlenecks of a
    bottleneck ResNet through the hand-written CUDA kernel
    (``ops/cuda_resnet.py``): 'on' forces it (and rejects configurations
    it cannot serve), 'auto' uses it when the input lies on a CUDA device
    and the configuration is eligible, 'off' never.  On a CPU tensor the
    kernel's wrapper runs its plain PyTorch version.  The switch changes
    neither the parameter tree nor the numerics class (bf16 conv outputs).
    """

    family: str = "resnet"
    depth: int = 50  # 18/34/50/101/152
    num_classes: int = 10
    image_size: int = 224  # model input resolution (crop target)
    hidden_dim: int = 512
    patch_size: int = 16
    embed_dim: int = 768
    num_layers: int = 12
    mlp_dim: int = 3072
    num_heads: int = 0
    # ResNeXt / Wide-ResNet (torchvision parameterization).
    groups: int = 1
    width_per_group: int = 64
    width_mult: float = 1.0
    depth_mult: float = 1.0
    stochastic_depth: float = 0.2
    convnext_dims: tuple = (96, 192, 384, 768)
    convnext_depths: tuple = (3, 3, 9, 3)
    dropout_rate: float = 0.3
    # Frozen backbone except these stages ('layer1'..'layer4').
    trainable_stages: tuple = ("layer4",)
    head_only: bool = False
    # 'trainable_only': frozen stages' BN stays in inference form, even
    # under .train(); 'all': batch statistics everywhere in train mode.
    bn_stats_mode: str = "trainable_only"
    # params stay f32; 'float64' (the port only) is a reference precision
    # for checks: statistics, pool and logits stay in float64 too
    compute_dtype: str = "bfloat16"
    # 'default' or 'highest' (no TF32 in f32 convs and matmuls on CUDA).
    precision: str = "default"
    fused_frozen_blocks: str = "off"
    remat_trainable_blocks: bool = False
    pretrained_path: str | None = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization settings of a fine-tune (``train/fit.py``).

    - ``optimizer``: 'adam' (coupled L2: the decay enters the moments, as
      ``torch.optim.Adam(weight_decay=...)``), 'adamw' (decoupled decay)
      or 'sgd' (momentum 0.9, coupled L2).
    - ``schedule``: 'onecycle' (OneCycleLR with cosine annealing and
      torch's defaults), 'cosine' (CosineAnnealingLR, eta_min 0) or
      'constant'; ``scheduler_step`` 'batch' advances it per step, 'epoch'
      once per epoch.
    - ``train_samples_per_epoch`` / ``eval_samples``: subsampled epochs
      (None: the whole set).
    - ``mixup_alpha`` / ``cutmix_alpha``: batch mixing, 0 = off; with both
      set a fair coin per step picks the transform.
    - ``ema_decay`` > 0 tracks an EMA of the weights and of the BN running
      statistics; validation, the best snapshot and the returned weights
      then use it.
    - ``grad_accum_steps``: sequential micro-batches per optimizer step,
      each loss normalized by the full batch's denominator.
    - ``hbm_reshuffle``: re-permute the device-resident train set every
      epoch.
    """

    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    optimizer: str = "adam"  # adam | adamw | sgd
    schedule: str = "onecycle"  # onecycle | cosine | constant
    batch_size: int = 32
    max_epochs: int = 15
    patience: int = 4
    aug_intensity: str = "medium"  # low | medium | high
    train_samples_per_epoch: int | None = 1024
    eval_samples: int | None = 512
    steps_per_epoch_override: int | None = None
    scheduler_step: str = "batch"  # batch | epoch
    seed: int = 42
    label_smoothing: float = 0.0
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    ema_decay: float = 0.0
    grad_accum_steps: int = 1
    hbm_reshuffle: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: ``data`` devices (or processes) that split each
    batch, ``model`` devices (or processes) that split the head and the
    ViT and ConvNeXt blocks (Megatron tensor parallelism,
    ``parallel/mesh.py``)."""

    data: int = -1  # -1: every device on the data axis
    model: int = 1

    def axis_sizes(self, n_devices: int) -> tuple:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        return (data, model)


@dataclasses.dataclass(frozen=True)
class HyperoptConfig:
    """Settings of the k-fold study (``hyperopt/``), field for field the
    JAX package's.

    - ``first_fold_min_acc``: tier 2, the floor on fold 0's best accuracy.
    - ``pruner``: tier 1, 'median' (``MedianPruner(median_startup_trials,
      median_warmup_steps, 1)``), 'asha' (asynchronous successive
      halving) or 'none'.
    - ``progressive_min_trials`` / ``progressive_factor``: tier 3, prune
      when the running fold average falls below ``factor`` x the median of
      at least ``min_trials`` completed values.
    - ``confidence``: the one-sided t-distribution lower bound the
      objective returns.
    """

    n_trials: int = 200
    k_folds: int = 3
    first_fold_min_acc: float = 95.0
    pruner: str = "median"  # median | asha | none
    median_startup_trials: int = 20
    median_warmup_steps: int = 10
    asha_min_resource: int = 1  # first rung (epochs)
    asha_reduction_factor: int = 3  # keep the top 1/3 at each rung
    progressive_min_trials: int = 20
    progressive_factor: float = 0.85
    confidence: float = 0.80
    storage: str = "optuna_animals10_kfold.db"
    study_name: str = "animals10_kfold"
    seed: int = 42
