"""Configuration of the PyTorch port.

The port's own copy of the constants and of ``ModelConfig`` from the JAX
package's ``config.py``: the same fields with the same defaults, so that a
configuration means the same model in both packages.  Only the ResNet
family runs in this port so far; the other families' fields are kept so
that a configuration carries over unchanged.
"""

from __future__ import annotations

import dataclasses

# ImageNet normalization constants.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

FUSED_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """ResNet backbone + MLP-head classifier.

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
    compute_dtype: str = "bfloat16"  # params stay f32
    # 'default' or 'highest' (no TF32 in f32 convs and matmuls on CUDA).
    precision: str = "default"
    fused_frozen_blocks: str = "off"
    remat_trainable_blocks: bool = False
    pretrained_path: str | None = None
