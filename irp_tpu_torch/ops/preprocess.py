"""Eval-path preprocessing (the JAX package's ``ops/preprocess.py``).

The training augmentations come with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from irp_tpu_torch.ops.cuda_image import eval_preprocess


def eval_preprocess_batch(images_u8: torch.Tensor, out_size: int = 224,
                          dtype=torch.bfloat16,
                          mean: Sequence[float] = IMAGENET_MEAN,
                          std: Sequence[float] = IMAGENET_STD
                          ) -> torch.Tensor:
    """Eval path: CenterCrop(out_size) + ImageNet normalize, from the
    (B, 256, 256, 3) uint8 cache geometry to (B, out, out, 3) ``dtype``.

    A CPU tensor runs the plain version, a CUDA tensor the kernel
    (``ops/cuda_image.py``).
    """
    return eval_preprocess(images_u8, out_size, mean, std, dtype)
