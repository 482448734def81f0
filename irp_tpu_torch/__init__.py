"""irp_tpu_torch — the PyTorch/CUDA port of irp_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports torch and never
jax or irp_tpu.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.  The hand-written kernels live in ``csrc/`` and
are built with nvcc at first use (``_kernels.py``).
"""

from irp_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, ModelConfig

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "ModelConfig"]
__version__ = "0.1.0"
