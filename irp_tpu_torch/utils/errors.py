"""Error classification shared by the sweep's fallbacks."""

from __future__ import annotations

import torch


def is_oom_error(exc: BaseException) -> bool:
    """True when ``exc`` is the card running out of memory:
    ``torch.cuda.OutOfMemoryError``, or a ``RuntimeError`` whose text says
    "CUDA out of memory" (cuDNN and some kernels raise it so)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and \
        "cuda out of memory" in str(exc).lower()
