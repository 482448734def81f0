"""Image decoding to the cache geometry (the JAX package's
``data/pipeline.py``, decode part).

Decoding goes through PIL; the native batch JPEG decoder comes with a
later slice, so ``decoder='auto'`` and ``'pil'`` both use PIL here.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np

CACHE_SIZE = 256  # everything downstream starts from Resize((256, 256))


def decode_to_rgb256(jpg_bytes: bytes, size: int = CACHE_SIZE) -> np.ndarray:
    """Image bytes -> (size, size, 3) uint8, PIL bilinear resize."""
    from PIL import Image

    img = Image.open(io.BytesIO(jpg_bytes))
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def decode_blobs(blobs: Sequence[bytes], size: int = CACHE_SIZE,
                 out: Optional[np.ndarray] = None,
                 decoder: str = "auto") -> np.ndarray:
    """Decode image byte strings to (N, size, size, 3) uint8, into ``out``
    when given."""
    if decoder not in ("auto", "pil"):
        raise ValueError(f"unknown decoder {decoder!r} (auto or pil)")
    n = len(blobs)
    if out is None:
        out = np.empty((n, size, size, 3), np.uint8)
    for j in range(n):
        out[j] = decode_to_rgb256(blobs[j], size)
    return out
