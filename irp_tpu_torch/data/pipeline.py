"""Image decoding to the cache geometry and the decoded dataset (the JAX
package's ``data/pipeline.py``, decode part and ``CachedDataset``).

Decoding goes through PIL; the native batch JPEG decoder comes with a
later slice, so ``decoder='auto'`` and ``'pil'`` both use PIL here.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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


@dataclass
class CachedDataset:
    """Decoded uint8 dataset (memmap-backed) + labels + metadata.

    The JAX package's class also tracks each sample's source shard for
    k-fold splits; that part comes with the training slice.
    """

    images: np.ndarray  # (N, 256, 256, 3) uint8
    labels: np.ndarray  # (N,) int32
    keys: List[str]
    class_names: Tuple[str, ...]

    def __len__(self):
        return len(self.labels)
