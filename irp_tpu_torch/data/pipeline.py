"""Image decoding, the decoded dataset and the device-resident data plane
(the JAX package's ``data/pipeline.py``).

- Decoding goes through PIL; the native batch JPEG decoder comes with a
  later slice, so ``decoder='auto'`` and ``'pil'`` both use PIL here.
- :class:`HBMDataset` keeps the uint8 train set on the device; each step
  reads a contiguous window (:class:`EpochSampler`), and the set is
  re-permuted on the device each epoch (``local_reshuffle``).  All
  permutations are numpy draws from the seed, as in the JAX package, so
  both packages see the same order.
- :class:`HBMEvalSet` keeps the capped eval set on the device, in order.
- :func:`iter_host_batches` and :func:`prefetch_to_device` are the stream
  path for a set that does not fit: host batches copied through pinned
  memory, the copy of batch t + 1 overlapping the compute on batch t.
"""

from __future__ import annotations

import collections
import io
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
    k-fold splits; that part comes with the k-fold data plane.
    """

    images: np.ndarray  # (N, 256, 256, 3) uint8
    labels: np.ndarray  # (N,) int32
    keys: List[str]
    class_names: Tuple[str, ...]

    def __len__(self):
        return len(self.labels)


class HBMDataset:
    """The cached train set resident on ``device`` as (N, H, W, 3) uint8,
    labels int64, globally permuted at build (``reshuffle``).

    The JAX package shards it over a mesh's data axis; the port runs on one
    device, so its one local shard (``local_count`` samples) is the set,
    and it draws the permutations the JAX package draws for one device.
    """

    def __init__(self, cached: CachedDataset, device,
                 shuffle_seed: int = 0):
        self.device = torch.device(device)
        self._cached = cached
        n = len(cached)
        self.n_total = n
        self.n_padded = n if n else 1
        self.local_count = self.n_padded
        self.px = cached.images.shape[1] if n else 0
        self.images = None
        self.labels = None
        self.reshuffle(shuffle_seed)

    def reshuffle(self, seed: int) -> None:
        """A host-side permutation from ``seed``, uploaded anew."""
        cached, n = self._cached, self.n_total
        rng = np.random.default_rng(seed)
        idx = (rng.permutation(self.n_padded) % max(n, 1) if n
               else np.zeros(self.n_padded, int))
        self.images = torch.from_numpy(
            np.ascontiguousarray(cached.images[idx])).to(self.device)
        self.labels = torch.from_numpy(
            cached.labels[idx].astype(np.int64)).to(self.device)

    def local_reshuffle(self, seed: int) -> None:
        """Re-permute the resident set on the device by a permutation drawn
        from ``seed`` (a gather: a second set-sized buffer lives while it
        runs)."""
        perm = np.random.default_rng(seed).permutation(self.local_count)
        perm = torch.from_numpy(perm).to(self.device)
        self.images = self.images[perm]
        self.labels = self.labels[perm]

    def window(self, offset: int, size: int):
        """The contiguous batch [offset, offset + size): (images, labels)."""
        return (self.images[offset:offset + size],
                self.labels[offset:offset + size])


class HBMEvalSet:
    """The (capped) eval set resident on ``device`` in order, wrap-padded
    to whole batches; :meth:`scatter_logits` undoes the padding."""

    def __init__(self, cached: CachedDataset, device, batch_size: int,
                 max_samples: Optional[int] = None):
        n = len(cached)
        n_eff = min(n, max_samples) if max_samples is not None else n
        if n_eff <= 0:
            raise ValueError("empty eval set")
        steps = -(-n_eff // batch_size)
        order = np.arange(steps * batch_size) % n_eff
        self.images = torch.from_numpy(
            np.ascontiguousarray(cached.images[order])).to(device)
        self.labels = cached.labels[:n_eff]
        self.order = order
        self.n = n_eff
        self.steps = steps
        self.batch_size = batch_size

    @property
    def offsets(self) -> np.ndarray:
        return (np.arange(self.steps) * self.batch_size).astype(np.int32)

    def scatter_logits(self, logits_steps: np.ndarray) -> np.ndarray:
        """(steps, B, C) logits -> (n, C) in the set's order."""
        num_classes = logits_steps.shape[-1]
        flat = logits_steps.reshape(-1, num_classes)
        out = np.empty((self.n, num_classes), flat.dtype)
        out[self.order] = flat
        return out


class EpochSampler:
    """Per-epoch window offsets into the resident train set: disjoint
    windows of one batch in a random order after a random phase roll
    (the JAX package's sampler, the same numpy draws)."""

    def __init__(self, hbm, batch_size: int, seed: int = 0):
        if batch_size > hbm.local_count:
            raise ValueError(f"batch {batch_size} exceeds the resident set "
                             f"({hbm.local_count} samples)")
        self.hbm = hbm
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def epoch_offsets(self, num_steps: Optional[int] = None) -> np.ndarray:
        """(num_steps,) int32 window offsets."""
        n_local = self.hbm.local_count
        bl = self.batch_size
        steps = (max(n_local // bl, 1) if num_steps is None else num_steps)
        out = []
        while len(out) < steps:
            # a random phase, then disjoint windows in a random order; the
            # phase spans the leftover tail so that every sample is
            # reachable even when bl <= n_local < 2 * bl
            roll_bound = min(bl, n_local - bl + 1)
            roll = int(self.rng.integers(0, roll_bound)) \
                if roll_bound > 1 else 0
            windows = max((n_local - roll) // bl, 1)
            offs = roll + self.rng.permutation(windows) * bl
            out.extend(int(o) for o in offs)
        return np.asarray(out[:steps], np.int32)

    def epoch(self, num_steps: Optional[int] = None) -> Iterator[np.ndarray]:
        yield from self.epoch_offsets(num_steps)

    @property
    def steps_per_epoch(self) -> int:
        return max(self.hbm.local_count // self.batch_size, 1)


def prefetch_to_device(iterator, device, buffer_size: int = 2):
    """Double-buffered host -> device copies for the stream path: each
    batch's arrays go through pinned memory with a non-blocking copy, and
    ``buffer_size`` batches are in flight before the first is yielded.
    Yields the batches with their arrays as device tensors (other items
    as they are)."""
    device = torch.device(device)

    def put(batch):
        out = []
        for item in batch:
            if isinstance(item, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(item))
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                out.append(t)
            else:
                out.append(item)
        return tuple(out)

    queue = collections.deque()
    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= buffer_size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def iter_host_batches(cached: CachedDataset, batch_size: int,
                      shuffle: bool = False, seed: int = 0,
                      drop_last: bool = False, pad_final: bool = False):
    """Stream (images_u8, labels, n_valid) numpy batches from the cache;
    ``pad_final`` wraps the last partial batch to full size and reports
    the real count in n_valid."""
    n = len(cached)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        n_valid = len(idx)
        if n_valid < batch_size:
            if drop_last:
                return
            if pad_final:
                idx = np.resize(idx, batch_size)
        yield (np.ascontiguousarray(cached.images[idx]),
               cached.labels[idx], n_valid)
