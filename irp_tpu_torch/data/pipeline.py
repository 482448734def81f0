"""Image decoding, the decoded dataset and the device-resident data plane
(the JAX package's ``data/pipeline.py``).

- :func:`decode_blobs` with ``decoder='auto'`` decodes JPEGs with the
  native batch decoder (``data/jpeg.py``) where it builds and loads, and
  everything it cannot decode with PIL, as the JAX package does;
  ``'pil'`` decodes with PIL only.
- :func:`build_cache` decodes WebDataset shards once into the JAX
  package's on-disk cache (the same file names and bytes), so a cache
  written by either package loads in the other.  :class:`CachedDataset`
  tracks each sample's shard, for the shard-level k folds.
- :class:`HBMDataset` keeps the uint8 train set on the device; each step
  reads a contiguous window (:class:`EpochSampler`), and the set is
  re-permuted on the device each epoch (``local_reshuffle``).  All
  permutations are numpy draws from the seed, as in the JAX package, so
  both packages see the same order.
- :class:`HBMFoldPool` keeps the whole train cache of a sweep on the
  device once; ``select_fold`` regroups a fold's samples into a prefix
  (:class:`HBMFoldView`) with one on-device gather.
- :class:`HBMEvalSet` keeps the capped eval set on the device, in order.
- :func:`iter_host_batches` and :func:`prefetch_to_device` are the stream
  path for a set that does not fit: host batches copied through pinned
  memory, the copy of batch t + 1 overlapping the compute on batch t.
"""

from __future__ import annotations

import collections
import hashlib
import io
import json
import os
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
    (C-contiguous) when given.

    ``decoder='auto'``: the native batch decoder takes the whole batch
    where it is available, and PIL decodes each blob it flags (a PNG, a
    corrupt file); ``'pil'``: PIL for every blob.
    """
    if decoder not in ("auto", "pil"):
        raise ValueError(f"unknown decoder {decoder!r} (auto or pil)")
    n = len(blobs)
    if out is None:
        out = np.empty((n, size, size, 3), np.uint8)
    ok = None
    if decoder == "auto" and n > 0:
        from irp_tpu_torch.data.jpeg import (decode_batch_native,
                                             native_decoder_available)

        if native_decoder_available():
            _, ok = decode_batch_native(list(blobs), size, out=out)
    for j in range(n):
        if ok is None or not ok[j]:
            out[j] = decode_to_rgb256(blobs[j], size)
    return out


def _fingerprint(shard_paths: Sequence[str]) -> str:
    """The cache's identity: path, size and mtime of every shard."""
    h = hashlib.sha1()
    for p in sorted(shard_paths):
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{int(st.st_mtime)}".encode())
    return h.hexdigest()[:16]


@dataclass
class CachedDataset:
    """Decoded uint8 dataset (memmap-backed) + labels + metadata, and the
    source shard of each sample (``shard_ids`` index ``shard_paths``) when
    :func:`build_cache` made it."""

    images: Optional[np.ndarray]  # (N, 256, 256, 3) uint8; None only for
    # subset_by_shards(with_images=False) metadata-only views
    labels: np.ndarray  # (N,) int32
    keys: List[str]
    class_names: Tuple[str, ...]
    shard_ids: Optional[np.ndarray] = None
    shard_paths: Optional[Tuple[str, ...]] = None

    def __len__(self):
        return len(self.labels)

    def subset_by_shards(self, shard_subset: Sequence[str],
                         with_images: bool = True) -> "CachedDataset":
        """The samples of the given shards, in cache order.
        ``with_images=False`` leaves the images out (labels, keys and
        counts only), for a fit whose pixels come from an
        :class:`HBMFoldPool` view."""
        if self.shard_ids is None or self.shard_paths is None:
            raise ValueError("cache built without shard tracking")
        wanted = {os.path.abspath(p) for p in shard_subset}
        keep_ids = [i for i, p in enumerate(self.shard_paths)
                    if os.path.abspath(p) in wanted]
        idx = np.nonzero(np.isin(self.shard_ids, keep_ids))[0]
        return CachedDataset(
            images=(np.ascontiguousarray(self.images[idx]) if with_images
                    else None),
            labels=self.labels[idx],
            keys=[self.keys[i] for i in idx],
            class_names=self.class_names,
            shard_ids=self.shard_ids[idx],
            shard_paths=self.shard_paths)


def build_cache(shard_paths: Sequence[str], class_names: Sequence[str],
                cache_dir: Optional[str] = None, size: int = CACHE_SIZE,
                decoder=None, use_native: Optional[bool] = None
                ) -> CachedDataset:
    """Decode every sample of the shards to (size, size, 3) uint8 once;
    with ``cache_dir``, reuse the cache on disk when its fingerprint and
    class names match.

    ``class_names`` fixes the label mapping (from
    :func:`~irp_tpu_torch.data.analyze.analyze_webdataset`).  ``decoder``
    replaces the per-sample PIL decoder (cache tag ``_custom``).

    ``use_native`` (default: the ``IRP_NATIVE_DECODE=1`` environment
    variable, when no ``decoder`` is given) decodes one shard at a time
    through the native batch decoder (``data/jpeg.py``), so its threads
    see a whole shard; PIL decodes what it flags.  Where the library is
    unavailable the cache is built with PIL.  Native and PIL caches differ
    by up to 1/255, so the decoder is part of the cache's name.

    The files are the JAX package's:
    ``cache_v2_{fp}_{size}{_pil|_native|_custom}`` with ``.json`` (class
    names, keys, shard ids and paths), ``.img.npy`` and ``.lab.npy``.
    Images stream into a memmap after a pass that only counts samples; an
    undecodable sample is skipped and named in one warning line, and the
    file is then copied to its right size.
    """
    if use_native is None:
        use_native = (decoder is None
                      and os.environ.get("IRP_NATIVE_DECODE", "") == "1")
    batch_decoder = None
    if use_native and decoder is None:
        from irp_tpu_torch.data.jpeg import (decode_batch_native,
                                             native_decoder_available)

        if native_decoder_available():
            batch_decoder = decode_batch_native
    name_to_idx = {n: i for i, n in enumerate(class_names)}
    custom_decoder = decoder is not None and decoder is not decode_to_rgb256
    decoder = decoder or decode_to_rgb256

    meta_path = img_path = lab_path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        fp = _fingerprint(shard_paths)
        if custom_decoder:
            dec_tag = "_custom"
        elif batch_decoder is not None:
            dec_tag = "_native"
        else:
            dec_tag = "_pil"
        base = os.path.join(cache_dir, f"cache_v2_{fp}_{size}{dec_tag}")
        meta_path, img_path, lab_path = (base + ".json", base + ".img.npy",
                                         base + ".lab.npy")
        if all(os.path.exists(p) for p in (meta_path, img_path, lab_path)):
            with open(meta_path) as f:
                meta = json.load(f)
            if tuple(meta["class_names"]) == tuple(class_names):
                return CachedDataset(
                    images=np.load(img_path, mmap_mode="r"),
                    labels=np.load(lab_path),
                    keys=meta["keys"],
                    class_names=tuple(class_names),
                    shard_ids=np.asarray(meta["shard_ids"], np.int32),
                    shard_paths=tuple(meta["shard_paths"]))

    shard_list = list(shard_paths)
    from irp_tpu_torch.data.tar import iter_shard

    writer, total = None, 0
    if img_path is not None:
        # stream decodes into the .npy on disk: stacking a list of arrays
        # would hold the dataset two to three times in host memory
        from numpy.lib.format import open_memmap

        for shard in shard_list:
            total += sum(1 for smp in iter_shard(shard)
                         if smp.get("jpg") is not None
                         and smp.get("cls") is not None)
        if total:
            writer = open_memmap(img_path + ".tmp.npy", mode="w+",
                                 dtype=np.uint8,
                                 shape=(total, size, size, 3))

    images, labels, keys, shard_ids = [], [], [], []
    written = 0
    skipped = []
    for shard_i, shard in enumerate(shard_list):
        pending = []  # (jpg, label, key) of this shard
        for sample in iter_shard(shard):
            jpg = sample.get("jpg")
            cls = sample.get("cls")
            if jpg is None or cls is None:
                continue
            name = cls.decode("utf-8") if isinstance(cls, bytes) else cls
            pending.append((jpg, name_to_idx[name], sample["__key__"]))
        decoded = ok = None
        if batch_decoder is not None and pending:
            # one native call per shard: its threads decode the shard
            decoded, ok = batch_decoder([p[0] for p in pending], size)
        for j, (jpg, label, key) in enumerate(pending):
            if ok is not None and ok[j]:
                img = decoded[j]
            else:
                try:
                    img = decoder(jpg, size)
                except Exception:  # noqa: BLE001 — any decoder error skips
                    skipped.append(key)
                    continue
            if writer is not None:
                writer[written] = img
                written += 1
            else:
                images.append(img)
            labels.append(label)
            keys.append(key)
            shard_ids.append(shard_i)
    if skipped:
        # loud: a silently shrunken cache would desync the class weights
        # from the data trained on
        shown = ", ".join(skipped[:5])
        more = f" (+{len(skipped) - 5} more)" if len(skipped) > 5 else ""
        print(f"WARNING: build_cache skipped {len(skipped)} undecodable "
              f"sample(s): {shown}{more}")

    labels_arr = np.asarray(labels, np.int32)
    shard_ids_arr = np.asarray(shard_ids, np.int32)

    if cache_dir:
        if writer is not None:
            writer.flush()
            del writer
            tmp_img = img_path + ".tmp.npy"
            if written == 0:
                np.save(img_path, np.zeros((0, size, size, 3), np.uint8))
                os.remove(tmp_img)
            elif written == total:
                os.replace(tmp_img, img_path)
            else:  # skipped samples: stream-copy into a right-sized file
                from numpy.lib.format import open_memmap

                src = np.load(tmp_img, mmap_mode="r")
                dst = open_memmap(img_path, mode="w+", dtype=np.uint8,
                                  shape=(written, size, size, 3))
                for i0 in range(0, written, 1024):
                    i1 = min(i0 + 1024, written)
                    dst[i0:i1] = src[i0:i1]
                dst.flush()
                del dst, src
                os.remove(tmp_img)
        else:
            np.save(img_path, np.stack(images) if images else
                    np.zeros((0, size, size, 3), np.uint8))
        np.save(lab_path, labels_arr)
        with open(meta_path, "w") as f:
            json.dump({"class_names": list(class_names), "keys": keys,
                       "shard_ids": [int(i) for i in shard_ids],
                       "shard_paths": shard_list}, f)
        images_arr = np.load(img_path, mmap_mode="r")
    else:
        images_arr = np.stack(images) if images else np.zeros(
            (0, size, size, 3), np.uint8)

    return CachedDataset(images=images_arr, labels=labels_arr, keys=keys,
                         class_names=tuple(class_names),
                         shard_ids=shard_ids_arr,
                         shard_paths=tuple(shard_list))


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


class HBMFoldView:
    """A fold's train set as the prefix ``[0, local_count)`` of an
    :class:`HBMFoldPool`: what ``fit(hbm_train=...)`` reads in place of an
    :class:`HBMDataset`.  It raises once the pool has been regrouped for
    another fold."""

    def __init__(self, pool: "HBMFoldPool", local_count: int):
        self._pool = pool
        self._token = pool._fold_token
        self.local_count = local_count
        self.device = pool.device
        self.px = pool.px

    def _check_live(self):
        if self._token != self._pool._fold_token:
            raise RuntimeError(
                "stale HBMFoldView: the pool has been regrouped for "
                "another fold since this view was created")

    @property
    def images(self):
        self._check_live()
        return self._pool.images

    @property
    def labels(self):
        self._check_live()
        return self._pool.labels

    def local_reshuffle(self, seed: int) -> None:
        """Re-permute the fold's prefix only, by a permutation drawn from
        ``seed``; the other slots keep their places, so the fold's
        grouping holds."""
        self._check_live()
        self._pool._permute_prefix(
            np.random.default_rng(seed).permutation(self.local_count))

    def window(self, offset: int, size: int):
        """The contiguous batch [offset, offset + size) of the prefix."""
        self._check_live()
        if offset + size > self.local_count:
            raise IndexError(f"window [{offset}, {offset + size}) leaves "
                             f"the fold's prefix of {self.local_count}")
        return self._pool.window(offset, size)


class HBMFoldPool:
    """The whole train cache of a sweep, uploaded to ``device`` once; each
    fold is a regrouping on the device instead of a new upload per
    fold-fit (k x trials uploads of (k - 1) / k of the set otherwise).

    The slot table ``_slot_sample`` (slot -> cache index) starts with the
    samples shard by shard, as the JAX package's pool lays them out on
    one device; ``select_fold`` moves the fold's samples into a prefix
    in an order drawn from ``np.random.default_rng(seed)``, the JAX
    pool's draws, so both packages hold the same prefix index for index.
    """

    # host rows copied per chunk of the upload (a memmap cache is never
    # read into host memory whole)
    UPLOAD_CHUNK = 1024

    def __init__(self, cached: CachedDataset, device, seed: int = 0):
        if cached.shard_ids is None or cached.shard_paths is None:
            raise ValueError("HBMFoldPool needs a cache built with shard "
                             "tracking (build_cache does this)")
        if cached.images is None:
            raise ValueError("HBMFoldPool needs a cache with images")
        self.device = torch.device(device)
        self._cached = cached
        self.px = int(cached.images.shape[1])
        sids = np.asarray(cached.shard_ids)
        order = [int(g) for s in np.unique(sids)
                 for g in np.nonzero(sids == s)[0]]
        if not order:
            raise ValueError("HBMFoldPool needs a non-empty cache")
        self.local_count = len(order)
        self._slot_sample = np.asarray(order, np.int64)
        self._fold_token = 0

        n = self.local_count
        h, w, c = cached.images.shape[1:]
        self.images = torch.empty((n, h, w, c), dtype=torch.uint8,
                                  device=self.device)
        for i0 in range(0, n, self.UPLOAD_CHUNK):
            part = np.ascontiguousarray(
                cached.images[self._slot_sample[i0:i0 + self.UPLOAD_CHUNK]])
            self.images[i0:i0 + len(part)].copy_(torch.from_numpy(part))
        labels = np.ascontiguousarray(cached.labels[self._slot_sample],
                                      np.int32)
        self.labels = torch.from_numpy(labels).to(self.device).long()
        self.upload_bytes = n * h * w * c + labels.nbytes
        self._rng = np.random.default_rng(seed)

    def _permute_prefix(self, perm: np.ndarray) -> None:
        """Permute the first ``len(perm)`` slots by ``perm`` with one
        gather.  The gather's output is a second buffer of the prefix's
        size while it runs: 2 x 5.15 GB when the prefix is the whole pool
        (``select_fold``) at N = 26,179 and 256 px, which an 80 GB card
        holds.  A shorter prefix (a view's reshuffle) is gathered and
        copied back, so the peak is N + prefix instead of 2N, for two
        passes over the prefix instead of one over the pool."""
        lt = len(perm)
        perm_t = torch.from_numpy(perm).to(self.device)
        if lt == self.local_count:
            self.images = self.images[perm_t]
            self.labels = self.labels[perm_t]
        else:
            self.images[:lt] = self.images[:lt][perm_t]
            self.labels[:lt] = self.labels[:lt][perm_t]
        self._slot_sample[:lt] = self._slot_sample[:lt][perm]

    def select_fold(self, train_shard_paths: Sequence[str]) -> HBMFoldView:
        """Regroup so that the given shards' samples form the prefix, in
        a shuffled order; returns the view ``fit(hbm_train=...)`` reads.
        Raises ValueError when the fold holds no sample."""
        cached = self._cached
        wanted = {os.path.abspath(p) for p in train_shard_paths}
        keep = np.asarray([i for i, p in enumerate(cached.shard_paths)
                           if os.path.abspath(p) in wanted])
        in_fold = np.isin(np.asarray(cached.shard_ids),
                          keep)[self._slot_sample]
        train_slots = np.nonzero(in_fold)[0]
        if len(train_slots) < 1:
            raise ValueError("the pool holds no samples of this fold")
        self._rng.shuffle(train_slots)
        self._permute_prefix(np.concatenate(
            [train_slots, np.nonzero(~in_fold)[0]]))
        self._fold_token += 1
        return HBMFoldView(self, len(train_slots))

    def window(self, offset: int, size: int):
        return (self.images[offset:offset + size],
                self.labels[offset:offset + size])

    def release(self) -> None:
        """Drop the device tensors (and hand cached blocks back to the
        card); every view of the pool is stale afterwards."""
        self.images = self.labels = None
        self._fold_token += 1
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


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
