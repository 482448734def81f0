"""WebDataset-compatible tar shard reader/writer (no third-party deps).

Format contract (reference functions/data_curation.py:1006-1012 via
``wds.TarWriter``): each sample is a group of tar members sharing a key
prefix — ``<key>.jpg`` (JPEG bytes), ``<key>.cls`` (utf-8 class name),
``<key>.json`` (utf-8 JSON ``{"class": ..., "id": ...}``).  Shards are
named ``<prefix>-%06d.tar`` with ``samples_per_shard`` samples each
(reference data_curation.py:973-976).

The reader streams: one sequential pass per tar, grouping consecutive
members by key (the basename up to its first dot, like WebDataset's
grouping rule).  Values are raw ``bytes``; callers decode (the reference
reads ``sample['cls'].decode('utf-8')``, hyperopt.py:107).
"""

from __future__ import annotations

import io
import json
import os
import tarfile
import time
from typing import Dict, Iterator, List, Sequence


def _split_key_ext(name: str):
    """WebDataset grouping: key = dirname + basename-up-to-first-dot."""
    dirname, basename = os.path.split(name)
    if "." in basename:
        stem, ext = basename.split(".", 1)
    else:
        stem, ext = basename, ""
    key = os.path.join(dirname, stem) if dirname else stem
    return key, ext.lower()


def iter_shard(path: str) -> Iterator[Dict[str, bytes]]:
    """Stream samples from one tar shard as dicts of raw bytes.

    Yields ``{"__key__": str, "<ext>": bytes, ...}`` per sample, grouping
    consecutive members with the same key.
    """
    with tarfile.open(path, mode="r:") as tf:
        current_key = None
        sample: Dict[str, bytes] = {}
        for member in tf:
            if not member.isfile():
                continue
            key, ext = _split_key_ext(member.name)
            if key != current_key:
                if current_key is not None and sample:
                    sample["__key__"] = current_key
                    yield sample
                current_key = key
                sample = {}
            fobj = tf.extractfile(member)
            if fobj is not None:
                sample[ext] = fobj.read()
        if current_key is not None and sample:
            sample["__key__"] = current_key
            yield sample


def iter_samples(paths: Sequence[str] | str) -> Iterator[Dict[str, bytes]]:
    """Stream samples from many shards in order."""
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        yield from iter_shard(p)


def _encode_value(ext: str, value) -> bytes:
    if isinstance(value, bytes):
        return value
    if ext == "json" or isinstance(value, (dict, list)):
        return json.dumps(value).encode("utf-8")
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, (int, float)):
        return str(value).encode("utf-8")
    raise TypeError(f"cannot encode field .{ext} of type {type(value)!r}")


class TarWriter:
    """Write WebDataset-style samples into a single tar file."""

    def __init__(self, path: str):
        self.path = path
        self._tar = tarfile.open(path, mode="w")
        self.count = 0

    def write(self, sample: Dict[str, object]) -> None:
        key = sample.get("__key__")
        if key is None:
            raise ValueError("sample missing '__key__'")
        now = int(time.time())
        # Deterministic member order: jpg first then others sorted, matching
        # "payload then metadata" convention; readers don't depend on order
        # within a sample beyond key grouping.
        exts = [e for e in sample.keys() if e != "__key__"]
        exts.sort(key=lambda e: (e != "jpg", e))
        for ext in exts:
            data = _encode_value(ext, sample[ext])
            info = tarfile.TarInfo(name=f"{key}.{ext}")
            info.size = len(data)
            info.mtime = now
            info.uname = info.gname = "bigdata"
            self._tar.addfile(info, io.BytesIO(data))
        self.count += 1

    def close(self) -> None:
        if self._tar is not None:
            self._tar.close()
            self._tar = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardWriter:
    """Write samples across ``<prefix>-%06d.tar`` shards.

    Rolls to a new shard every ``samples_per_shard`` samples (reference
    data_curation.py:986-994).
    """

    def __init__(self, output_dir: str, prefix: str, samples_per_shard: int = 1000):
        os.makedirs(output_dir, exist_ok=True)
        self.pattern = os.path.join(output_dir, f"{prefix}-%06d.tar")
        self.samples_per_shard = samples_per_shard
        self._writer: TarWriter | None = None
        self._shard_index = 0
        self._in_shard = 0
        self.total = 0
        self.shard_paths: List[str] = []

    def write(self, sample: Dict[str, object]) -> None:
        if self._writer is None or self._in_shard >= self.samples_per_shard:
            if self._writer is not None:
                self._writer.close()
            path = self.pattern % self._shard_index
            self._writer = TarWriter(path)
            self.shard_paths.append(path)
            self._shard_index += 1
            self._in_shard = 0
        self._writer.write(sample)
        self._in_shard += 1
        self.total += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
