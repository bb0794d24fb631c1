"""Webdataset shard dumper (counterpart of ``poem_v2_tpu/data/dumper.py``).

Writes multi-view samples into the tar layout the reference's released
datasets use (``<key>.image_{i}.jpg`` + ``<key>.label.pyd`` per sample;
see lib/data_wds/multiview_wds.py:63-144). The reference's own dumper
was never released (lib/data_wds/dumper.py is empty — SURVEY §2.4);
this one closes that gap so map-style datasets or synthetic generators
can be sharded for the streaming pipeline. Images are encoded by
``data/codec.py:encode_jpeg``: OpenCV on the CPU (the JAX dumper's bytes),
nvJPEG on a CUDA device.
"""

from __future__ import annotations

import io
import os
import pickle
import tarfile
from typing import Dict, Iterable, Optional

import numpy as np

from .codec import encode_jpeg


class ShardDumper:
    """Accumulate samples and roll tar shards of ``samples_per_shard``."""

    def __init__(self, out_dir: str, prefix: str, samples_per_shard: int = 1000,
                 jpeg_quality: int = 95, device: str = "cpu"):
        self.device = device
        self.out_dir = out_dir
        self.prefix = prefix
        self.samples_per_shard = samples_per_shard
        self.jpeg_quality = jpeg_quality
        os.makedirs(out_dir, exist_ok=True)
        self._shard_idx = 0
        self._count_in_shard = 0
        self._tar: Optional[tarfile.TarFile] = None

    def _open_next(self):
        if self._tar is not None:
            self._tar.close()
        path = os.path.join(self.out_dir, f"{self.prefix}-{self._shard_idx:06d}.tar")
        self._tar = tarfile.open(path, "w")
        self._shard_idx += 1
        self._count_in_shard = 0

    def _add(self, name: str, payload: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        self._tar.addfile(info, io.BytesIO(payload))

    def add_sample(self, key: str, images: Iterable[np.ndarray], label: Dict) -> None:
        """images: iterable of (H, W, 3) uint8 RGB; label: per-view lists dict."""
        # tar-layout contract: the sample key is everything before the
        # FIRST dot of a member name, so dotted keys would corrupt the
        # key/suffix split on read — sanitize deterministically
        key = key.replace(".", "_")
        if self._tar is None or self._count_in_shard >= self.samples_per_shard:
            self._open_next()
        for i, img in enumerate(images):
            self._add(f"{key}.image_{i}.jpg", encode_jpeg(img, self.jpeg_quality, self.device))
        self._add(f"{key}.label.pyd", pickle.dumps(label))
        self._count_in_shard += 1

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dump_dataset(dataset, out_dir: str, prefix: str, samples_per_shard: int = 1000,
                 device: str = "cpu") -> int:
    """Dump a map-style dataset (see :mod:`poem_v2_tpu_torch.data.hdata`) to shards,
    encoding on ``device``.

    The dataset must yield dicts with ``images`` (list of uint8 RGB),
    ``key`` and ``label`` entries.
    """
    n = 0
    with ShardDumper(out_dir, prefix, samples_per_shard, device=device) as dumper:
        for sample in dataset:
            dumper.add_sample(sample["key"], sample["images"], sample["label"])
            n += 1
    return n
