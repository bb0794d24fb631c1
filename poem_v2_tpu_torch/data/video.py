"""Temporal (video) dataset variants (counterpart of ``poem_v2_tpu/data/video.py``).

Capability parity with the reference's *_Video multi-view datasets
(DexYCBMultiView_Video dexycb.py:520-589, HO3D/Oakink video variants):
groups a stream of per-frame multi-view samples into T-frame windows of
the same sequence, batched as an extra leading time axis. Sequence
identity comes from the sample key prefix (``<seq>/<frame>`` in the
released tars).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np


def sequence_of(key: str) -> str:
    return key.rsplit("/", 1)[0] if "/" in key else key.rsplit("_", 1)[0]


class TemporalWindowDataset:
    """Wrap a (frame-ordered) sample stream into sliding T-frame windows."""

    def __init__(self, dataset, window: int = 4, stride: int = 1, key_field: str = "__key__"):
        self.dataset = dataset
        self.window = window
        self.stride = stride
        self.key_field = key_field

    def __iter__(self) -> Iterator[List[Dict]]:
        buf: List[Dict] = []
        current_seq: Optional[str] = None
        for sample in self.dataset:
            seq = sequence_of(str(sample.get(self.key_field, "")))
            if seq != current_seq:
                buf = []
                current_seq = seq
            buf.append(sample)
            if len(buf) == self.window:
                yield list(buf)
                buf = buf[self.stride :]


def collate_video(windows, view_max: int) -> Dict[str, np.ndarray]:
    """Collate a batch of T-frame windows -> arrays with a (B, T, ...) layout."""
    from .collate import collate_padded

    per_t = []
    T = len(windows[0])
    for t in range(T):
        per_t.append(collate_padded([w[t] for w in windows], view_max))
    out = {}
    for k in per_t[0]:
        out[k] = np.stack([per_t[t][k] for t in range(T)], axis=1)
    return out


class MultiviewVideoDataset:
    """Reference ``*MultiView_Video`` semantics over a MultiviewDataset.

    Mirrors DexYCBMultiView_Video / HO3Dv3MultiView_Video /
    OakInkMultiView_Video (reference dexycb.py:520-589, ho3d.py:931-1010,
    oakink.py:631-714): a precomputed frame index (one entry per multiview
    frame, ``[idx, [single_idxs], [seq_names]]``) is optionally subsampled
    by ``interval_frames``, then grouped into ``seq_len`` CONSECUTIVE
    entries whose first and last frame belong to the same sequence
    (serial-consistent windows). ``__getitem__`` fetches the ``seq_len``
    multiview samples from the parent dataset and stacks every key into a
    time-major list, exactly like the reference's per-key append loop.

    The reference loads the entry list from released
    ``assets/video_task/*.pkl`` files; when the pkl is absent the entries
    are derived from the parent dataset's own (sequence, frame) grouping —
    same windows for frame-ordered roots.

    ``drop_last_frames`` is accepted for cfg parity; like the reference's,
    the window loop never emits partial tails regardless of its value.
    """

    def __init__(
        self,
        mv,
        seq_of_group,
        seq_len: int,
        interval_frames: int = 0,
        drop_last_frames: bool = True,
        index_pkl: Optional[str] = None,
    ):
        self.mv = mv
        self.seq_len = int(seq_len)
        self.drop_last_frames = drop_last_frames

        entries: List[tuple] = []
        if index_pkl is not None and _exists(index_pkl):
            import pickle

            with open(index_pkl, "rb") as f:
                raw = pickle.load(f)
            # reference entry: [multiview_idx, [single_idxs], [seq_names]]
            entries = [(int(e[0]), tuple(e[-1])) for e in raw]
        else:
            entries = [(i, seq_of_group(i)) for i in range(len(mv))]

        if interval_frames:
            entries = entries[::interval_frames]

        self.windows: List[List[int]] = []
        for i in range(len(entries)):
            if i + self.seq_len > len(entries):
                break
            if entries[i][1] == entries[i + self.seq_len - 1][1]:
                self.windows.append([entries[j][0] for j in range(i, i + self.seq_len)])
            if i + self.seq_len == len(entries):
                break

    def __len__(self) -> int:
        return len(self.windows)

    @property
    def device(self) -> str:
        """Where the parent dataset decodes its raw frames."""
        return self.mv.device

    @device.setter
    def device(self, device: str) -> None:
        self.mv.device = device

    def __getitem__(self, idx: int) -> Dict:
        sample: Dict = {}
        for mv_idx in self.windows[idx]:
            item = self.mv[mv_idx]
            for k, v in item.items():
                sample.setdefault(k, []).append(v)
        return sample


def _exists(path: str) -> bool:
    import os

    return os.path.exists(path)
