"""Map-style dataset ABC, host side (counterpart of ``poem_v2_tpu/data/hdata.py``).

Equivalent of the reference ``HDataset`` contract
(lib/datasets/hdata.py:31-389): subclasses implement the per-sample
getters and the base class assembles the label dict consumed by the
transforms / shard dumper. The released per-dataset SDK adapters
(DexYCB/HO3D/OakInk/InterHand/Arctic/FreiHAND, reference
lib/datasets/*.py) plug in here by implementing the getters with their
respective toolkits; only the streaming-tar path is needed at train
time, so those SDKs stay optional.
"""

from __future__ import annotations

import abc
from typing import Dict, List

import numpy as np


class HDataset(abc.ABC):
    """Single-view map-style dataset contract (reference hdata.py:76-142)."""

    data_mode: str = "3D"  # 2D | UVD | 3D
    center_idx: int = 0
    device: str = "cpu"  # where get_image decodes the raw frames (data/codec.py)

    # ---- abstract getters --------------------------------------------------
    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def get_image(self, idx: int) -> np.ndarray: ...

    @abc.abstractmethod
    def get_image_path(self, idx: int) -> str: ...

    @abc.abstractmethod
    def get_joints_3d(self, idx: int) -> np.ndarray: ...

    @abc.abstractmethod
    def get_verts_3d(self, idx: int) -> np.ndarray: ...

    @abc.abstractmethod
    def get_joints_2d(self, idx: int) -> np.ndarray: ...

    @abc.abstractmethod
    def get_cam_intr(self, idx: int) -> np.ndarray: ...

    def get_cam_extr(self, idx: int) -> np.ndarray:
        return np.eye(4, dtype=np.float32)

    def get_joints_vis(self, idx: int) -> np.ndarray:
        return np.ones(21, dtype=np.float32)

    def get_mano_pose(self, idx: int) -> np.ndarray:
        return np.zeros(48, dtype=np.float32)

    def get_mano_shape(self, idx: int) -> np.ndarray:
        return np.zeros(10, dtype=np.float32)

    def get_bbox_center_scale(self, idx: int):
        j2d = self.get_joints_2d(idx)
        centre = j2d.mean(0)
        span = (j2d.max(0) - j2d.min(0)).max()
        return centre.astype(np.float32), np.float32(span * 2.0)

    def get_sample_identifier(self, idx: int) -> str:
        return f"{type(self).__name__}_{idx:08d}"

    # ---- assembled label ----------------------------------------------------
    def get_label(self, idx: int) -> Dict:
        centre, scale = self.get_bbox_center_scale(idx)
        return {
            "image_path": self.get_image_path(idx),
            "joints_3d": self.get_joints_3d(idx),
            "verts_3d": self.get_verts_3d(idx),
            "joints_2d": self.get_joints_2d(idx),
            "joints_vis": self.get_joints_vis(idx),
            "cam_intr": self.get_cam_intr(idx),
            "cam_extr": self.get_cam_extr(idx),
            "mano_pose": self.get_mano_pose(idx),
            "mano_shape": self.get_mano_shape(idx),
            "bbox_center": centre,
            "bbox_scale": scale,
            "raw_size": np.asarray(self.get_image(idx).shape[:2][::-1]),
        }

    def __getitem__(self, idx: int) -> Dict:
        return {"image": self.get_image(idx), "label": self.get_label(idx)}


class MultiviewDataset(abc.ABC):
    """Multi-view grouping contract (reference DexYCBMultiView et al.).

    Subclasses group per-view samples of one frame and define the master
    system; __getitem__ yields the dumper-ready dict.
    """

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def views_of(self, idx: int) -> List[int]:
        """Per-view indices into the underlying single-view dataset."""

    @property
    @abc.abstractmethod
    def base(self) -> HDataset: ...

    @property
    def device(self) -> str:
        """Where the underlying dataset decodes its raw frames."""
        return self.base.device

    @device.setter
    def device(self, device: str) -> None:
        self.base.device = device

    def __getitem__(self, idx: int) -> Dict:
        view_ids = self.views_of(idx)
        images = [self.base.get_image(v) for v in view_ids]
        labels = [self.base.get_label(v) for v in view_ids]
        label = {k: [l[k] for l in labels] for k in labels[0]}
        label["cam_serial"] = [str(v) for v in view_ids]
        return {
            "key": self.base.get_sample_identifier(idx),
            "images": images,
            "label": label,
        }
