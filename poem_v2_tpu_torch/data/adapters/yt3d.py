"""YouTube-3D-Hands (YT3D) adapter — 2D/UVD-only dataset for the aux
(Counterpart of ``poem_v2_tpu/data/adapters/yt3d.py``.)
single-view pose models.

Reads the published COCO-style json (reference lib/datasets/yt3d.py:21-246):

    <root>/YT3D/youtube_<split>.json
        images: [{id, name, width, height}]
        annotations: [{image_id, vertices (778, 3) uvd, is_left}]

Joints are regressed from the annotated mesh vertices with the MANO
J-regressor + the 5 fingertip vertices, re-ordered to OpenPose
(reference yt3d.py:92-99); since the vertices are in UVD (pixel u, v,
relative d), the dataset serves ``data_mode="UVD"`` consumers. Images
live under <root>/YT3D/<name with youtube->youtube_annotated>.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from ...utils.registry import DATASET
from ..hdata import HDataset
from .common import bbox_center_scale, imread_rgb, require_dir

YT3D_REORDER = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]
TIP_VERT_IDS = [744, 320, 443, 555, 672]  # thumb..pinky (mano/layer.py)


class YT3D(HDataset):
    name = "YT3D"
    data_mode = "UVD"

    def __init__(self, data_root: str, data_split: str = "train",
                 center_idx: int = 0, right_hand_only: bool = True):
        self.data_split = data_split
        self.center_idx = center_idx
        self.root = require_dir(os.path.join(data_root, self.name), self.name)
        with open(os.path.join(self.root, f"youtube_{data_split}.json")) as f:
            raw = json.load(f)
        img_by_id = {im["id"]: im for im in raw["images"]}
        self.samples: List[dict] = []
        for ann in raw["annotations"]:
            if right_hand_only and ann.get("is_left", 0) == 1:
                continue
            info = img_by_id[ann["image_id"]]
            self.samples.append(
                {
                    "img_path": os.path.join(
                        self.root, info["name"].replace("youtube", "youtube_annotated")
                    ),
                    "size": (info["width"], info["height"]),
                    "verts_uvd": np.asarray(ann["vertices"], dtype=np.float32),
                }
            )
        from ..adapters.common import _mano_layer

        self._jreg = np.asarray(_mano_layer().j_regressor)  # (16, 778)

    def _joints_uvd(self, idx) -> np.ndarray:
        verts = self.samples[idx]["verts_uvd"]
        j16 = self._jreg @ verts
        tips = verts[TIP_VERT_IDS]
        return np.concatenate([j16, tips], axis=0)[YT3D_REORDER]

    def __len__(self):
        return len(self.samples)

    def get_image_path(self, idx):
        return self.samples[idx]["img_path"]

    def get_image(self, idx):
        return imread_rgb(self.get_image_path(idx), self.device)

    def get_joints_2d(self, idx):
        return self._joints_uvd(idx)[:, :2]

    def get_joints_uvd(self, idx):
        return self._joints_uvd(idx)

    def get_verts_uvd(self, idx):
        return self.samples[idx]["verts_uvd"]

    # 3D getters are undefined for this 2D dataset (reference data_mode gate)
    def get_joints_3d(self, idx):
        raise NotImplementedError("YT3D is a 2D/UVD-only dataset")

    def get_verts_3d(self, idx):
        raise NotImplementedError("YT3D is a 2D/UVD-only dataset")

    def get_cam_intr(self, idx):
        w, h = self.samples[idx]["size"]
        f = max(w, h)
        return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=np.float32)

    def get_bbox_center_scale(self, idx):
        return bbox_center_scale(self.get_joints_2d(idx))

    def get_sample_identifier(self, idx):
        return f"{self.name}_{self.data_split}_{idx:08d}"


@DATASET.register_module("YT3D")
def _build_yt3d(cfg):
    return YT3D(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"), cfg.get("CENTER_IDX", 0))
