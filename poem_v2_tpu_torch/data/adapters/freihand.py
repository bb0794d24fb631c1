"""FreiHAND adapter (single-view N=1 training source).
(Counterpart of ``poem_v2_tpu/data/adapters/freihand.py``.)

Reads the published FreiHAND layout directly (reference
lib/datasets/freihand.py:143-595 reads the same files through caches):

    <root>/FreiHAND/
        training/rgb/%08d.jpg          (4 x 32560: unique + 3 recolored)
        training_K.json                per-unique 3x3 intrinsics
        training_xyz.json              per-unique (21, 3) joints (m)
        training_verts.json            per-unique (778, 3) verts (m)
        training_scale.json            per-unique scalar
        training_mano.json             per-unique (1, 61) mano params

The green-screen recolored replicas share the unique labels
(idx % n_unique). ``FreiHANDV2Extra`` is the evaluation release with GT
jsons under <root>/FreiHAND_v2_eval (reference freihand.py:436-595).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ...utils.registry import DATASET
from ..hdata import HDataset
from .common import bbox_center_scale, imread_rgb, persp_project, require_dir


class FreiHAND(HDataset):
    name = "FreiHAND"
    subfolder = "training"

    def __init__(self, data_root: str, data_split: str = "train", center_idx: int = 0):
        self.data_split = data_split
        self.center_idx = center_idx
        self.root = require_dir(os.path.join(data_root, self.name), self.name)

        def _load(tag):
            with open(os.path.join(self.root, f"{self.subfolder}_{tag}.json")) as f:
                return json.load(f)

        self.K = np.asarray(_load("K"), dtype=np.float32)  # (U, 3, 3)
        self.xyz = np.asarray(_load("xyz"), dtype=np.float32)  # (U, 21, 3)
        self.verts = np.asarray(_load("verts"), dtype=np.float32)  # (U, 778, 3)
        try:
            self.mano = np.asarray(_load("mano"), dtype=np.float32).reshape(len(self.K), -1)
        except FileNotFoundError:
            self.mano = None
        self.n_unique = len(self.K)
        rgb_dir = os.path.join(self.root, self.subfolder, "rgb")
        self.n_images = len(os.listdir(rgb_dir)) if os.path.isdir(rgb_dir) else self.n_unique
        # train uses all replicas; val/test protocols subset uniques
        self.n_samples = self.n_images if data_split == "train" else self.n_unique

    def __len__(self):
        return self.n_samples

    def _u(self, idx):
        return idx % self.n_unique

    def get_image_path(self, idx):
        return os.path.join(self.root, self.subfolder, "rgb", "%08d.jpg" % idx)

    def get_image(self, idx):
        return imread_rgb(self.get_image_path(idx), self.device)

    def get_cam_intr(self, idx):
        return self.K[self._u(idx)]

    def get_joints_3d(self, idx):
        return self.xyz[self._u(idx)]

    def get_verts_3d(self, idx):
        return self.verts[self._u(idx)]

    def get_joints_2d(self, idx):
        return persp_project(self.get_joints_3d(idx), self.get_cam_intr(idx))

    def get_mano_pose(self, idx):
        if self.mano is None:
            return np.zeros(48, dtype=np.float32)
        return self.mano[self._u(idx)][:48]

    def get_mano_shape(self, idx):
        if self.mano is None:
            return np.zeros(10, dtype=np.float32)
        return self.mano[self._u(idx)][48:58]

    def get_bbox_center_scale(self, idx):
        return bbox_center_scale(self.get_joints_2d(idx))

    def get_sample_identifier(self, idx):
        return f"{self.name}_{self.data_split}_{idx:08d}"


class FreiHANDV2Extra(FreiHAND):
    """Evaluation split with released GT (reference freihand.py:436-595)."""

    name = "FreiHAND_v2_eval"
    subfolder = "evaluation"


@DATASET.register_module("FreiHAND")
def _build_freihand(cfg):
    return FreiHAND(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                    cfg.get("CENTER_IDX", 0))


@DATASET.register_module("FreiHAND_v2_Extra")
def _build_freihand_v2(cfg):
    return FreiHANDV2Extra(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "test"),
                           cfg.get("CENTER_IDX", 0))
