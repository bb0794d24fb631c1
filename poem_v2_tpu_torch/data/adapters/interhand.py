"""InterHand2.6M adapter (packed-annotation layout).
(Counterpart of ``poem_v2_tpu/data/adapters/interhand.py``.)

The reference consumes a pre-packed per-sample pickle layout (reference
lib/datasets/interhand.py:26-440):

    <root>/InterHand/
        images/...                              (raw frames)
        anno_packed/<split>/index.pkl           list of aids
        anno_packed/<split>/<aid>.pkl           one dict per sample:
            img_path, joint_cam_coord (42, 3) mm (right hand first 21),
            focal (2,), princpt (2,), camrot (3,3), campos (3,) mm,
            pose (48,), shape (10,), idx, [capture, frame]  (optional)

Joint order: InterHand's 21 right-hand joints are re-arranged to the
OpenPose convention with the fixed permutation the reference uses
(interhand.py:110-112). Extrinsics follow ``x_cam = R (x_world - C)``,
i.e. t = -R C (interhand.py:165-170). Vertices come from the MANO
parameters via the port's MANO layer, anchored at the wrist joint
(interhand.py:115-124).

``InterHandMultiView`` groups aids by (capture, frame) when those keys
are present in the packed samples (reference interhand.py:212-340 uses
a pickled multiview index; grouping keys are equivalent).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np
import torch

from ...geometry.rotations import aa_to_rotmat, rotmat_to_aa
from ...utils.registry import DATASET
from ..hdata import HDataset, MultiviewDataset
from .common import bbox_center_scale, imread_rgb, mano_verts, persp_project, require_dir

IH_TO_OPENPOSE = [20, 3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12, 19, 18, 17, 16]


class InterHand(HDataset):
    name = "InterHand"

    def __init__(self, data_root: str, data_split: str = "train", center_idx: int = 0):
        self.data_split = data_split
        self.center_idx = center_idx
        self.root = require_dir(os.path.join(data_root, self.name), self.name)
        self.annot_path = os.path.join(self.root, "anno_packed")
        with open(os.path.join(self.annot_path, data_split, "index.pkl"), "rb") as f:
            self.sample_idxs = pickle.load(f)

    def load_sample(self, idx) -> dict:
        aid = self.sample_idxs[idx]
        with open(os.path.join(self.annot_path, self.data_split, f"{aid}.pkl"), "rb") as f:
            return pickle.load(f)

    def __len__(self):
        return len(self.sample_idxs)

    def get_image_path(self, idx):
        return self.load_sample(idx)["img_path"]

    def get_image(self, idx):
        return imread_rgb(self.get_image_path(idx), self.device)

    def get_joints_3d(self, idx):
        s = self.load_sample(idx)
        j = np.asarray(s["joint_cam_coord"], dtype=np.float32)[:21] / 1000.0
        return j[IH_TO_OPENPOSE]

    def get_cam_intr(self, idx):
        s = self.load_sample(idx)
        fx, fy = s["focal"]
        cx, cy = s["princpt"]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)

    def get_cam_extr(self, idx):
        s = self.load_sample(idx)
        rot = np.asarray(s["camrot"], dtype=np.float64)
        t = -rot @ (np.asarray(s["campos"], dtype=np.float64) / 1000.0)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = t
        return m

    def get_joints_2d(self, idx):
        return persp_project(self.get_joints_3d(idx), self.get_cam_intr(idx))

    def get_mano_pose(self, idx):
        # world-frame global rotation is rotated into the camera frame
        # (reference interhand.py:190-196)
        s = self.load_sample(idx)
        pose = np.asarray(s["pose"], dtype=np.float32)
        root = rotmat_to_aa(
            torch.as_tensor(np.asarray(s["camrot"], dtype=np.float32))
            @ aa_to_rotmat(torch.as_tensor(pose[:3]))
        )
        return np.concatenate([root.numpy().astype(np.float32), pose[3:]])

    def get_mano_shape(self, idx):
        return np.asarray(self.load_sample(idx)["shape"], dtype=np.float32)

    def get_verts_3d(self, idx):
        verts = mano_verts(self.get_mano_pose(idx), self.get_mano_shape(idx),
                           flat_hand_mean=False)
        return verts + self.get_joints_3d(idx)[0]

    def get_bbox_center_scale(self, idx):
        return bbox_center_scale(self.get_joints_2d(idx))

    def get_sample_identifier(self, idx):
        return f"{self.name}_{self.load_sample(idx).get('idx', idx)}"


class InterHandMultiView(MultiviewDataset):
    """Groups samples by (capture, frame) (reference interhand.py:212-340)."""

    def __init__(self, base_ds: InterHand, n_views: int = 8):
        self._base = base_ds
        groups: Dict[tuple, List[int]] = {}
        for i in range(len(base_ds)):
            s = base_ds.load_sample(i)
            key = (s.get("capture", 0), s.get("frame", s.get("idx", i)))
            groups.setdefault(key, []).append(i)
        self.groups = [v[:n_views] for _, v in sorted(groups.items()) if len(v) > 1]

    @property
    def base(self):
        return self._base

    def __len__(self):
        return len(self.groups)

    def views_of(self, idx):
        return self.groups[idx]  # as_first_camera master (reference 228-231)


@DATASET.register_module("Interhand")
def _build_interhand(cfg):
    return InterHand(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"), cfg.get("CENTER_IDX", 0))


@DATASET.register_module("InterhandMultiView")
def _build_interhand_mv(cfg):
    base_ds = InterHand(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"), cfg.get("CENTER_IDX", 0))
    return InterHandMultiView(base_ds, n_views=cfg.get("N_VIEWS", 8))
