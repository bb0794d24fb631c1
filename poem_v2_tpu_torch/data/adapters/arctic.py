"""ARCTIC adapter (packed-annotation layout, setup p1).
(Counterpart of ``poem_v2_tpu/data/adapters/arctic.py``.)

Reads the packed per-sample pickles the reference consumes (reference
lib/datasets/arctic.py:30-414):

    <root>/Arctic/arctic_data/data/images/...      raw frames
    <root>/Arctic_Supp/<setup>_<split>/index.pkl   list of sample ids
    <root>/Arctic_Supp/<setup>_<split>/<i>.pkl     one dict per sample:
        imgpath, imgname, joints_3d_r (21, 3), cam_intr (3, 3),
        cam_extr, pose_r (48,), betas_r (10,), image_size

ARCTIC's native joint order is re-arranged to OpenPose with the fixed
permutation the reference uses (arctic.py:107-112). The map-style class
is a shard-dumping source: augmentation happens in the wds path, so
``RETURN_BEFORE_AUG`` semantics apply (arctic.py:212-213). Vertices are
realised from (pose_r, betas_r) with the port's MANO layer,
anchored at the wrist (arctic.py:114-125).

``ArcticMultiView`` groups the 8 rig views of one (sid, seq, frame)
parsed from ``imgname`` ".../<sid>/<seq>/<cam>/<frame>"; master is the
first camera (arctic.py:215).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

from ...utils.registry import DATASET
from ..hdata import HDataset, MultiviewDataset
from .common import bbox_center_scale, imread_rgb, mano_verts, persp_project, require_dir

ARCTIC_TO_OPENPOSE = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]


class Arctic(HDataset):
    name = "Arctic"

    def __init__(self, data_root: str, data_split: str = "train",
                 set_up: str = "p1", center_idx: int = 0):
        self.data_split = data_split
        self.set_up = set_up
        self.center_idx = center_idx
        self.annot_path = require_dir(
            os.path.join(data_root, "Arctic_Supp", f"{set_up}_{data_split}"), "Arctic_Supp"
        )
        with open(os.path.join(self.annot_path, "index.pkl"), "rb") as f:
            self.sample_idxs = pickle.load(f)

    def load_sample(self, idx) -> dict:
        with open(os.path.join(self.annot_path, f"{idx}.pkl"), "rb") as f:
            return pickle.load(f)

    def __len__(self):
        return len(self.sample_idxs)

    def get_image_path(self, idx):
        return self.load_sample(idx)["imgpath"]

    def get_image(self, idx):
        return imread_rgb(self.get_image_path(idx), self.device)

    def get_joints_3d(self, idx):
        j = np.asarray(self.load_sample(idx)["joints_3d_r"], dtype=np.float32)
        return j[ARCTIC_TO_OPENPOSE]

    def get_cam_intr(self, idx):
        return np.asarray(self.load_sample(idx)["cam_intr"], dtype=np.float32)

    def get_cam_extr(self, idx):
        s = self.load_sample(idx)
        extr = np.asarray(s.get("cam_extr", np.eye(4)), dtype=np.float32)
        if extr.shape == (3, 4):
            m = np.eye(4, dtype=np.float32)
            m[:3] = extr
            extr = m
        return extr

    def get_joints_2d(self, idx):
        return persp_project(self.get_joints_3d(idx), self.get_cam_intr(idx))

    def get_mano_pose(self, idx):
        # extr already folded into pose_r at pack time (arctic.py:180-183)
        return np.asarray(self.load_sample(idx)["pose_r"], dtype=np.float32)

    def get_mano_shape(self, idx):
        return np.asarray(self.load_sample(idx)["betas_r"], dtype=np.float32)

    def get_verts_3d(self, idx):
        verts = mano_verts(self.get_mano_pose(idx), self.get_mano_shape(idx),
                           flat_hand_mean=False)
        return verts + self.get_joints_3d(idx)[0]

    def get_bbox_center_scale(self, idx):
        return bbox_center_scale(self.get_joints_2d(idx))

    def get_sample_identifier(self, idx):
        imgname = self.load_sample(idx).get("imgname", str(idx))
        # strip the image extension: wds tar keys are everything before
        # the FIRST dot, so a dotted key breaks the key/suffix split
        imgname = os.path.splitext(imgname)[0]
        sid_seq_cam_img = "_".join(imgname.split("/")[-4:])
        return f"{self.name}_{sid_seq_cam_img}"


class ArcticMultiView(MultiviewDataset):
    """Groups the 8 rig views of one (sid, seq, frame); master is the
    first camera (reference arctic.py:193-414)."""

    def __init__(self, base_ds: Arctic, n_views: int = 8):
        self._base = base_ds
        groups: Dict[tuple, List[tuple]] = {}
        for i in range(len(base_ds)):
            parts = base_ds.load_sample(i).get("imgname", str(i)).split("/")[-4:]
            if len(parts) == 4:
                sid, seq, cam, img = parts
                groups.setdefault((sid, seq, img), []).append((cam, i))
        self.groups = [
            [i for _, i in sorted(v)][:n_views]
            for _, v in sorted(groups.items())
            if len(v) > 1
        ]

    @property
    def base(self):
        return self._base

    def __len__(self):
        return len(self.groups)

    def views_of(self, idx):
        return self.groups[idx]


@DATASET.register_module("Arctic")
def _build_arctic(cfg):
    return Arctic(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                  cfg.get("SETUP", "p1"), cfg.get("CENTER_IDX", 0))


@DATASET.register_module("ArcticMultiView")
def _build_arctic_mv(cfg):
    base_ds = Arctic(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                     cfg.get("SETUP", "p1"), cfg.get("CENTER_IDX", 0))
    return ArcticMultiView(base_ds, n_views=cfg.get("N_VIEWS", 8))
