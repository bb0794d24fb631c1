"""OakInk2 (dev) adapter.
(Counterpart of ``poem_v2_tpu/data/adapters/oakink2.py``.)

Reads the packed dev-release layout the reference's WIP class consumes
(reference lib/datasets/oakink2_dev.py:28-260 — note the reference
leaves it unwired in lib/datasets/__init__.py):

    <root>/OakInk2_Dev/
        packed_anno[_mv]/split_meta.json
            {"train"|"val"|"test": [[split, pk, f_id, cam_serial, hand_side], ...]}
        packed_anno[_mv]/<split>/<pk>/anno_<hand_side>/<cam_serial>/<f_id:06>.pkl
            image_path, cam_intr (3,3), joints_cam_rgrd (21,3),
            verts_cam (778,3), joints_2d_rgrd (21,2), verts_2d (778,2),
            mano_pose_cam (48,), mano_shape (10,)
        <image_path> relative image files (848x480)

``OakInk2MultiView`` groups samples of one (split, pk, f_id, hand_side)
over cam serials.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List

import numpy as np

from ...utils.registry import DATASET
from ..hdata import HDataset, MultiviewDataset
from .common import bbox_center_scale, imread_rgb, require_dir


def _np(x):
    # packed values may be numpy arrays or torch tensors
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x, dtype=np.float32)


class OakInk2Dev(HDataset):
    name = "OakInk2_Dev"

    def __init__(self, data_root: str, data_split: str = "train",
                 center_idx: int = 0, use_mv: bool = False,
                 right_hand_only: bool = True):
        self.data_split = data_split
        self.center_idx = center_idx
        self.image_root = require_dir(os.path.join(data_root, self.name), self.name)
        sub = "packed_anno_mv" if use_mv else "packed_anno"
        self.annot_root = os.path.join(self.image_root, sub)
        with open(os.path.join(self.annot_root, "split_meta.json")) as f:
            meta = json.load(f)
        if data_split == "all":
            tuples = meta["train"] + meta["val"] + meta["test"]
        elif data_split == "train+val":
            tuples = meta["train"] + meta["val"]
        else:
            tuples = meta[data_split]
        if right_hand_only:
            tuples = [t for t in tuples if t[4] != "lh"]
        self.split_tuple_list = [tuple(t) for t in tuples]

    def _anno(self, idx) -> dict:
        split, pk, f_id, cam_serial, hand_side = self.split_tuple_list[idx]
        path = os.path.join(self.annot_root, split, pk, f"anno_{hand_side}",
                            cam_serial, f"{f_id:0>6}.pkl")
        with open(path, "rb") as f:
            return pickle.load(f)

    def __len__(self):
        return len(self.split_tuple_list)

    def get_image_path(self, idx):
        return os.path.join(self.image_root, self._anno(idx)["image_path"])

    def get_image(self, idx):
        return imread_rgb(self.get_image_path(idx), self.device)

    def get_cam_intr(self, idx):
        return _np(self._anno(idx)["cam_intr"])

    def get_joints_3d(self, idx):
        return _np(self._anno(idx)["joints_cam_rgrd"])

    def get_verts_3d(self, idx):
        return _np(self._anno(idx)["verts_cam"])

    def get_joints_2d(self, idx):
        return _np(self._anno(idx)["joints_2d_rgrd"])

    def get_verts_2d(self, idx):
        return _np(self._anno(idx)["verts_2d"])

    def get_mano_pose(self, idx):
        return _np(self._anno(idx)["mano_pose_cam"])

    def get_mano_shape(self, idx):
        return _np(self._anno(idx)["mano_shape"])

    def get_bbox_center_scale(self, idx):
        return bbox_center_scale(self.get_joints_2d(idx))

    def get_sample_identifier(self, idx):
        split, pk, f_id, cam_serial, hand_side = self.split_tuple_list[idx]
        return f"{self.name}_{split}_{pk}_{cam_serial}_{hand_side}_{f_id:0>6}"


class OakInk2MultiView(MultiviewDataset):
    """Groups cam serials of one (split, pk, f_id, hand_side)."""

    def __init__(self, base_ds: OakInk2Dev):
        self._base = base_ds
        groups: Dict[tuple, List[tuple]] = {}
        for i, (split, pk, f_id, cam, side) in enumerate(base_ds.split_tuple_list):
            groups.setdefault((split, pk, f_id, side), []).append((cam, i))
        self.groups = [
            [i for _, i in sorted(v)] for _, v in sorted(groups.items()) if len(v) > 1
        ]

    @property
    def base(self):
        return self._base

    def __len__(self):
        return len(self.groups)

    def views_of(self, idx):
        return self.groups[idx]


@DATASET.register_module("OakInk2_Dev")
def _build_oakink2(cfg):
    return OakInk2Dev(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                      cfg.get("CENTER_IDX", 0), cfg.get("USE_MV", False))


@DATASET.register_module("OakInk2MultiView")
def _build_oakink2_mv(cfg):
    base_ds = OakInk2Dev(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                         cfg.get("CENTER_IDX", 0), use_mv=True)
    return OakInk2MultiView(base_ds)
