"""HO3D v2/v3 adapter.
(Counterpart of ``poem_v2_tpu/data/adapters/ho3d.py``.)

Reads the published HO3D layout (reference lib/datasets/ho3d.py:29-455
reads the same files through pickle caches):

    <root>/HO3D[_v3]/
        train.txt / evaluation.txt      lines "<seq>/<frame_id>"
        <subfolder>/<seq>/rgb/<frame_id>.jpg     (.png for v2)
        <subfolder>/<seq>/meta/<frame_id>.pkl
            camMat (3,3), handJoints3D (21,3) or (3,) on eval split,
            handPose (48,), handTrans (3,), handBeta (10,)

HO3D annotations are in an OpenGL-style frame; like the reference
(ho3d.py:214 and onward) all 3D labels are flipped by diag(1,-1,-1)
into the OpenCV camera convention. Vertices are realised from the MANO
parameters with the port's MANO layer.

``HO3DMultiView`` groups the 5 fixed-rig captures whose sequence names
share a base and end in the camera digit (reference ho3d.py:495-930,
CONST_CAM_ID at 516).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ...utils.registry import DATASET
from ..hdata import HDataset, MultiviewDataset
from .common import bbox_center_scale, imread_rgb, mano_verts, persp_project, require_dir

OPENGL_TO_CV = np.array([1.0, -1.0, -1.0], dtype=np.float32)


class HO3D(HDataset):
    name = "HO3D"
    img_ext = ".png"  # v2

    def __init__(self, data_root: str, data_split: str = "train", center_idx: int = 0):
        self.data_split = data_split
        self.center_idx = center_idx
        self.root = require_dir(os.path.join(data_root, self.name), self.name)
        self.subfolder = "train" if data_split in ("train", "val") else "evaluation"
        info = "train.txt" if self.subfolder == "train" else "evaluation.txt"
        with open(os.path.join(self.root, info)) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        self.samples = [tuple(ln.split("/")) for ln in lines]  # (seq, frame_id)

    def _meta(self, idx) -> dict:
        seq, fid = self.samples[idx]
        with open(os.path.join(self.root, self.subfolder, seq, "meta", f"{fid}.pkl"), "rb") as f:
            annot = pickle.load(f)
        j3d = np.asarray(annot["handJoints3D"], dtype=np.float32)
        if j3d.size == 3:  # eval split: only the root is released
            annot["handTrans"] = j3d
            annot["handJoints3D"] = np.repeat(j3d[None], 21, axis=0)
        return annot

    def __len__(self):
        return len(self.samples)

    def get_image_path(self, idx):
        seq, fid = self.samples[idx]
        return os.path.join(self.root, self.subfolder, seq, "rgb", f"{fid}{self.img_ext}")

    def get_image(self, idx):
        return imread_rgb(self.get_image_path(idx), self.device)

    def get_cam_intr(self, idx):
        return np.asarray(self._meta(idx)["camMat"], dtype=np.float32)

    def get_joints_3d(self, idx):
        return np.asarray(self._meta(idx)["handJoints3D"], dtype=np.float32) * OPENGL_TO_CV

    def get_joints_2d(self, idx):
        return persp_project(self.get_joints_3d(idx), self.get_cam_intr(idx))

    def get_mano_pose(self, idx):
        pose = self._meta(idx).get("handPose")
        if pose is None:
            return np.zeros(48, dtype=np.float32)
        return np.asarray(pose, dtype=np.float32)

    def get_mano_shape(self, idx):
        beta = self._meta(idx).get("handBeta")
        if beta is None:
            return np.zeros(10, dtype=np.float32)
        return np.asarray(beta, dtype=np.float32)

    def get_verts_3d(self, idx):
        annot = self._meta(idx)
        if "handPose" not in annot or annot["handPose"] is None:
            # eval split: no MANO released; degrade to root-anchored zeros
            return np.repeat(
                (np.asarray(annot["handTrans"], dtype=np.float32) * OPENGL_TO_CV)[None], 778, 0
            )
        verts = mano_verts(
            np.asarray(annot["handPose"], dtype=np.float32),
            np.asarray(annot["handBeta"], dtype=np.float32),
            flat_hand_mean=True,  # HO3D poses are full axis-angle
        )
        verts = verts + np.asarray(annot["handTrans"], dtype=np.float32)
        return verts * OPENGL_TO_CV

    def get_bbox_center_scale(self, idx):
        return bbox_center_scale(self.get_joints_2d(idx))

    def get_sample_identifier(self, idx):
        seq, fid = self.samples[idx]
        return f"{self.name}_{self.data_split}_{seq}_{fid}"


class HO3DV3(HO3D):
    name = "HO3D_v3"
    img_ext = ".jpg"


class HO3DMultiView(MultiviewDataset):
    """Groups the 5-camera rig captures: sequences "<base><cam_digit>"
    (e.g. ABF10..ABF14) share (base, frame) (reference ho3d.py:495-930)."""

    def __init__(self, base_ds: HO3D, const_cam_id: Optional[int] = None):
        self._base = base_ds
        self.const_cam_id = const_cam_id
        groups: Dict[tuple, List[tuple]] = {}
        for i, (seq, fid) in enumerate(base_ds.samples):
            base_name, cam_digit = seq[:-1], seq[-1]
            if not cam_digit.isdigit():
                continue
            groups.setdefault((base_name, fid), []).append((int(cam_digit), i))
        self.groups = [
            [i for _, i in sorted(v)] for _, v in sorted(groups.items()) if len(v) > 1
        ]

    @property
    def base(self):
        return self._base

    def __len__(self):
        return len(self.groups)

    def views_of(self, idx):
        views = list(self.groups[idx])
        if self.const_cam_id is not None and self.const_cam_id < len(views):
            views.insert(0, views.pop(self.const_cam_id))
        return views


@DATASET.register_module("HO3D")
def _build_ho3d(cfg):
    return HO3D(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"), cfg.get("CENTER_IDX", 0))


@DATASET.register_module("HO3DV3")
def _build_ho3dv3(cfg):
    return HO3DV3(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"), cfg.get("CENTER_IDX", 0))


@DATASET.register_module("HO3Dv3MultiView")
def _build_ho3d_mv(cfg):
    base_ds = HO3DV3(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"), cfg.get("CENTER_IDX", 0))
    return HO3DMultiView(base_ds, const_cam_id=cfg.get("CONST_CAM_ID", None))


@DATASET.register_module("HO3Dv3MultiView_Video")
def _build_ho3d_mv_video(cfg):
    """Reference HO3Dv3MultiView_Video (ho3d.py:931-1010): seq_len windows
    of one rig base-sequence (ABF1x etc. share base name ABF1)."""
    from ..video import MultiviewVideoDataset

    mv = _build_ho3d_mv(cfg)
    split = cfg.get("DATA_SPLIT", "train")
    return MultiviewVideoDataset(
        mv,
        # base-sequence name of the group = leading views' seq minus digit
        seq_of_group=lambda i: mv.base.samples[mv.groups[i][0]][0][:-1],
        seq_len=cfg.SEQ_LEN,
        interval_frames=cfg.get("INTERVAL_FRAMES", 0),
        drop_last_frames=cfg.get("DROP_LAST_FRAMES", True),
        index_pkl=f"./assets/video_task/ho3dv3_multiview_video_idxs_{split}.pkl",
    )
