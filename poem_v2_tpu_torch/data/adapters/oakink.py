"""OakInk-Image adapter (oikit-free reader).
(Counterpart of ``poem_v2_tpu/data/adapters/oakink.py``.)

Reads the published OakInk image release directly (reference
lib/datasets/oakink.py:24-380 goes through oikit but touches the same
files):

    <root>/OakInk/image/
        anno/split/<split_key>/seq_train.json / seq_test.json
        anno/split_train_val/<split_key>/example_split_{train,val}.json
        anno/seq_all.json
            info lists [seq_dir, ?, frame_id, view_id]
        anno/cam_intr/<info_str>.pkl      (3, 3)
        anno/hand_j/<info_str>.pkl        (21, 3) m
        anno/hand_v/<info_str>.pkl        (778, 3) m
        stream_release_v2/<seq_dir>/<view_name>_<frame_id>.png

``info_str`` joins the info entries with "__" and replaces "/" by "__"
(reference oakink.py:91-96). The four fixed rig views are indexed by
info[3] into (north_east, south_east, north_west, south_west) — the
multiview variant groups the 4 views of one (seq, frame) with view 0 as
the constant master (reference oakink.py:385-630, const cam id 0 at 457).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List

import numpy as np

from ...utils.registry import DATASET
from ..hdata import HDataset, MultiviewDataset
from .common import bbox_center_scale, imread_rgb, persp_project, require_dir

VIEW_NAMES = ["north_east_color", "south_east_color", "north_west_color", "south_west_color"]
SPLIT_KEYS = {"default": "split0", "subject": "split1", "object": "split2"}


class OakInk(HDataset):
    name = "OakInk"

    def __init__(
        self,
        data_root: str,
        data_split: str = "train",
        split_mode: str = "default",
        center_idx: int = 0,
        use_split_mv: bool = False,
    ):
        self.data_split = data_split
        self.center_idx = center_idx
        self.root = require_dir(os.path.join(data_root, "OakInk", "image"), "OakInk image")
        mid = "anno_mv" if use_split_mv else "anno"
        key = SPLIT_KEYS[split_mode]
        if data_split == "all":
            path = os.path.join(self.root, "anno", "seq_all.json")
        elif data_split in ("train+val", "test"):
            name = "seq_train.json" if data_split == "train+val" else "seq_test.json"
            path = os.path.join(self.root, mid, "split", key, name)
        else:  # train / val
            path = os.path.join(
                self.root, mid, "split_train_val", key, f"example_split_{data_split}.json"
            )
        with open(path) as f:
            self.info_list = json.load(f)
        self.info_str_list = [
            "__".join(str(x) for x in info).replace("/", "__") for info in self.info_list
        ]

    def _anno(self, kind: str, idx: int):
        with open(os.path.join(self.root, "anno", kind, f"{self.info_str_list[idx]}.pkl"), "rb") as f:
            return pickle.load(f)

    def __len__(self):
        return len(self.info_list)

    def get_image_path(self, idx):
        info = self.info_list[idx]
        return os.path.join(
            self.root, "stream_release_v2", str(info[0]),
            f"{VIEW_NAMES[info[3]]}_{info[2]}.png",
        )

    def get_image(self, idx):
        return imread_rgb(self.get_image_path(idx), self.device)

    def get_cam_intr(self, idx):
        return np.asarray(self._anno("cam_intr", idx), dtype=np.float32)

    def get_joints_3d(self, idx):
        return np.asarray(self._anno("hand_j", idx), dtype=np.float32)

    def get_verts_3d(self, idx):
        return np.asarray(self._anno("hand_v", idx), dtype=np.float32)

    def get_joints_2d(self, idx):
        return persp_project(self.get_joints_3d(idx), self.get_cam_intr(idx))

    def get_bbox_center_scale(self, idx):
        return bbox_center_scale(self.get_joints_2d(idx))

    def get_sample_identifier(self, idx):
        return f"{self.name}_{self.info_str_list[idx]}"


class OakInkMultiView(MultiviewDataset):
    """Groups the 4 rig views of one (seq, frame); view 0 is the constant
    master (reference oakink.py:385-630)."""

    def __init__(self, base_ds: OakInk):
        self._base = base_ds
        groups: Dict[tuple, List[tuple]] = {}
        for i, info in enumerate(base_ds.info_list):
            groups.setdefault((str(info[0]), info[2]), []).append((info[3], i))
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


@DATASET.register_module("OakInk")
def _build_oakink(cfg):
    return OakInk(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                  cfg.get("SPLIT_MODE", "default"), cfg.get("CENTER_IDX", 0),
                  cfg.get("USE_SPLIT_MV", False))


@DATASET.register_module("OakInkMultiView")
def _build_oakink_mv(cfg):
    base_ds = OakInk(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                     cfg.get("SPLIT_MODE", "default"), cfg.get("CENTER_IDX", 0),
                     use_split_mv=True)
    return OakInkMultiView(base_ds)


@DATASET.register_module("OakInkMultiView_Video")
def _build_oakink_mv_video(cfg):
    """Reference OakInkMultiView_Video (oakink.py:631-714): seq_len windows
    of one capture sequence; per-split-mode released index pkls."""
    from ..video import MultiviewVideoDataset

    mv = _build_oakink_mv(cfg)
    split = cfg.get("DATA_SPLIT", "train+val")
    mode = cfg.get("SPLIT_MODE", "default")
    suffix = f"{split}_{mode}" if mode == "object" else split
    return MultiviewVideoDataset(
        mv,
        seq_of_group=lambda i: str(mv.base.info_list[mv.groups[i][0]][0]),
        seq_len=cfg.SEQ_LEN,
        interval_frames=cfg.get("INTERVAL_FRAMES", 0),
        drop_last_frames=cfg.get("DROP_LAST_FRAMES", True),
        index_pkl=f"./assets/video_task/oakink_multiview_video_idxs_{suffix}.pkl",
    )
