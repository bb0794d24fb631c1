"""DexYCB adapter — toolkit-free reader of the published layout.
(Counterpart of ``poem_v2_tpu/data/adapters/dexycb.py``.)

The reference wraps ``dex_ycb_toolkit`` + manotorch (reference
lib/datasets/dexycb.py:28-589); this adapter reads the same on-disk
files directly:

    <root>/DexYCB/
        <subject>/<seq>/meta.yml            serials, num_frames,
                                            extrinsics id, mano_calib id
        <subject>/<seq>/<serial>/color_%06d.jpg
        <subject>/<seq>/<serial>/labels_%06d.npz
                                            joint_3d (1,21,3) m,
                                            joint_2d (1,21,2),
                                            pose_m (1,51) = 48 aa + 3 tsl
        calibration/intrinsics/<serial>_640x480.yml   color: fx fy ppx ppy
        calibration/extrinsics_<id>/extrinsics.yml    extrinsics:
                                            {serial: 12 floats, 3x4 cam->tag}
        calibration/mano_<id>/mano.yml      betas (10,)

Vertices are realised with the port's MANO layer
(pose_m[:48] + betas, translated by pose_m[48:]) — the reference does
the same through manotorch (dexycb.py:180-189).

``DexYCBMultiView`` groups the 8 serials of one (sequence, frame) and
re-bases extrinsics so the master system is either the first camera
(shuffled order in train) or the constant serial 840412060917
(reference dexycb.py:254-512).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...utils.config import load_yaml
from ...utils.registry import DATASET
from ..hdata import HDataset, MultiviewDataset
from .common import bbox_center_scale, imread_rgb, mano_verts, require_dir

CONSTANT_CAM_SERIAL = "840412060917"  # reference dexycb.py:286

# official DexYCB protocol constants (dex_ycb_toolkit dex_ycb.py; these are
# publishable dataset constants, reproduced so the split needs no toolkit).
# s0 "default" setup: every subject contributes its sorted sequences; every
# 5th sequence (i % 5 == 4) is held out — val takes it from subjects 1-2,
# test from subjects 3-10; train gets the remaining 4/5 from all subjects.
S0_SUBJECTS = (
    "20200709-subject-01", "20200813-subject-02", "20200820-subject-03",
    "20200903-subject-04", "20200908-subject-05", "20200918-subject-06",
    "20200928-subject-07", "20201002-subject-08", "20201015-subject-09",
    "20201022-subject-10",
)
S0_SERIALS = (
    "836212060125", "839512060362", "840412060917", "841412060263",
    "932122060857", "932122060861", "932122061900", "932122062010",
)


def s0_sequences(root: str, data_split: str) -> List[str]:
    """Official s0 split sequence list ("subject/seq" relative paths).

    Reproduces dex_ycb_toolkit's s0 protocol (consumed by the reference
    through ``get_dataset(f"s0_{split}")`` — lib/datasets/dexycb.py:82-96):
    per-subject sorted sequences, ``i % 5 == 4`` held out; val = subjects
    1-2, test = subjects 3-10, train = all subjects on the 4/5 remainder.
    Unknown subject directories (synthetic test fixtures) fall back to
    positional subject indices.
    """
    subjects = [
        s for s in sorted(os.listdir(root))
        if os.path.isdir(os.path.join(root, s)) and s != "calibration"
    ]

    def subject_index(name: str, pos: int) -> int:
        return S0_SUBJECTS.index(name) if name in S0_SUBJECTS else pos

    if data_split == "val":
        subjects = [s for i, s in enumerate(subjects) if subject_index(s, i) < 2]
    elif data_split == "test":
        subjects = [s for i, s in enumerate(subjects) if subject_index(s, i) >= 2]
    keep = (lambda i: i % 5 != 4) if data_split == "train" else (lambda i: i % 5 == 4)

    out: List[str] = []
    for subject in subjects:
        seqs = sorted(
            s for s in os.listdir(os.path.join(root, subject))
            if os.path.isfile(os.path.join(root, subject, s, "meta.yml"))
        )
        out.extend(f"{subject}/{s}" for i, s in enumerate(seqs) if keep(i))
    return out


class DexYCB(HDataset):
    """Single-view map-style DexYCB (reference dexycb.py:28-250)."""

    name = "DexYCB"

    def __init__(
        self,
        data_root: str,
        data_split: str = "train",
        center_idx: int = 0,
        use_left_hand: bool = False,
        sequences: Optional[Sequence[str]] = None,
        filter_invisible: bool = True,
    ):
        self.data_split = data_split
        self.center_idx = center_idx
        self.root = require_dir(os.path.join(data_root, self.name), self.name)

        # official s0 split (per-subject hold-out + subject filters —
        # see s0_sequences); pass `sequences=` to override
        if sequences is None:
            sequences = s0_sequences(self.root, data_split)
        self.sequences = list(sequences)

        self._meta: Dict[str, dict] = {}
        self._betas: Dict[str, np.ndarray] = {}
        self._extr: Dict[str, Dict[str, np.ndarray]] = {}
        self._intr: Dict[str, np.ndarray] = {}
        self.samples: List[tuple] = []  # (seq, serial, frame)
        for seq in self.sequences:
            meta = load_yaml(os.path.join(self.root, seq, "meta.yml"))
            self._meta[seq] = meta
            if not use_left_hand and meta.get("mano_sides", ["right"])[0] == "left":
                continue
            for serial in meta["serials"]:
                for frame in range(meta["num_frames"]):
                    self.samples.append((seq, serial, frame))
        if filter_invisible:
            self.samples = [s for s in self.samples if self._visible(s)]

    # ---- raw file accessors -------------------------------------------------
    def _label(self, seq, serial, frame):
        return np.load(os.path.join(self.root, seq, serial, f"labels_{frame:06d}.npz"))

    def _visible(self, sample):
        j2d = self._label(*sample)["joint_2d"]
        return not np.any(j2d == -1)

    def _betas_of(self, seq):
        if seq not in self._betas:
            calib = self._meta[seq]["mano_calib"][0]
            y = load_yaml(os.path.join(self.root, "calibration", f"mano_{calib}", "mano.yml"))
            self._betas[seq] = np.asarray(y["betas"], dtype=np.float32)
        return self._betas[seq]

    def extrinsics_of(self, seq) -> Dict[str, np.ndarray]:
        """serial -> (4, 4) camera->tag transform (reference 412-419)."""
        if seq not in self._extr:
            ext_id = self._meta[seq]["extrinsics"]
            y = load_yaml(
                os.path.join(self.root, "calibration", f"extrinsics_{ext_id}", "extrinsics.yml")
            )
            out = {}
            for serial, vals in y["extrinsics"].items():
                m = np.eye(4, dtype=np.float32)
                m[:3] = np.asarray(vals, dtype=np.float32).reshape(3, 4)
                out[serial] = m
            self._extr[seq] = out
        return self._extr[seq]

    def intrinsics_of(self, serial) -> np.ndarray:
        if serial not in self._intr:
            y = load_yaml(
                os.path.join(self.root, "calibration", "intrinsics", f"{serial}_640x480.yml")
            )["color"]
            self._intr[serial] = np.array(
                [[y["fx"], 0, y["ppx"]], [0, y["fy"], y["ppy"]], [0, 0, 1]], dtype=np.float32
            )
        return self._intr[serial]

    # ---- HDataset getters ----------------------------------------------------
    def __len__(self):
        return len(self.samples)

    def get_image_path(self, idx):
        seq, serial, frame = self.samples[idx]
        return os.path.join(self.root, seq, serial, f"color_{frame:06d}.jpg")

    def get_image(self, idx):
        return imread_rgb(self.get_image_path(idx), self.device)

    def get_cam_intr(self, idx):
        return self.intrinsics_of(self.samples[idx][1])

    def get_cam_extr(self, idx):
        seq, serial, _ = self.samples[idx]
        return self.extrinsics_of(seq)[serial]

    def get_joints_3d(self, idx):
        return self._label(*self.samples[idx])["joint_3d"][0].astype(np.float32)

    def get_joints_2d(self, idx):
        return self._label(*self.samples[idx])["joint_2d"][0].astype(np.float32)

    def get_mano_pose(self, idx):
        return self._label(*self.samples[idx])["pose_m"][0, :48].astype(np.float32)

    def get_mano_shape(self, idx):
        return self._betas_of(self.samples[idx][0])

    def get_verts_3d(self, idx):
        label = self._label(*self.samples[idx])
        pose_m = label["pose_m"][0].astype(np.float32)
        verts = mano_verts(pose_m[:48], self.get_mano_shape(idx), flat_hand_mean=False)
        return verts + pose_m[48:51]

    def get_bbox_center_scale(self, idx):
        return bbox_center_scale(self.get_joints_2d(idx))

    def get_sample_identifier(self, idx):
        seq, serial, frame = self.samples[idx]
        return f"{self.name}_{seq.replace('/', '_')}_{serial}_{frame:06d}"


class DexYCBMultiView(MultiviewDataset):
    """Groups the serials of one (sequence, frame); master system per
    ``master_system`` (reference dexycb.py:254-512)."""

    def __init__(
        self,
        base: DexYCB,
        master_system: str = "as_constant_camera",
        shuffle_views: bool = False,
        seed: int = 0,
        test_with_multiview: bool = False,
    ):
        assert master_system in ("as_first_camera", "as_constant_camera")
        self._base = base
        self.master_system = master_system
        self.shuffle_views = shuffle_views
        self._rs = np.random.RandomState(seed)
        groups: Dict[tuple, List[int]] = {}
        for i, (seq, serial, frame) in enumerate(base.samples):
            groups.setdefault((seq, frame), []).append(i)
        self.groups = [v for _, v in sorted(groups.items())]
        if base.data_split == "test" and not test_with_multiview:
            # test-mode master-rotation enumeration: each group expands to
            # num_views entries with the view list rotated so every camera
            # leads once (reference dexycb.py:332-349; only meaningful with
            # as_first_camera, where the leading view is the master)
            rotated: List[List[int]] = []
            for g in self.groups:
                for r in range(len(g)):
                    rotated.append(g[r:] + g[:r])
            self.groups = rotated

    @property
    def base(self):
        return self._base

    def __len__(self):
        return len(self.groups)

    def views_of(self, idx):
        views = list(self.groups[idx])
        if self.master_system == "as_constant_camera":
            # keep the constant serial first (reference 286)
            views.sort(key=lambda v: self._base.samples[v][1] != CONSTANT_CAM_SERIAL)
        elif self.shuffle_views:
            self._rs.shuffle(views)  # train: random master (reference 392-398)
        return views

    def __getitem__(self, idx):
        item = super().__getitem__(idx)
        # re-base extrinsics to the master camera: both are cam->tag, so
        # T_master<-cam = inv(E_master) @ E_cam (reference 474-482)
        # (label values must stay per-view lists — the shard consumer
        # indexes every entry by view; the master is view 0 by position)
        extrs = [np.asarray(e, dtype=np.float64) for e in item["label"]["cam_extr"]]
        inv_master = np.linalg.inv(extrs[0])
        item["label"]["cam_extr"] = [(inv_master @ e).astype(np.float32) for e in extrs]
        return item


@DATASET.register_module("DexYCB")
def _build_dexycb(cfg):
    return DexYCB(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                  cfg.get("CENTER_IDX", 0), cfg.get("USE_LEFT_HAND", False))


@DATASET.register_module("DexYCBMultiView")
def _build_dexycb_mv(cfg):
    base = DexYCB(cfg.DATA_ROOT, cfg.get("DATA_SPLIT", "train"),
                  cfg.get("CENTER_IDX", 0), cfg.get("USE_LEFT_HAND", False))
    return DexYCBMultiView(
        base,
        master_system=cfg.get("MASTER_SYSTEM", "as_constant_camera"),
        shuffle_views=cfg.get("DATA_SPLIT", "train") == "train",
        test_with_multiview=cfg.get("TEST_WITH_MULTIVIEW", False),
    )


@DATASET.register_module("DexYCBMultiView_Video")
def _build_dexycb_mv_video(cfg):
    """Reference DexYCBMultiView_Video (dexycb.py:520-589): seq_len
    serial-consistent multiview frame windows over the s0 grouping; only
    the as_constant_camera master system is supported (reference :535)."""
    from ..video import MultiviewVideoDataset

    master = cfg.get("MASTER_SYSTEM", "as_constant_camera")
    assert master == "as_constant_camera", (
        "DexYCBMultiView_Video only supports master_system "
        f"'as_constant_camera' (got {master!r})"
    )
    mv = _build_dexycb_mv(cfg)
    split = cfg.get("DATA_SPLIT", "train")
    return MultiviewVideoDataset(
        mv,
        # sequence identity of a multiview frame group = "subject/seq"
        seq_of_group=lambda i: mv.base.samples[mv.groups[i][0]][0],
        seq_len=cfg.SEQ_LEN,
        interval_frames=cfg.get("INTERVAL_FRAMES", 0),
        drop_last_frames=cfg.get("DROP_LAST_FRAMES", True),
        index_pkl=f"./assets/video_task/dexycb_multiview_video_idxs_{split}.pkl",
    )
