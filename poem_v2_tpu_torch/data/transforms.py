"""Host-side image and label transforms (counterpart of ``poem_v2_tpu/data/transforms.py``).

The reference's TRANSFORM classes (lib/utils/transform.py:21-342): centre /
scale / rotation jitter, random occlusion, the affine crop to the network's
resolution, colour jitter, the mean .5 / std 1 normalisation, joint visibility,
and the multi-view 3D variant, which rotates the 3D labels, rewrites the
intrinsics with the post-rotation affine (``affine_postrot @ K``) and emits the
``extr_prerot`` rotation that re-bases the extrinsics. The same ``np.random`` and
``random`` draws in the same order as the JAX package, so a seeded run gives its
samples. The crop is ``native/warp.cc`` on every device (``data/native_ops.py``).
"""

from __future__ import annotations

import math
import random
from typing import Dict, Tuple

import numpy as np

from ..utils.misc import CONST
from ..utils.registry import TRANSFORM
from .native_ops import warp_affine_normalize


def construct_rotation_matrix(rot: float, size: int = 3) -> np.ndarray:
    m = np.eye(size, dtype=np.float32)
    if rot != 0:
        sn, cs = np.sin(rot), np.cos(rot)
        m[0, :2] = [cs, -sn]
        m[1, :2] = [sn, cs]
    return m


def affine_trans_no_rot(center: np.ndarray, scale: float, res) -> np.ndarray:
    """Square crop affine (reference _get_affine_trans_no_rot, transform.py:697-705)."""
    affinet = np.zeros((3, 3), dtype=np.float64)
    scale_ratio = float(res[0]) / float(res[1])
    affinet[0, 0] = float(res[0]) / scale
    affinet[1, 1] = float(res[1]) / scale * scale_ratio
    affinet[0, 2] = res[0] * (-float(center[0]) / scale + 0.5)
    affinet[1, 2] = res[1] * (-float(center[1]) / scale * scale_ratio + 0.5)
    affinet[2, 2] = 1
    return affinet


def affine_transform(center, scale, out_res, rot: float = 0.0) -> np.ndarray:
    """Total crop+rot affine (reference _affine_transform, transform.py:674-681)."""
    rotmat = construct_rotation_matrix(rot)
    origin_rot_center = (rotmat @ np.concatenate([center, np.ones(1)]))[:2]
    post_rot = affine_trans_no_rot(origin_rot_center, scale, out_res)
    return (post_rot @ rotmat).astype(np.float32)


def affine_transform_post_rot(center, scale, optical_center, out_res, rot: float = 0.0):
    """Post-rotation affine for intrinsics (reference transform.py:684-694)."""
    rotmat = construct_rotation_matrix(rot)
    t_mat = np.eye(3)
    t_mat[0, 2] = -optical_center[0]
    t_mat[1, 2] = -optical_center[1]
    t_inv = t_mat.copy()
    t_inv[:2, 2] *= -1
    transformed_center = t_inv @ rotmat @ t_mat @ np.concatenate([center, np.ones(1)])
    return affine_trans_no_rot(transformed_center[:2], scale, out_res).astype(np.float32)


def transform_coords(pts: np.ndarray, affine: np.ndarray) -> np.ndarray:
    hom = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    return (affine @ hom.T).T[:, :2]


def center_scale_to_box(center, scale) -> Tuple[float, float, float, float]:
    half = scale / 2.0
    return (center[0] - half, center[1] - half, center[0] + half, center[1] + half)


def random_occlusion(image: np.ndarray, bbox, prob: float, rng: random.Random) -> np.ndarray:
    """Reference RandomOcclusion (transform.py:21-66)."""
    if rng.random() > prob:
        return image
    xmin, ymin, xmax, ymax = bbox
    h, w = image.shape[:2]
    synth_area = (rng.random() * 0.2) * (xmax - xmin) * (ymax - ymin)
    synth_ratio = rng.random() * 1.5 + 0.5
    synth_h = math.sqrt(synth_area * synth_ratio)
    synth_w = math.sqrt(synth_area / synth_ratio)
    synth_xmin = rng.random() * ((xmax - xmin) - synth_w - 1) + xmin
    synth_ymin = rng.random() * ((ymax - ymin) - synth_h - 1) + ymin
    if synth_xmin >= 0 and synth_ymin >= 0 and synth_xmin + synth_w < w and synth_ymin + synth_h < h:
        x0, y0 = int(synth_xmin), int(synth_ymin)
        sw, sh = int(synth_w), int(synth_h)
        image[y0 : y0 + sh, x0 : x0 + sw] = np.random.rand(sh, sw, 3) * 255
    return image


@TRANSFORM.register_module("SimpleTransform3DMultiView")
class SimpleTransform3DMultiView:
    """Per-view crop/aug + 3D label rotation (reference transform.py:240-281)."""

    def __init__(self, cfg, data_preset=None, is_train: bool = True):
        dp = data_preset if data_preset is not None else cfg.get("DATA_PRESET", {})
        self.output_size = tuple(dp.get("IMAGE_SIZE", (256, 256)))
        self.train = is_train
        self.aug = cfg.get("AUG", False)
        self.center_jit = cfg.get("CENTER_JIT", 0.0)
        self.scale_jit = cfg.get("SCALE_JIT", 0.0)
        self.color_jit = cfg.get("COLOR_JIT", 0.0)
        self.rot_jit = cfg.get("ROT_JIT", 0.0)
        self.rot_prob = cfg.get("ROT_PROB", 0.0)
        self.occlusion = cfg.get("OCCLUSION", False)
        self.occlusion_prob = cfg.get("OCCLUSION_PROB", 0.0)

    def __call__(self, image: np.ndarray, label: Dict, no_rot: bool = False) -> Dict:
        if self.aug:
            c_factor = np.random.normal(0, self.center_jit, 2)
            bbox_center = label["bbox_center"] + c_factor * label["bbox_scale"]
            bbox_scale = label["bbox_scale"] * np.random.normal(1, self.scale_jit)
            r_factor = np.random.normal(0, self.rot_jit)
            rot = float(np.deg2rad(r_factor)) if (not no_rot and np.random.rand() <= self.rot_prob) else 0.0
            if self.occlusion:
                image = random_occlusion(
                    image,
                    center_scale_to_box(bbox_center, bbox_scale),
                    self.occlusion_prob,
                    random,
                )
        else:
            bbox_center = label["bbox_center"]
            bbox_scale = label["bbox_scale"]
            rot = 0.0

        rot_mat3d = construct_rotation_matrix(rot)
        affine = affine_transform(bbox_center, bbox_scale, self.output_size, rot)
        target_joints_2d = transform_coords(label["joints_2d"], affine).astype(np.float32)

        if self.aug and self.color_jit > 0:
            lo, hi = 1 - self.color_jit, 1 + self.color_jit
            cj = np.array([random.uniform(lo, hi) for _ in range(3)], dtype=np.float32)
        else:
            cj = None

        # fused warp + colour jitter + normalisation (native/warp.cc)
        img = warp_affine_normalize(
            image, affine[:2], (self.output_size[1], self.output_size[0]), color_jitter=cj
        )

        # post-rotation intrinsics: K' = affine_postrot @ K
        intr = label["cam_intr"]
        cc = np.array([intr[0, 2], intr[1, 2]])
        affine_postrot = affine_transform_post_rot(
            bbox_center, bbox_scale, cc, self.output_size, rot
        )
        target_cam_intr = (affine_postrot @ intr).astype(np.float32)

        target_joints_3d = (rot_mat3d @ label["joints_3d"].T).T.astype(np.float32)
        target_verts_3d = (rot_mat3d @ label["verts_3d"].T).T.astype(np.float32)

        return {
            "image": img,
            "rot_rad": rot,
            "extr_prerot": rot_mat3d,
            "affine": affine,
            "affine_postrot": affine_postrot,
            "target_cam_intr": target_cam_intr,
            "target_joints_2d": target_joints_2d,
            "target_joints_3d": target_joints_3d,
            "target_verts_3d": target_verts_3d,
            "target_bbox_center": bbox_center.astype(np.float32),
            "target_bbox_scale": np.float32(bbox_scale),
        }


@TRANSFORM.register_module("SimpleTransform2D")
class SimpleTransform2D(SimpleTransform3DMultiView):
    """2D-only variant (reference transform.py:69-195): crop/aug + 2D joints
    (+ optional Gaussian heatmaps + visibility recomputation)."""

    def __init__(self, cfg, data_preset=None, is_train: bool = True):
        super().__init__(cfg, data_preset=data_preset, is_train=is_train)
        dp = data_preset if data_preset is not None else cfg.get("DATA_PRESET", {})
        self.with_heatmap = dp.get("WITH_HEATMAP", False)
        self.heatmap_size = tuple(dp.get("HEATMAP_SIZE", (32, 32)))
        self.heatmap_sigma = dp.get("HEATMAP_SIGMA", 2.0)

    def __call__(self, image, label, no_rot: bool = False):
        out = super().__call__(image, label, no_rot=no_rot)
        j2d = out["target_joints_2d"]
        W, H = self.output_size

        # joint-visibility recomputation (reference transform.py:127-137)
        jv = label.get("joints_vis", np.ones(j2d.shape[0], np.float32))
        if not self.train:
            vis = np.ones(j2d.shape[0], np.float32)
        elif jv.sum() < j2d.shape[0] * 0.3:
            vis = np.zeros(j2d.shape[0], np.float32)
        else:
            vis = (
                (j2d[:, 0] >= 0) & (j2d[:, 0] < W) & (j2d[:, 1] >= 0) & (j2d[:, 1] < H)
            ).astype(np.float32)
            if vis.sum() < j2d.shape[0] * 0.3:
                vis = np.zeros(j2d.shape[0], np.float32)
        out["target_joints_vis"] = vis

        if self.with_heatmap:
            hw, hh = self.heatmap_size
            hm = np.zeros((j2d.shape[0], hh, hw), np.float32)
            for i in range(j2d.shape[0]):
                cx = j2d[i, 0] / W * hw
                cy = j2d[i, 1] / H * hh
                ys, xs = np.mgrid[0:hh, 0:hw]
                hm[i] = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * self.heatmap_sigma**2))
            out["target_joints_heatmap"] = hm
        return out


@TRANSFORM.register_module("SimpleTransformUVD")
class SimpleTransformUVD(SimpleTransform2D):
    """UVD variant (reference transform.py:199-236): normalised uv in the
    crop + root-relative depth scaled by UVD_DEPTH_RANGE."""

    def __init__(self, cfg, data_preset=None, is_train: bool = True):
        super().__init__(cfg, data_preset=data_preset, is_train=is_train)
        dp = data_preset if data_preset is not None else cfg.get("DATA_PRESET", {})
        self.center_idx = dp.get("CENTER_IDX", 0)

    def __call__(self, image, label, no_rot: bool = False):
        out = super().__call__(image, label, no_rot=no_rot)
        W, H = self.output_size
        res = np.asarray([W, H], np.float32)

        def to_uvd(uvd_raw):
            uv = transform_coords(uvd_raw[:, :2], out["affine"]).astype(np.float32) / res
            d = uvd_raw[:, 2:3] - label["joints_uvd"][self.center_idx, 2]
            d = 0.5 + d / CONST.UVD_DEPTH_RANGE
            return np.concatenate([uv, d], axis=1).astype(np.float32)

        if "joints_uvd" in label:
            out["target_joints_uvd"] = to_uvd(np.asarray(label["joints_uvd"]))
            out["target_root_d"] = np.asarray(label["joints_uvd"])[self.center_idx, 2:3]
        if "verts_uvd" in label:
            out["target_verts_uvd"] = to_uvd(np.asarray(label["verts_uvd"]))
        return out


@TRANSFORM.register_module("SimpleTransform3D")
class SimpleTransform3D(SimpleTransform3DMultiView):
    """Single-view 3D variant — identical math (reference transform.py:285-325
    shares the multiview path minus the master re-basing)."""


@TRANSFORM.register_module("SimpleTransform3DMANO")
class SimpleTransform3DMANO(SimpleTransform3D):
    """3D + MANO-pose rotation (reference transform.py:329-342): the global
    orientation is pre-multiplied by the in-plane augmentation rotation."""

    def __call__(self, image, label, no_rot: bool = False):
        out = super().__call__(image, label, no_rot=no_rot)
        pose = np.asarray(label.get("mano_pose", np.zeros(48, np.float32))).reshape(-1)
        rot_mat = out["extr_prerot"]
        from scipy.spatial.transform import Rotation as R

        orient = R.from_rotvec(pose[:3]).as_matrix()
        pose = pose.copy()
        pose[:3] = R.from_matrix(rot_mat @ orient).as_rotvec()
        out["target_mano_pose"] = pose.reshape(16, 3).astype(np.float32)
        out["target_mano_shape"] = np.asarray(
            label.get("mano_shape", np.zeros(10, np.float32)), np.float32
        )
        return out
