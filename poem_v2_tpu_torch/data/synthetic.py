"""Synthetic, geometry-consistent multi-view batches
(counterpart of ``poem_v2_tpu/data/synthetic.py``).

A MANO hand posed in the master frame, V_max pinhole cameras on a sphere
looking at it, per-view projected 2D joints and a per-sample random
valid-view count in ``view_range`` (the master is always view 0). For the
same seed the numpy draws are the JAX package's, in the same order, so
both yield the same arrays (the MANO skinning agrees to float32 rounding).
Images are noise, or with ``render`` the hand's skeleton drawn over a dim
noise background by the viztools (the convergence-gate protocols).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..mano.layer import ManoLayer


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world rotation whose +z looks from eye to target."""
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, z)) > 0.98:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)  # columns are camera axes in world


class SyntheticMultiviewDataset:
    """Deterministic infinite stream of padded multi-view samples (numpy)."""

    def __init__(self, batch_size: int = 2, view_max: int = 4,
                 view_range: Tuple[int, int] = (1, 4), image_size: int = 256, seed: int = 0,
                 mano_layer: Optional[ManoLayer] = None, random_views: bool = True,
                 render: bool = False):
        self.batch_size = batch_size
        self.view_max = view_max
        self.view_range = (max(1, view_range[0]), min(view_max, view_range[1]))
        self.image_size = image_size
        self.rs = np.random.RandomState(seed)
        self.mano = mano_layer if mano_layer is not None else ManoLayer()
        self.random_views = random_views
        # render=False: noise images, enough for plumbing and timing runs, where the
        # heatmap branch can only memorise noise; render=True draws the articulated
        # skeleton (per-finger bones and joint discs) into every view, so the 2D
        # branch has a visual mapping to learn
        self.render = render

    def sample_batch(self) -> Dict[str, np.ndarray]:
        B, V, S = self.batch_size, self.view_max, self.image_size
        rs = self.rs

        pose = rs.randn(B, 48).astype(np.float32) * 0.1
        betas = rs.randn(B, 10).astype(np.float32) * 0.3
        with torch.no_grad():
            out = self.mano(torch.from_numpy(pose), torch.from_numpy(betas))
        joints = out.joints.numpy()
        verts = out.verts.numpy()
        # place the hand in front of the master camera (z in [0.45, 0.75])
        offset = np.stack(
            [rs.uniform(-0.05, 0.05, B), rs.uniform(-0.05, 0.05, B), rs.uniform(0.45, 0.75, B)],
            axis=1,
        ).astype(np.float32)
        joints = joints + offset[:, None]
        verts = verts + offset[:, None]

        # master camera = identity; other cameras on a sphere around the hand
        cam_extr = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
        for b in range(B):
            centre = joints[b].mean(0)
            for v in range(1, V):
                angle = rs.uniform(0, 2 * np.pi)
                elev = rs.uniform(-0.6, 0.6)
                radius = np.linalg.norm(centre) * rs.uniform(0.8, 1.2)
                eye = centre + radius * np.array(
                    [np.cos(angle) * np.cos(elev), np.sin(elev), np.sin(angle) * np.cos(elev)]
                )
                cam_extr[b, v, :3, :3] = _look_at(eye.astype(np.float64), centre.astype(np.float64))
                cam_extr[b, v, :3, 3] = eye

        cam_intr = np.zeros((B, V, 3, 3), dtype=np.float32)
        f = S * 1.8
        cam_intr[..., 0, 0] = f
        cam_intr[..., 1, 1] = f
        cam_intr[..., 0, 2] = S / 2
        cam_intr[..., 1, 2] = S / 2
        cam_intr[..., 2, 2] = 1.0

        # project the ground-truth joints into every view
        m2c = np.linalg.inv(cam_extr)
        pts_cam = (np.einsum("bvij,bnj->bvni", m2c[..., :3, :3], joints)
                   + m2c[..., :3, 3][:, :, None])
        proj = np.einsum("bvni,bvji->bvnj", pts_cam, cam_intr)
        joints_2d = (proj[..., :2] / proj[..., 2:]).astype(np.float32)

        if self.random_views:
            lo, hi = self.view_range
            n = np.clip(np.round(rs.normal(4.0, 2.0, B)).astype(int), lo, hi)
        else:
            n = np.full(B, self.view_range[1], dtype=int)
        view_mask = np.arange(V)[None, :] < n[:, None]
        if self.render:
            from ..viztools.draw import draw_joints_2d

            # a dim noise background under a crisp skeleton in every view
            bg = (rs.rand(B, V, S, S, 3) * 40.0).astype(np.uint8)
            images = np.empty((B, V, S, S, 3), dtype=np.float32)
            radius = max(2, S // 64)
            for b in range(B):
                for v in range(V):
                    drawn = draw_joints_2d(bg[b, v], joints_2d[b, v], radius=radius)
                    images[b, v] = drawn.astype(np.float32) / 255.0 - 0.5
        else:
            images = rs.rand(B, V, S, S, 3).astype(np.float32) - 0.5

        return {
            "image": images,
            "view_mask": view_mask,
            "cam_intr": cam_intr,
            "cam_extr": cam_extr,
            "master_joints_3d": joints.astype(np.float32),
            "master_verts_3d": verts.astype(np.float32),
            "target_joints_2d": joints_2d,
            "mano_pose": pose.reshape(B, 16, 3),
            "mano_shape": betas,
        }

    def __iter__(self):
        while True:
            yield self.sample_batch()
