"""Batched pinhole-camera math (counterpart of ``poem_v2_tpu/geometry/camera.py``).

Every contraction is an elementwise product and a sum, never a matrix
product, so it stays full float32 whatever the TF32 settings are.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The logit of x clamped to [0, 1], each side of the ratio floored at ``eps``."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp_min(eps) / (1.0 - x).clamp_min(eps))


def cam_extr_transf(extr: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rigid transform(s) (..., 4, 4) applied to points (..., N, 3) -> (..., N, 3)."""
    rot = extr[..., :3, :3]
    t = extr[..., :3, 3]
    return (rot[..., None, :, :] * points[..., :, None, :]).sum(-1) + t[..., None, :]


def cam_intr_projection(intr: torch.Tensor, points: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pinhole projection (..., 3, 3) x (..., N, 3) -> uv (..., N, 2); |z| < eps becomes +eps."""
    proj = (intr[..., None, :, :] * points[..., :, None, :]).sum(-1)
    z = proj[..., 2:3]
    z = torch.where(z.abs() < eps, torch.full_like(z, eps), z)
    return proj[..., 0:2] / z


def invert_rigid(extr: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    rot_t = extr[..., :3, :3].transpose(-1, -2)
    t = extr[..., :3, 3]
    t_new = -(rot_t * t[..., None, :]).sum(-1)
    top = torch.cat([rot_t, t_new[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=extr.dtype, device=extr.device)
    bottom = bottom.expand(extr.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def project_world_to_pixel(points_world: torch.Tensor, cam_extr_c2m: torch.Tensor,
                           cam_intr: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) world points, (B, V, 4, 4) camera->master, (B, V, 3, 3) -> (B, V, N, 2) pixels."""
    extr_m2c = invert_rigid(cam_extr_c2m)
    pts_cam = cam_extr_transf(extr_m2c, points_world[:, None])
    return cam_intr_projection(cam_intr, pts_cam)


def mano_to_openpose(j_regressor: torch.Tensor, mano_verts: torch.Tensor) -> torch.Tensor:
    """MANO vertices (..., 778, 3) -> 21 OpenPose-ordered joints (..., 21, 3):
    the 16 regressed joints ((16, 778) ``j_regressor``) plus 5 fingertip vertices."""
    from ..mano.layer import MANO_KPID_2_VERTICES, MANO_TO_OPENPOSE

    joints16 = (j_regressor[:, :, None] * mano_verts[..., None, :, :]).sum(-2)
    tips = mano_verts[..., [v[0] for _, v in sorted(MANO_KPID_2_VERTICES.items())], :]
    return torch.cat([joints16, tips], dim=-2)[..., MANO_TO_OPENPOSE, :]
