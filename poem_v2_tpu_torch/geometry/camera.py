"""Batched pinhole-camera math (counterpart of ``poem_v2_tpu/geometry/camera.py``).

Every contraction is an elementwise product and a sum, never a matrix
product, so it stays full float32 whatever the TF32 settings are.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils.misc import CONST
from ..utils.profiling import sync_point


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


def persp_project(points: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pinhole projection without the z clamp: (..., N, 3) x (..., 3, 3) -> (..., N, 2)."""
    proj = (intr[..., None, :, :] * points[..., :, None, :]).sum(-1)
    return proj[..., :2] / proj[..., 2:3]


def rigid_inverse_rows(extr: torch.Tensor) -> torch.Tensor:
    """The top rows [R^T | -R^T t] (..., 3, 4) of the inverse of (..., 4, 4) rigid
    transforms: :func:`invert_rigid` without its constant bottom row."""
    rot_t = extr[..., :3, :3].transpose(-1, -2)
    t = extr[..., :3, 3]
    t_new = -(rot_t * t[..., None, :]).sum(-1)
    return torch.cat([rot_t, t_new[..., None]], dim=-1)


def invert_rigid(extr: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    top = rigid_inverse_rows(extr)
    with sync_point("invert_rigid", extr.device):  # a blocking copy
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


def _focal_centre(intr: torch.Tensor):
    f = torch.stack([intr[..., 0, 0], intr[..., 1, 1]], dim=-1)[..., None, :]
    c = torch.stack([intr[..., 0, 2], intr[..., 1, 2]], dim=-1)[..., None, :]
    return f, c


def xyz_to_uvd(xyz: torch.Tensor, root_joint: torch.Tensor, intr: torch.Tensor,
               inp_res: Sequence[int], depth_range: float = CONST.UVD_DEPTH_RANGE,
               ref_bone_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Camera-space xyz (..., N, 3) -> normalized uvd (..., N, 3): uv the pixel over
    ``inp_res`` (w, h), d the depth from the root over the bone length, mapped so
    that ``depth_range`` spans [0, 1] around 0.5."""
    res = torch.as_tensor(inp_res, dtype=xyz.dtype, device=xyz.device)
    if ref_bone_len is None:
        ref_bone_len = torch.ones(xyz.shape[:-2] + (1,), dtype=xyz.dtype, device=xyz.device)
    z = xyz[..., 2]
    xy_ = xyz[..., :2] / z[..., None]
    z_ = (z - root_joint[..., -1:]) / ref_bone_len
    f, c = _focal_centre(intr)
    uv = (xy_ * f + c) / res
    return torch.cat([uv, (z_ / depth_range + 0.5)[..., None]], dim=-1)


def uvd_to_xyz(uvd: torch.Tensor, root_joint: torch.Tensor, intr: torch.Tensor,
               inp_res: Sequence[int], depth_range: float = CONST.UVD_DEPTH_RANGE,
               ref_bone_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse of :func:`xyz_to_uvd`: normalized uvd (..., N, 3) -> xyz (..., N, 3)."""
    res = torch.as_tensor(inp_res, dtype=uvd.dtype, device=uvd.device)
    if ref_bone_len is None:
        ref_bone_len = torch.ones(uvd.shape[:-2] + (1,), dtype=uvd.dtype, device=uvd.device)
    uv = uvd[..., :2] * res
    z = (uvd[..., 2] - 0.5) * depth_range * ref_bone_len + root_joint[..., -1:]
    f, c = _focal_centre(intr)
    xy = (uv - c) / f * z[..., None]
    return torch.cat([xy, z[..., None]], dim=-1)


def ref_bone_len(joints: torch.Tensor, link=(0, 9)) -> torch.Tensor:
    """Length of the chain ``link`` (default wrist -> middle MCP) of (..., J, 3), (..., 1)."""
    total = torch.zeros(joints.shape[:-2] + (1,), dtype=joints.dtype, device=joints.device)
    for a, b in zip(link[:-1], link[1:]):
        total = total + torch.linalg.vector_norm(joints[..., a, :] - joints[..., b, :], dim=-1,
                                                 keepdim=True)
    return total
