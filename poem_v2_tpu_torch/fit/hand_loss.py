"""Axis-aware anatomical hand losses (counterpart of ``poem_v2_tpu/fit/hand_loss.py``).

The reference fitter's ``HandLoss`` penalties and the manotorch ``AxisLayer``
frames they read: per pose joint an orthonormal anatomy frame in the joint's
local frame (b the bone direction, l the flexion axis, u the splay axis); the
rotation axis of the joint's quaternion is penalised along b (twist) and u
(splay) and pulled onto l, with tolerance windows at the MCP joints and wider
ones at the thumb root. Pose joints 1..15 are MANO-native; ``JOINTS_MAPPING``
gives each one's OpenPose output joint (the child is the next one).
"""

from __future__ import annotations

import numpy as np
import torch

# OpenPose output-joint index of MANO pose joints 1..15 (manotorch
# axislayer joints_mapping); child joint = mapping + 1 along each finger
JOINTS_MAPPING = [5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3]

# MCP joints (first knuckle of index/middle/pinky/ring) get a soft
# tolerance window; the thumb root is the softest
SOFT_IDX = [0, 3, 9, 6]
THUMB_SOFT_IDX = [12]
RESTRICT_IDX = [i for i in range(15) if i not in SOFT_IDX + THUMB_SOFT_IDX]


# quaternion helpers (w, x, y, z), manotorch quatutils' contracts

def quaternion_norm_squared(q: torch.Tensor) -> torch.Tensor:
    return (q * q).sum(-1)


def quaternion_inv(q: torch.Tensor) -> torch.Tensor:
    conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    return conj / quaternion_norm_squared(q)[..., None].clamp_min(1e-12)


def quaternion_mul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    # sqrt(|v|^2 + eps): a finite gradient at v = 0
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-12)


def hand_axes(joints21: torch.Tensor, transforms: torch.Tensor):
    """Per-joint anatomy frames (manotorch AxisLayer): joints21 (B, 21, 3) OpenPose
    order, transforms (B, 16, 4, 4) -> (b, u, l), each (B, 15, 3) unit vectors in
    the joint's local frame."""
    mapping = torch.tensor(JOINTS_MAPPING, device=joints21.device)
    b = joints21[:, mapping] - joints21[:, mapping + 1]  # (B, 15, 3) world
    rot = transforms[:, 1:, :3, :3]
    b = _unit((rot * b[..., :, None]).sum(-2))  # R^T b
    up = torch.tensor([0.0, 1.0, 0.0], dtype=b.dtype, device=b.device).expand_as(b)
    l = _unit(torch.linalg.cross(b, up, dim=-1))
    u = _unit(torch.linalg.cross(l, b, dim=-1))
    return b, u, l


# HandLoss penalties (reference hand_loss.py, formula for formula)

def pose_quat_norm_loss(var_pose: torch.Tensor) -> torch.Tensor:
    """Unnormalised quaternions pulled to unit norm."""
    q = var_pose.reshape(var_pose.shape[0], 16, 4)
    return ((quaternion_norm_squared(q) - 1.0) ** 2).mean()


def pose_reg_loss(var_pose_normed: torch.Tensor, var_pose_init: torch.Tensor) -> torch.Tensor:
    """The w component of q * inv(q_init) pulled to 1."""
    combined = quaternion_mul(var_pose_normed, quaternion_inv(var_pose_init))
    return ((combined[..., 0] - 1.0) ** 2).mean()


def shape_reg_loss(var_shape: torch.Tensor, shape_init: torch.Tensor) -> torch.Tensor:
    return ((var_shape - shape_init) ** 2).sum(-1).mean()


def _axis_cos_loss(axis_cos, angle_mask, soft_tol, thumb_tol, align=False):
    """Restricted joints penalise the cosine (its distance from 1 when ``align``);
    soft joints get a relu window of half-width ``tol``."""
    soft_c, thumb_c = np.cos(np.pi / 2 - soft_tol), np.cos(np.pi / 2 - thumb_tol)
    restrict = axis_cos[:, RESTRICT_IDX]
    if align:
        soft = torch.clamp_min(-axis_cos[:, SOFT_IDX] + 1.0 - soft_c, 0.0)
        thumb = torch.clamp_min(-axis_cos[:, THUMB_SOFT_IDX] + 1.0 - thumb_c, 0.0)
        restrict_term = (restrict - 1.0) * angle_mask[:, RESTRICT_IDX]
    else:
        soft = torch.clamp_min(axis_cos[:, SOFT_IDX].abs() - soft_c, 0.0)
        thumb = torch.clamp_min(axis_cos[:, THUMB_SOFT_IDX].abs() - thumb_c, 0.0)
        restrict_term = restrict * angle_mask[:, RESTRICT_IDX]
    return ((restrict_term ** 2).mean() + ((soft * angle_mask[:, SOFT_IDX]) ** 2).mean()
            + ((thumb * angle_mask[:, THUMB_SOFT_IDX]) ** 2).mean())


def joint_b_axis_loss(b_axis, axis, angle_mask):
    """No twist about the bone; MCPs +-5 deg, thumb +-20 deg."""
    return _axis_cos_loss((b_axis * axis).sum(-1), angle_mask, np.pi / 36, np.pi / 9)


def joint_u_axis_loss(u_axis, axis, angle_mask):
    """No splay; MCPs +-30 deg, thumb +-60 deg."""
    return _axis_cos_loss((u_axis * axis).sum(-1), angle_mask, np.pi / 6, np.pi / 3)


def joint_l_limit_loss(l_axis, axis, angle_mask):
    """The rotation axis aligned with the flexion axis; MCPs 20 deg, thumb 60 deg slack."""
    return _axis_cos_loss((l_axis * axis).sum(-1), angle_mask, np.pi / 9, np.pi / 3, align=True)


def rotation_angle_loss(angle, limit_angle=np.pi / 2, eps=1e-10):
    """Quadratic over-rotation beyond pi / 2."""
    angle = torch.where(angle.abs() > eps, angle, torch.zeros_like(angle))
    return (torch.clamp_min(angle - limit_angle, 0.0) ** 2).mean()


def anatomical_loss(quat_raw: torch.Tensor, quat_normed: torch.Tensor, shape: torch.Tensor,
                    joints21: torch.Tensor, transforms: torch.Tensor, gamma_b: float = 1.0,
                    gamma_u: float = 1.0, gamma_l: float = 0.01,
                    gamma_angle: float = 0.0) -> torch.Tensor:
    """The reference's hand_anatomical_loss with its default gammas: quat_raw /
    quat_normed (B, 16, 4), shape (B, 10), joints21 (B, 21, 3), transforms (B, 16,
    4, 4)."""
    B = quat_raw.shape[0]
    quat_norm = pose_quat_norm_loss(quat_raw)
    init = torch.zeros((B, 15, 4), dtype=quat_raw.dtype, device=quat_raw.device)
    init[..., 0] = 1.0
    pose_reg = pose_reg_loss(quat_normed[:, 1:], init)
    shape_reg = shape_reg_loss(shape, torch.zeros_like(shape))

    b_axis, u_axis, l_axis = hand_axes(joints21, transforms)
    # each joint's rotation axis and angle; sqrt(|v|^2 + eps) keeps the gradient
    # finite at the zero-rotation init
    w = quat_normed[:, 1:, 0].clamp(-1.0, 1.0)
    vec = quat_normed[:, 1:, 1:]
    sin_half = torch.sqrt((vec * vec).sum(-1) + 1e-16)
    axis = vec / sin_half[..., None]
    angle = 2.0 * torch.atan2(sin_half, w)
    angle_mask = (angle >= 1e-2).to(quat_raw.dtype)

    return (1.0 * quat_norm + 0.0 * pose_reg + 0.1 * shape_reg
            + gamma_angle * rotation_angle_loss(angle)
            + gamma_b * joint_b_axis_loss(b_axis, axis, angle_mask)
            + gamma_u * joint_u_axis_loss(u_axis, axis, angle_mask)
            + gamma_l * joint_l_limit_loss(l_axis, axis, angle_mask))
