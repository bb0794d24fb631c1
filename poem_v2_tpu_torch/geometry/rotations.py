"""Axis-angle to rotation matrix via quaternions (from ``poem_v2_tpu/geometry/rotations.py``)."""

from __future__ import annotations

import torch


def _safe_norm(x: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), eps))


def aa_to_quat(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4), w first."""
    angle = _safe_norm(axis_angle)
    small = angle < 1e-6
    sin_half_over = torch.where(
        small, 0.5 - angle * angle / 48.0,
        torch.sin(0.5 * angle) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(0.5 * angle), axis_angle * sin_half_over], dim=-1)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4), w first -> rotation matrix (..., 3, 3)."""
    quat = quat / _safe_norm(quat)
    w, x, y, z = quat.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def aa_to_rotmat(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    return quat_to_rotmat(aa_to_quat(axis_angle))
