"""Rotation conversions the port needs (from ``poem_v2_tpu/geometry/rotations.py``):
axis-angle -> matrix for the MANO layer, and 6D -> matrix -> quaternion ->
axis-angle for the parametric head. Float32 throughout; any leading dims."""

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


def quat_to_aa(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4), w first -> axis-angle (..., 3)."""
    quat = quat / _safe_norm(quat)
    w, xyz = quat[..., :1], quat[..., 1:]
    norm = _safe_norm(xyz)
    angle = 2.0 * torch.atan2(norm, w)
    small = norm < 1e-6
    # angle / sin(angle / 2), with its expansion near zero
    scale = torch.where(small, 2.0 + angle * angle / 12.0,
                        angle / torch.where(small, torch.ones_like(norm), norm))
    return xyz * scale


def rotmat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w first, w >= 0.

    Shepperd's method without branches: all four candidates are formed and
    the one with the largest pivot is taken (the first on ties)."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    k = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                     1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([
        torch.stack([k[..., 0], m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, k[..., 1], m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, k[..., 2], m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, k[..., 3]], dim=-1),
    ], dim=-2)  # (..., 4, 4)
    # max + first-index-of-max: torch.argmax does not promise the first on ties
    first = torch.argmax((k == k.max(-1, keepdim=True).values).to(torch.uint8), dim=-1)
    q = torch.gather(cands, -2, first[..., None, None].expand(*first.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotmat_to_aa(matrix: torch.Tensor) -> torch.Tensor:
    return quat_to_aa(rotmat_to_quat(matrix))


def rot6d_to_rotmat(rot6d: torch.Tensor) -> torch.Tensor:
    """6D (..., 6), the matrix's first two rows before orthonormalisation
    (Zhou et al., CVPR 2019) -> rotation matrix (..., 3, 3) by Gram-Schmidt."""
    a1, a2 = rot6d[..., 0:3], rot6d[..., 3:6]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.vector_norm(a2p, dim=-1, keepdim=True).clamp_min(1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def rot6d_to_aa(rot6d: torch.Tensor) -> torch.Tensor:
    return rotmat_to_aa(rot6d_to_rotmat(rot6d))


def rotmat_to_rot6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> 6D (..., 6): its first two rows."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def aa_to_rot6d(axis_angle: torch.Tensor) -> torch.Tensor:
    return rotmat_to_rot6d(aa_to_rotmat(axis_angle))


def quat_to_rot6d(quat: torch.Tensor) -> torch.Tensor:
    return rotmat_to_rot6d(quat_to_rotmat(quat))


def rot6d_to_quat(rot6d: torch.Tensor) -> torch.Tensor:
    return rotmat_to_quat(rot6d_to_rotmat(rot6d))
