"""Masked batched DLT triangulation (counterpart of ``poem_v2_tpu/geometry/triangulation.py``).

A^T A of every joint's DLT system goes through a fixed-sweep cyclic
Jacobi eigensolver and the eigenvector of the smallest eigenvalue is
picked by argmin, exactly as the JAX package does, so both pick the same
eigenvector (``torch.linalg.eigh`` would order and sign them its own way).
All in float32 with elementwise products only.

This is the plain chain. The model's entry point is
:func:`~..ops.triangulate.triangulate_dlt_c2m` (camera->master extrinsics): CPU
tensors take this chain, CUDA tensors one launch of ``csrc/triangulate.cu``, which
keeps this chain's arithmetic (float32, 6 sweeps of 6 rotations, :data:`DLT_EPS`,
no fused multiply-add), with no fallback from one to the other. The kernel is
eval only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# w's guard in the final x[:3] / (x[3] + eps); csrc/triangulate.cu holds the same
DLT_EPS = 1e-7
_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def jacobi_eigh_4x4(a: torch.Tensor, sweeps: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 4, 4) symmetric -> (eigvals (..., 4) unsorted, eigvecs (..., 4, 4) column-wise)."""
    a = a.float().clone()
    v = torch.eye(4, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for _ in range(sweeps):
        for p, q in _PAIRS:
            app, aqq, apq = a[..., p, p], a[..., q, q], a[..., p, q]
            small = apq.abs() <= 1e-30 * (app.abs() + aqq.abs() + 1e-30)
            tau = (aqq - app) / torch.where(small, torch.ones_like(apq), 2.0 * apq)
            sgn = torch.where(tau >= 0, 1.0, -1.0).to(a.dtype)
            t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(small, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            c_, s_ = c[..., None], s[..., None]
            row_p, row_q = a[..., p, :].clone(), a[..., q, :].clone()
            a[..., p, :] = c_ * row_p - s_ * row_q
            a[..., q, :] = s_ * row_p + c_ * row_q
            col_p, col_q = a[..., :, p].clone(), a[..., :, q].clone()
            a[..., :, p] = c_ * col_p - s_ * col_q
            a[..., :, q] = s_ * col_p + c_ * col_q
            vp, vq = v[..., :, p].clone(), v[..., :, q].clone()
            v[..., :, p] = c_ * vp - s_ * vq
            v[..., :, q] = s_ * vp + c_ * vq
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def triangulate_dlt(kp2d: torch.Tensor, cam_intr: torch.Tensor, extr_m2c: torch.Tensor,
                    view_mask: Optional[torch.Tensor] = None, eps: float = DLT_EPS) -> torch.Tensor:
    """(B, V, J, 2) pixel keypoints, (B, V, 3, 3), (B, V, 4, 4) master->camera,
    (B, V) mask -> (B, J, 3) points (Hartley & Zisserman 12.2); masked views drop out."""
    B, V, J, _ = kp2d.shape
    P = extr_m2c[..., :3, :]
    Mx = (cam_intr[..., :, :, None] * P[..., None, :, :]).sum(-2)  # (B, V, 3, 4)
    a = kp2d[..., None] * Mx[:, :, None, 2:3, :]                     # (B, V, J, 2, 4)
    a = a - Mx[:, :, None, :2, :]
    if view_mask is not None:
        a = a * view_mask[:, :, None, None, None].to(a.dtype)
    a = a.transpose(1, 2).reshape(B, J, 2 * V, 4)
    ata = (a[..., :, :, None] * a[..., :, None, :]).sum(-3)         # (B, J, 4, 4)
    eigvals, eigvecs = jacobi_eigh_4x4(ata)
    sel = torch.argmin(eigvals, dim=-1)
    x = torch.gather(eigvecs, -1, sel[..., None, None].expand(B, J, 4, 1))[..., 0]
    return x[..., :3] / (x[..., 3:] + eps)
