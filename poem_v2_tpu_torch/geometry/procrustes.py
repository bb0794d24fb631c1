"""Batched similarity (Procrustes) alignment (counterpart of
``poem_v2_tpu/geometry/procrustes.py``): one batched SVD on the tensors'
device, float32, TF32 off."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Float32 products in full float32 on the card for the duration."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def align_w_scale(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """``pred`` (..., N, 3) aligned to ``gt`` (..., N, 3) by the optimal similarity
    transform (SciPy's ``orthogonal_procrustes`` with the scale, as the
    reference's per-sample loop); float32 on ``pred``'s device."""
    gt, pred = gt.float(), pred.float().to(gt.device)
    with no_tf32():
        t1 = gt.mean(-2, keepdim=True)
        t2 = pred.mean(-2, keepdim=True)
        x1, x2 = gt - t1, pred - t2
        s1 = torch.linalg.vector_norm(x1, dim=(-2, -1), keepdim=True) + 1e-8
        s2 = torch.linalg.vector_norm(x2, dim=(-2, -1), keepdim=True) + 1e-8
        x1, x2 = x1 / s1, x2 / s2
        # R = argmin |x1 R - x2| from the SVD of x1^T x2; aligned pred = (x2 R^T) s
        m = x1.transpose(-1, -2) @ x2                                   # (..., 3, 3)
        u, sv, vt = torch.linalg.svd(m)
        r = u @ vt
        s = sv.sum(-1)[..., None, None]
        aligned = (x2 @ r.transpose(-1, -2)) * s
    return aligned * s1 + t1
