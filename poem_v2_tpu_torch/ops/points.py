"""Point-cloud primitives (counterpart of ``poem_v2_tpu/ops/points.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2, (..., M, 3) x (..., N, 3) -> (..., M, N), clamped at 0.

    Written as ``|s|^2 + |d|^2 - 2 s.d`` with the three coordinates summed
    one rounded elementwise operation at a time, in one order: no TF32 matrix
    product can touch it, and the CPU and the card form the same values, so
    both pick the same neighbours."""
    sx, sy, sz = (src[..., :, None, i] for i in range(3))
    dx, dy, dz = (dst[..., None, :, i] for i in range(3))
    s2 = sx * sx + sy * sy + sz * sz
    d2 = dx * dx + dy * dy + dz * dz
    cross = sx * dx + sy * dy + sz * dz
    return torch.clamp_min(s2 + d2 - 2.0 * cross, 0.0)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``points`` (B, N, C) by ``idx`` (B, M[, K]) -> (B, M[, K], C)."""
    B = points.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(B, flat.shape[1], points.shape[-1]))
    return out.reshape(idx.shape + (points.shape[-1],))


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact K nearest neighbours, ascending; ties go to the lowest index.

    Returns (squared dists (B, Q, K), idx (B, Q, K) int64, nn_xyz (B, Q, K, 3))."""
    d2 = square_distance(query, points)
    dist, idx = torch.sort(d2, dim=-1, stable=True)
    idx = idx[..., :k]
    return dist[..., :k], idx, index_points(points, idx)


def farthest_point_sampling(points: torch.Tensor, k: int, start_idx: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative farthest point sampling: (B, N, 3) -> (xyz (B, k, 3), idx (B, k) int64)."""
    B, N, _ = points.shape
    idx = torch.full((B, k), start_idx, dtype=torch.long, device=points.device)
    min_d2 = torch.full((B, N), float("inf"), dtype=points.dtype, device=points.device)
    for i in range(1, k):
        last = torch.gather(points, 1, idx[:, i - 1, None, None].expand(B, 1, 3))
        min_d2 = torch.minimum(min_d2, ((points - last) ** 2).sum(-1))
        idx[:, i] = torch.argmax(min_d2, dim=-1)
    return index_points(points, idx), idx
