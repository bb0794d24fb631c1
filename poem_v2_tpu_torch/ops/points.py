"""Point-cloud primitives (counterpart of ``poem_v2_tpu/ops/points.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def ball_query(center: torch.Tensor, points: torch.Tensor, k: int, radius: float,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k`` points within ``radius`` of each centre: center (B, M, 3), points
    (B, N, 3) -> (idx (B, M, k) int64, xyz (B, M, k, 3)). Past the hits the index
    is -1 and the xyz 0 (pytorch3d's contract).

    Without a ``generator`` the hits are the nearest k in the ball, ties to the
    lowest index. With one, each (centre, point) pair draws a uniform priority
    from it and the k in-ball points of highest priority are taken: random
    points of the ball, as the reference's permuted cloud gives. The JAX
    function draws its priorities from a threefry key, a stream this one does
    not reproduce, so the two agree in distribution only."""
    d2 = square_distance(center, points)
    in_ball = d2 <= radius * radius
    if generator is None:
        score = torch.where(in_ball, d2, torch.full_like(d2, float("inf")))
        top, idx = torch.sort(score, dim=-1, stable=True)
    else:
        prio = torch.rand(d2.shape, generator=generator, device=generator.device).to(d2.device)
        score = torch.where(in_ball, prio, torch.full_like(prio, -float("inf")))
        top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    valid = torch.isfinite(top)
    idx = torch.where(valid, idx, torch.full_like(idx, -1))
    xyz = torch.where(valid[..., None], index_points(points, idx.clamp_min(0)), 0.0)
    return idx, xyz


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


def build_balanced_buckets(points: np.ndarray, bucket_size: int = 128
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Balanced k-d bucketing of a static cloud for the bucketed exact KNN
    (``ops/knn_attn.py:fused_knn_vector_attention_bucketed``); numpy, on the
    host, once per cloud.

    Recursive median splits along the widest axis until every leaf holds
    exactly ``bucket_size`` points; N must be a multiple of ``bucket_size``.
    Returns (perm, lo, hi): ``perm`` (N,) int32 such that ``points[perm]``
    lays the buckets out one after the other, and ``lo`` / ``hi`` (NB, 3)
    float32, each bucket's tight axis-aligned box: the distance lower bounds
    behind the kernel's exactness margin."""
    pts = np.asarray(points, dtype=np.float32)
    n = pts.shape[0]
    if n % bucket_size:
        raise ValueError(f"{n} points are not a multiple of bucket_size={bucket_size}")

    def split(idx):
        if len(idx) == bucket_size:
            return [idx]
        sub = pts[idx]
        axis = int(np.argmax(sub.max(0) - sub.min(0)))
        order = idx[np.argsort(sub[:, axis], kind="stable")]
        half = len(order) // 2
        # both halves stay multiples of bucket_size
        half -= half % bucket_size
        half = max(bucket_size, min(half, len(order) - bucket_size))
        return split(order[:half]) + split(order[half:])

    leaves = split(np.arange(n))
    perm = np.concatenate(leaves).astype(np.int32)
    lo = np.stack([pts[leaf].min(0) for leaf in leaves]).astype(np.float32)
    hi = np.stack([pts[leaf].max(0) for leaf in leaves]).astype(np.float32)
    return perm, lo, hi


class VoxelBucketTable:
    """Host-built voxel candidate table for KNN against a static cloud (numpy, once
    per cloud).

    A uniform grid over the cloud's box widened by ``margin``; each cell keeps the
    ``width`` cloud points nearest its centre (in ``np.argpartition``'s order). A
    query ranks only its cell's list: its true K nearest are among them whenever
    r_k(q) + |q - c| <= R_width(c), which holds on the BPS ball for queries within
    ``margin`` of the cloud; farther queries get near neighbours."""

    def __init__(self, cloud: np.ndarray, cell_size: float = 0.25, width: int = 768,
                 margin: float = 0.6):
        cloud = np.asarray(cloud, dtype=np.float32)
        self.cloud = cloud
        self.cell_size = float(cell_size)
        self.origin = cloud.min(axis=0) - margin
        extent = cloud.max(axis=0) + margin - self.origin
        self.dims = np.maximum(np.ceil(extent / cell_size).astype(np.int64), 1)  # (3,)
        self.width = int(min(width, cloud.shape[0]))

        gx, gy, gz = [
            self.origin[i] + (np.arange(self.dims[i]) + 0.5) * cell_size for i in range(3)
        ]
        centers = np.stack(np.meshgrid(gx, gy, gz, indexing="ij"), axis=-1).reshape(-1, 3)
        d2 = ((centers[:, None] - cloud[None]) ** 2).sum(-1)  # (n_cells, N)
        # candidate order within a cell is irrelevant (ranked at runtime)
        self.table = np.argpartition(d2, self.width - 1, axis=1)[:, : self.width].astype(np.int32)


def knn_points_bucketed(query: torch.Tensor, table: VoxelBucketTable, k: int,
                        approx: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KNN of query (B, Q, 3) against the static cloud behind ``table``, ranking only
    the query's cell's candidates: (squared dists (B, Q, K), idx (B, Q, K) int64 cloud
    indices, nn_xyz (B, Q, K, 3)), ascending.

    Exact in both modes: ties go to the lowest position in the candidate list, as
    ``lax.top_k`` breaks them. ``approx=True`` (the JAX function's ``approx_max_k``)
    is accepted and ranks exactly too, as the port's other approximate-KNN switches
    do."""
    del approx
    dev = query.device
    cloud = torch.as_tensor(table.cloud, device=dev)
    dims = table.dims
    hi = torch.as_tensor(dims - 1, dtype=torch.int64, device=dev)
    cell = torch.floor((query - torch.as_tensor(table.origin, device=dev)) / table.cell_size)
    cell = torch.minimum(torch.clamp_min(cell.to(torch.int64), 0), hi)
    flat = cell[..., 0] * int(dims[1] * dims[2]) + cell[..., 1] * int(dims[2]) + cell[..., 2]
    cands = torch.as_tensor(table.table, device=dev).long()[flat]  # (B, Q, W)
    diff = query[:, :, None] - cloud[cands]  # (B, Q, W, 3)
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    dist, pos = torch.sort(d2, dim=-1, stable=True)
    idx = torch.gather(cands, -1, pos[..., :k])
    return dist[..., :k], idx, cloud[idx]
