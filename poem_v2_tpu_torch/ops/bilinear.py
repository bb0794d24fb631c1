"""Bilinear sampling of feature maps at points (kernel K4).

Counterpart of ``poem_v2_tpu/ops/pallas_bilinear.py:grid_sample_points_fused``
with the semantics of ``F.grid_sample(bilinear, align_corners=False,
padding_mode="zeros")`` on a flat point list and exact float32 tap
weights, as the JAX package's ``grid_sample_points_matmul`` computes them.
CPU tensors take :func:`plain_grid_sample_points`, CUDA tensors the kernel
in ``csrc/bilinear.cu``, which has no backward (eval only: training samples
with :func:`..sampling.grid_sample_points_matmul`). The kernel's launch
geometry is :func:`sampler_geometry`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _lib

SMEM_LIMIT = 232448          # shared memory a block may use on the H100
SLICE_TARGET = 72 * 1024     # a block's shared memory when the map allows: three blocks an SM
TABLE_BYTES = 256 * 32       # the tap table of 256 points: four weights, four cells
SMS = 132
BLOCKS_PER_SM = 8            # blocks launched an SM (4 and 16 read no better on the H100)


class SamplerGeometry(NamedTuple):
    """How ``csrc/bilinear.cu`` cuts one call: ``unit`` elements an access
    (16 bytes' worth, or 1 where a row is not whole 16-byte units or the map
    is not aligned), ``slice_units`` units a channel slice (``slices`` of
    them, the last may be shorter), ``chunk_points`` points a block
    (``chunks`` of them), ``tx`` lanes a point, ``direct`` (taps read from
    device memory: the slice of one unit a cell does not fit) and the
    block's shared-memory bytes."""
    unit: int
    slice_units: int
    slices: int
    chunk_points: int
    chunks: int
    tx: int
    direct: bool
    smem_bytes: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=256)
def sampler_geometry(B: int, H: int, W: int, C: int, N: int, elem_bytes: int,
                     aligned: bool = True) -> SamplerGeometry:
    """The launch geometry of the sampler kernel for feat (B, H, W, C) and N
    points a map.

    A block stages one channel slice of its map, as many 16-byte units a cell
    as keep it within ``SLICE_TARGET`` bytes (with the tap table), else as
    many as fit ``SMEM_LIMIT``, else none (``direct``); slices are balanced.
    Point chunks are cut so that about ``BLOCKS_PER_SM`` blocks an SM are
    launched, and hold at least 256 points each. Cached: a request's host
    time is of the order of the kernel's."""
    vec = 16 // elem_bytes
    unit = vec if aligned and C % vec == 0 else 1
    units = C // unit
    cell_bytes = H * W * unit * elem_bytes  # one unit of every cell
    per_slice = (SLICE_TARGET - TABLE_BYTES) // cell_bytes
    if per_slice < 1:
        per_slice = (SMEM_LIMIT - TABLE_BYTES) // cell_bytes
    direct = per_slice < 1
    if direct:
        per_slice = 32
    slices = -(-units // per_slice)
    slice_units = -(-units // slices)
    tx = min(32, _pow2_at_least(slice_units))
    max_chunks = -(-N // 256)
    chunks = max(1, min(max_chunks, -(-BLOCKS_PER_SM * SMS // (B * slices))))
    chunk_points = -(-N // chunks)
    chunks = -(-N // chunk_points)
    smem = TABLE_BYTES + (0 if direct else cell_bytes * slice_units)
    return SamplerGeometry(unit, slice_units, slices, chunk_points, chunks, tx, direct, smem)


def plain_grid_sample_points(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C), coords (B, N, 2) in [-1, 1] -> (B, N, C) in feat's dtype.

    Sums the taps in the kernel's order, (dx, dy) = (0,0), (0,1), (1,0), (1,1),
    one rounded float32 operation at a time."""
    B, H, W, C = feat.shape
    N = coords.shape[1]
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    ix = ((x + 1.0) * W - 1.0) * 0.5
    iy = ((y + 1.0) * H - 1.0) * 0.5
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0
    flat = feat.reshape(B, H * W, C)
    acc = torch.zeros((B, N, C), dtype=torch.float32, device=feat.device)
    for dx in (0, 1):
        px = x0 + dx
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            py = y0 + dy
            wy = fy if dy else 1.0 - fy
            inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
            w = torch.where(inside, wx * wy, torch.zeros_like(wx))
            cell = torch.where(inside, py * W + px, torch.zeros_like(px)).long()
            vals = torch.gather(flat, 1, cell[..., None].expand(B, N, C)).float()
            acc = acc + w[..., None] * vals
    return acc.to(feat.dtype)


def grid_sample_points(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``feat`` (B, H, W, C) at ``coords`` (B, N, 2); (B, N, C).

    On the card the kernel is cut by :func:`sampler_geometry`."""
    if feat.device.type == "cpu":
        return plain_grid_sample_points(feat, coords)
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    B, H, W, C = feat.shape
    if coords.dim() != 3 or coords.shape[0] != B or coords.shape[2] != 2:
        raise ValueError(f"coords must be (B, N, 2) with B={B}, got {tuple(coords.shape)}")
    if coords.device != feat.device:
        raise ValueError("feat and coords must be on one device")
    _lib.no_grad_guard("grid_sample_points", feat, coords)
    N = coords.shape[1]
    fc = feat.contiguous()
    cc = coords.float().contiguous()
    out = torch.empty((B, N, C), dtype=feat.dtype, device=feat.device)
    g = sampler_geometry(B, H, W, C, N, fc.element_size(), aligned=fc.data_ptr() % 16 == 0)
    _lib.lib().call("poem_grid_sample_points", _lib.dtype_code(fc), fc.data_ptr(),
                    cc.data_ptr(), out.data_ptr(), B, H, W, C, N, g.unit, g.slice_units,
                    g.chunk_points, g.tx, int(g.direct), _lib.stream_ptr(feat))
    grid_sample_points.launches += 1
    return out


grid_sample_points.launches = 0
