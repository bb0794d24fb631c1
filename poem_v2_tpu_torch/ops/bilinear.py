"""Bilinear sampling of feature maps at points (kernel K4).

Counterpart of ``poem_v2_tpu/ops/pallas_bilinear.py:grid_sample_points_fused``
with the semantics of ``F.grid_sample(bilinear, align_corners=False,
padding_mode="zeros")`` on a flat point list and exact float32 tap
weights, as the JAX package's ``grid_sample_points_matmul`` computes them.
CPU tensors take :func:`plain_grid_sample_points`, CUDA tensors the kernel
in ``csrc/bilinear.cu``, which has no backward (eval only: training samples
with :func:`..sampling.grid_sample_points_matmul`).
"""

from __future__ import annotations

import torch

from . import _lib


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
    """Bilinear samples of ``feat`` (B, H, W, C) at ``coords`` (B, N, 2); (B, N, C)."""
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
    _lib.lib().call("poem_grid_sample_points", _lib.dtype_code(fc), fc.data_ptr(),
                    cc.data_ptr(), out.data_ptr(), B, H, W, C, N, _lib.stream_ptr(feat))
    grid_sample_points.launches += 1
    return out


grid_sample_points.launches = 0
