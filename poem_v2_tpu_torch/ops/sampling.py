"""Bilinear point sampling for training, and grid helpers
(counterpart of ``poem_v2_tpu/ops/sampling.py``).

The eval sampler is kernel K4 (:mod:`.bilinear`), which has no backward.
Training samples with :func:`grid_sample_points_matmul`, as the JAX head
does (``ptemb_head.py:239-242``).
"""

from __future__ import annotations

import torch


def grid_sample_points_matmul(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``feat`` (B, H, W, C) at ``coords`` (B, N, 2) in [-1, 1]
    (``F.grid_sample`` bilinear, ``align_corners=False``, zero padding) as one
    product with the (B, N, H*W) interpolation matrix; (B, N, C).

    The matrix is built in feat's dtype from float32 tap positions, as the JAX
    function builds it, and the product is differentiable in ``feat``."""
    B, H, W, C = feat.shape
    N = coords.shape[1]
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    ix = ((x + 1.0) * W - 1.0) * 0.5
    iy = ((y + 1.0) * H - 1.0) * 0.5
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    fx = ix - ix0
    fy = iy - iy0
    cells = torch.arange(H * W, device=feat.device)
    cols_x, cols_y = cells % W, cells // W
    wdt = feat.dtype
    weight = torch.zeros((B, N, H * W), dtype=wdt, device=feat.device)
    for dx, wx in ((0, 1.0 - fx), (1, fx)):
        px = ix0 + dx
        in_x = (px >= 0) & (px <= W - 1)
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            py = iy0 + dy
            in_y = (py >= 0) & (py <= H - 1)
            match = ((cols_x == px.to(torch.int32)[..., None])
                     & (cols_y == py.to(torch.int32)[..., None]))
            w = (wx * wy * (in_x & in_y)).to(wdt)
            weight = weight + match.to(wdt) * w[..., None]
    with torch.autocast(feat.device.type, enabled=False):
        return torch.bmm(weight, feat.reshape(B, H * W, C))


def pixel_to_grid(uv: torch.Tensor, inp_res) -> torch.Tensor:
    """Pixel coords (..., 2) -> [-1, 1] grid coords: uv / inp_res * 2 - 1."""
    res = torch.tensor(inp_res, dtype=uv.dtype, device=uv.device)
    return uv / res * 2.0 - 1.0
