"""Bilinear point sampling for training and the other heads, and grid helpers
(counterpart of ``poem_v2_tpu/ops/sampling.py``).

The POEM head's eval sampler is kernel K4 (:mod:`.bilinear`), which has no
backward. Training samples with :func:`grid_sample_points_matmul`, as the JAX
head does (``ptemb_head.py:239-242``), and so does the PtEmbedTRv3 decoder's
coarse-mesh sampler. The v1 heads take :func:`grid_sample_points`, the JAX
package's 4-tap gather (XLA there, plain PyTorch here).
"""

from __future__ import annotations

import torch

from ..utils.profiling import sync_point


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


def grid_sample_points(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``feat`` (B, H, W, C) at ``coords`` (B, N, 2) in [-1, 1]
    (x over the width, then y; ``align_corners=False``, zero outside) as four
    row gathers; (B, N, C). The tap positions are computed in ``coords``' dtype
    and the weights in ``feat``'s, as the JAX function computes them."""
    B, H, W, C = feat.shape
    x, y = coords[..., 0], coords[..., 1]
    ix = ((x + 1.0) * W - 1.0) * 0.5
    iy = ((y + 1.0) * H - 1.0) * 0.5
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    fx, fy = ix - ix0, iy - iy0
    flat = feat.reshape(B, H * W, C)

    def gather(px, py):
        inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
        idx = py.clamp(0, H - 1).to(torch.int64) * W + px.clamp(0, W - 1).to(torch.int64)
        vals = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))
        return vals * inside[..., None].to(feat.dtype)

    v00, v01 = gather(ix0, iy0), gather(ix0 + 1, iy0)
    v10, v11 = gather(ix0, iy0 + 1), gather(ix0 + 1, iy0 + 1)
    fx = fx[..., None].to(feat.dtype)
    fy = fy[..., None].to(feat.dtype)
    top = v00 * (1 - fx) + v01 * fx
    bottom = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bottom * fy


def pixel_to_grid(uv: torch.Tensor, inp_res) -> torch.Tensor:
    """Pixel coords (..., 2) -> [-1, 1] grid coords: uv / inp_res * 2 - 1."""
    with sync_point("pixel_to_grid", uv.device):  # a blocking copy
        res = torch.tensor(inp_res, dtype=uv.dtype, device=uv.device)
    return uv / res * 2.0 - 1.0
