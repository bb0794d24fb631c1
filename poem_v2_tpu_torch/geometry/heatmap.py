"""Integral (soft-argmax) heatmap decoding (counterpart of ``poem_v2_tpu/geometry/heatmap.py``)."""

from __future__ import annotations

import torch


def normalize_heatmap(heatmap: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize each (H, W) map of (..., H, W) to sum to one."""
    flat = heatmap.reshape(heatmap.shape[:-2] + (-1,))
    flat = flat / (flat.sum(-1, keepdim=True) + eps)
    return flat.reshape(heatmap.shape)


def integral_heatmap2d(heatmap: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) normalized maps -> uv (..., C, 2) in [0, 1), u along width."""
    h, w = heatmap.shape[-2:]
    v_accu = heatmap.sum(-1)
    u_accu = heatmap.sum(-2)
    weight_v = torch.arange(h, dtype=heatmap.dtype, device=heatmap.device) / h
    weight_u = torch.arange(w, dtype=heatmap.dtype, device=heatmap.device) / w
    return torch.stack([(u_accu * weight_u).sum(-1), (v_accu * weight_v).sum(-1)], dim=-1)


def integral_heatmap3d(heatmap: torch.Tensor) -> torch.Tensor:
    """(..., C, D, H, W) normalized volumes -> uvd (..., C, 3) in [0, 1)."""
    d_sz, h_sz, w_sz = heatmap.shape[-3:]
    d_accu = heatmap.sum((-2, -1))
    v_accu = heatmap.sum((-3, -1))
    u_accu = heatmap.sum((-3, -2))

    def weights(n):
        return torch.arange(n, dtype=heatmap.dtype, device=heatmap.device) / n

    return torch.stack([(u_accu * weights(w_sz)).sum(-1), (v_accu * weights(h_sz)).sum(-1),
                        (d_accu * weights(d_sz)).sum(-1)], dim=-1)


def gaussian_heatmap2d(uv: torch.Tensor, hm_size: int = 32, sigma: float = 2.0) -> torch.Tensor:
    """Gaussian target maps: uv (..., C, 2) in [0, 1] -> (..., C, hm_size, hm_size),
    the centre at uv * hm_size (u along the width), peak 1."""
    grid = torch.arange(hm_size, dtype=uv.dtype, device=uv.device)
    du = grid - uv[..., 0:1] * hm_size
    dv = grid - uv[..., 1:2] * hm_size
    return torch.exp(-(dv[..., :, None] ** 2 + du[..., None, :] ** 2) / (2.0 * sigma ** 2))
