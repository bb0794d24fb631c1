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
