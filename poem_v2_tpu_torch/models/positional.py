"""Sine positional encodings over (view, y, x) and of 3D points
(counterpart of ``poem_v2_tpu/models/positional.py``)."""

from __future__ import annotations

import math

import torch


def sine_positional_encoding_3d_factors(view_mask: torch.Tensor, height: int, width: int,
                                        num_feats: int = 128, temperature: float = 10000.0,
                                        normalize: bool = True, scale: float = 2 * math.pi,
                                        eps: float = 1e-6, offset: float = 0.0):
    """The three broadcast factors of the 3D sine encoding, float32.

    Returns (pos_n (B, V, F), pos_y (B, V, H, F), pos_x (B, V, W, F)) in the
    reference's BLOCKED channel layout [sin(f0), sin(f2), ..., cos(f1), cos(f3), ...]."""
    dev = view_mask.device
    vm = view_mask.float()
    n_embed = torch.cumsum(vm, dim=1) * vm
    y_embed = (torch.arange(height, dtype=torch.float32, device=dev) + 1.0)[None, None] * vm[..., None]
    x_embed = (torch.arange(width, dtype=torch.float32, device=dev) + 1.0)[None, None] * vm[..., None]
    if normalize:
        n_last = vm.sum(1, keepdim=True)
        n_embed = (n_embed + offset) / (n_last + eps) * scale
        y_embed = (y_embed + offset) / (y_embed[..., -1:] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[..., -1:] + eps) * scale
    i = torch.arange(num_feats, dtype=torch.float32, device=dev)
    dim_t = temperature ** (2.0 * torch.floor(i / 2.0) / num_feats)

    def blocked_sin_cos(vals):
        return torch.cat([torch.sin(vals[..., 0::2]), torch.cos(vals[..., 1::2])], dim=-1)

    return (blocked_sin_cos(n_embed[..., None] / dim_t),
            blocked_sin_cos(y_embed[..., None] / dim_t),
            blocked_sin_cos(x_embed[..., None] / dim_t))


def sine_positional_encoding_3d(view_mask: torch.Tensor, height: int, width: int,
                                num_feats: int = 128, temperature: float = 10000.0,
                                normalize: bool = True, scale: float = 2 * math.pi,
                                eps: float = 1e-6, offset: float = 0.0) -> torch.Tensor:
    """The expanded encoding: (B, V, H, W, 3 * num_feats) float32, channels (n, y, x)."""
    B, V = view_mask.shape
    pos_n, pos_y, pos_x = sine_positional_encoding_3d_factors(
        view_mask, height, width, num_feats, temperature, normalize, scale, eps, offset)
    full = (B, V, height, width, num_feats)
    return torch.cat([pos_n[:, :, None, None].expand(full), pos_y[:, :, :, None].expand(full),
                      pos_x[:, :, None, :].expand(full)], dim=-1)


def pos2posemb3d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """Sine embedding of 3D coordinates: (..., 3) -> (..., 3 * num_pos_feats), channel
    order (y, x, z), each block sin / cos interleaved (the reference's ``pos2posemb3d``)."""
    pos = pos * (2 * math.pi)
    i = torch.arange(num_pos_feats, dtype=pos.dtype, device=pos.device)
    dim_t = temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)

    def emb(v):
        vals = v[..., None] / dim_t
        return torch.stack([torch.sin(vals[..., 0::2]), torch.cos(vals[..., 1::2])],
                           dim=-1).reshape(vals.shape[:-1] + (num_pos_feats,))

    return torch.cat([emb(pos[..., 1]), emb(pos[..., 0]), emb(pos[..., 2])], dim=-1)
