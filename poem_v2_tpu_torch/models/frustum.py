"""Camera-frustum 3D position embedding, PETR style
(counterpart of ``poem_v2_tpu/models/frustum.py``).

Each view's frustum is cut into W x H x D points (linear or LID depth bins
over [depth_start, depth_end]), lifted through K^-1, moved to the master
frame by the camera's extrinsics, normalised by the position range, and its
``inverse_sigmoid`` logits go through two 1x1 convolutions. Used by the POEM
head's ``PETR_EMBEDDING`` option and by the v1 heads.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..geometry.camera import inverse_sigmoid


def frustum_points(cam_intr: torch.Tensor, cam_extr: torch.Tensor, feat_hw: Tuple[int, int],
                   inp_hw: Tuple[int, int], depth_num: int = 32, depth_start: float = 0.0,
                   depth_end: float = 1.2, lid: bool = False) -> torch.Tensor:
    """Frustum sample points in the master frame: (B, V, W, H, D, 3) float32, from
    cam_intr (B, V, 3, 3) and cam_extr (B, V, 4, 4) camera -> master.

    The rotation is written out as products and sums in float32 (the JAX
    function's einsum runs at "highest" precision), so no TF32 product touches it."""
    H, W = feat_hw
    inp_h, inp_w = inp_hw
    f32, dev = torch.float32, cam_intr.device
    coords_h = torch.arange(H, dtype=f32, device=dev) * inp_h / H
    coords_w = torch.arange(W, dtype=f32, device=dev) * inp_w / W
    index = torch.arange(depth_num, dtype=f32, device=dev)
    if lid:
        bin_size = (depth_end - depth_start) / (depth_num * (1 + depth_num))
        coords_d = depth_start + bin_size * index * (index + 1)
    else:
        bin_size = (depth_end - depth_start) / depth_num
        coords_d = depth_start + bin_size * index

    u = coords_w[:, None, None]
    v = coords_h[None, :, None]
    d = coords_d[None, None, :]
    intr = cam_intr.float()[..., None, None, None, :, :]  # (B, V, 1, 1, 1, 3, 3)
    fx, fy, cx, cy = intr[..., 0, 0], intr[..., 1, 1], intr[..., 0, 2], intr[..., 1, 2]
    B, V = cam_intr.shape[:2]
    full = (B, V, W, H, depth_num)
    xyz = ((u - cx) / fx * d).expand(full), ((v - cy) / fy * d).expand(full), d.expand(full)
    extr = cam_extr.float()[..., None, None, None, :, :]
    return torch.stack([extr[..., i, 0] * xyz[0] + extr[..., i, 1] * xyz[1]
                        + extr[..., i, 2] * xyz[2] + extr[..., i, 3] for i in range(3)], dim=-1)


class FrustumPositionEncoder(nn.Module):
    """inverse_sigmoid(normalised frustum) -> 1x1 conv -> relu -> 1x1 conv -> embed_dims.

    ``hidden_mult`` sets the hidden width: 2 for the POEM head's
    ``position_encoder``, 4 for the PETR head's."""

    def __init__(self, embed_dims: int = 256, depth_num: int = 32, depth_start: float = 0.0,
                 depth_end: float = 1.2, lid: bool = False,
                 position_range: Sequence[float] = (-0.6, -0.6, 0.0, 0.6, 0.6, 1.2),
                 hidden_mult: int = 2):
        super().__init__()
        self.depth_num, self.depth_start, self.depth_end, self.lid = (
            depth_num, depth_start, depth_end, lid)
        self.position_range = tuple(float(p) for p in position_range)
        self.pe_conv1 = nn.Conv2d(depth_num * 3, embed_dims * hidden_mult, 1)
        self.pe_conv2 = nn.Conv2d(embed_dims * hidden_mult, embed_dims, 1)

    def forward(self, cam_intr: torch.Tensor, cam_extr: torch.Tensor, feat_hw: Tuple[int, int],
                inp_hw: Tuple[int, int]):
        """Returns (embedding (B, V, H, W, embed_dims) channels-last,
        points (B, V, W, H, D, 3) in the master frame, out-of-range mask)."""
        pts = frustum_points(cam_intr, cam_extr, feat_hw, inp_hw, self.depth_num,
                             self.depth_start, self.depth_end, self.lid)
        pr = torch.tensor(self.position_range, dtype=torch.float32, device=pts.device)
        lo, hi = pr[:3], pr[3:]
        norm = (pts - lo) / (hi - lo)
        coords_mask = (norm > 1.0) | (norm < 0.0)
        B, V, W, H, D, _ = norm.shape
        # channel d * 3 + coord: the reference flattens (D, 3) depth-major
        feat = inverse_sigmoid(norm.permute(0, 1, 3, 2, 4, 5).reshape(B, V, H, W, D * 3))
        w1 = self.pe_conv1.weight
        x = torch.relu(nn.functional.linear(feat.to(w1.dtype), w1[:, :, 0, 0], self.pe_conv1.bias))
        x = nn.functional.linear(x, self.pe_conv2.weight[:, :, 0, 0], self.pe_conv2.bias)
        return x, pts, coords_mask
