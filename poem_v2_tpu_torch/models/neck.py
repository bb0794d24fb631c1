"""Feature necks for HRNet and ResNet (counterpart of ``poem_v2_tpu/models/neck.py``), NCHW."""

from __future__ import annotations

from typing import Sequence, Tuple

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .backbones.resnet import make_norm


class ConvBlock(nn.Module):
    """Conv (with bias) + optional norm + optional ReLU."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, strides: int = 1,
                 norm: str = "gn", relu: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel_size, strides, padding=kernel_size // 2)
        self.norm_0 = make_norm(norm, features) if norm != "none" else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.norm_0 is not None:
            x = self.norm_0(x)
        return torch.relu(x) if self.relu else x


@functools.lru_cache(maxsize=32)
def _interp_matrix_2x(n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(2n, n) bilinear 2x interpolation matrix (half-pixel centres, clamped
    borders): output 2k blends (0.25, 0.75) of inputs (k-1, k), output 2k+1
    blends (0.75, 0.25) of inputs (k, k+1). Built and copied to ``device``
    once per (n, device, dtype), so a forward makes no host-to-device copy."""
    m = np.zeros((2 * n, n), dtype=np.float32)
    for k in range(n):
        m[2 * k, max(k - 1, 0)] += 0.25
        m[2 * k, k] += 0.75
        m[2 * k + 1, k] += 0.75
        m[2 * k + 1, min(k + 1, n - 1)] += 0.25
    # a normal tensor even when first built under inference_mode, so a later
    # forward that records autograd can use it
    with torch.inference_mode(False):
        return torch.as_tensor(m, device=device, dtype=dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample of (N, C, h, w) as two interpolation-matrix
    products, as the JAX package computes it (F.interpolate's bilinear kernel
    measured 8 ms per call on the H100 at the B16 serving shapes)."""
    h, w = x.shape[-2:]
    mh = _interp_matrix_2x(h, x.device, x.dtype)
    mw = _interp_matrix_2x(w, x.device, x.dtype)
    return torch.matmul(torch.matmul(mh, x), mw.t())


def maxpool2x(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)


class ResNetFeatNeck(nn.Module):
    """Upsample-and-concat over the pyramid from res_layer4 down, a max-pool and
    a 1x1 projection to feat_size[2] (``feat_size`` is res_layer4's channels first)."""

    def __init__(self, feat_size: Tuple[int, int, int, int], norm: str = "gn"):
        super().__init__()
        cin = feat_size[0]
        for i in range(3):
            self.add_module(f"ConvBlock_{i}",
                            ConvBlock(cin + feat_size[i + 1], feat_size[i + 1], 3, norm=norm))
            cin = feat_size[i + 1]
        self.feat_in = ConvBlock(cin, feat_size[2], 1, norm="none", relu=False)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        rev = list(reversed(feats))
        x = rev[0]
        for i in range(3):
            x = getattr(self, f"ConvBlock_{i}")(torch.cat([upsample2x(x), rev[i + 1]], dim=1))
        return self.feat_in(maxpool2x(x))


class HRNetFeatNeck(nn.Module):
    """Strided-conv descent over the pyramid, a 2x upsample, a 1x1 projection to feat_size[2]."""

    def __init__(self, feat_size: Tuple[int, int, int, int], norm: str = "gn"):
        super().__init__()
        for i in range(3):
            self.add_module(f"ConvBlock_{i}",
                            ConvBlock(feat_size[i], feat_size[i + 1], 3, 2, norm=norm))
        self.feat_in = ConvBlock(feat_size[3], feat_size[2], 1, norm="none", relu=False)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = feats[0]
        for i in range(3):
            x = getattr(self, f"ConvBlock_{i}")(x) + feats[i + 1]
        return self.feat_in(upsample2x(x))


class UVDecodeNeck(nn.Module):
    """Heatmap branch: upsample-and-concat decoder, max-pool, 1x1 -> 21 sigmoid maps.

    ``feat_size`` lists HRNet's branches from the finest (``hrnet=True``) and
    ResNet's from res_layer4; either way the decoder starts at the coarsest."""

    def __init__(self, feat_size: Tuple[int, int, int, int], num_joints: int = 21,
                 hrnet: bool = True, norm: str = "gn"):
        super().__init__()
        fs = feat_size
        rev_ch = list(reversed(fs)) if hrnet else list(fs)  # coarsest first
        cin = rev_ch[0]
        for i in range(3):
            self.add_module(f"ConvBlock_{i}",
                            ConvBlock(cin + rev_ch[i + 1], rev_ch[i + 1], 3, norm=norm))
            cin = rev_ch[i + 1]
        self.uv_out = ConvBlock(cin, num_joints, 1, norm="none", relu=False)
        self.uv_in = ConvBlock(num_joints, fs[1] if hrnet else fs[2], 1, norm=norm)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Pyramid -> (N, 21, 32, 32) sigmoid heatmaps."""
        rev = list(reversed(feats))
        x = rev[0]
        for i in range(3):
            x = torch.cat([upsample2x(x), rev[i + 1]], dim=1)
            x = getattr(self, f"ConvBlock_{i}")(x)
        return torch.sigmoid(self.uv_out(maxpool2x(x)))

    def uv_feat(self, hmap: torch.Tensor) -> torch.Tensor:
        """The heatmap feature branch; POEM's forward does not consume it."""
        return self.uv_in(hmap)
