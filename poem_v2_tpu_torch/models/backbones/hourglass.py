"""Hourglass backbone of the single-view auxiliary models (counterpart of
``poem_v2_tpu/models/backbones/hourglass.py``).

A recursive encoder-decoder of pre-activation residual blocks whose decoder
splits into two parallel branches (the reference feeds a 2D heatmap head and a
mask head from them). NCHW in and out, as the port's other backbones; the
submodules carry the flax names (``Conv_0``, ``norm_0``, ``ResidualBlock_0``,
``hg``, ``skip_a`` ...) so that :mod:`poem_v2_tpu_torch.convert` maps them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONE
from ..neck import upsample2x
from .resnet import make_norm


class ResidualBlock(nn.Module):
    """norm-relu-1x1 (features / 2), norm-relu-3x3, norm-relu-1x1 (features), plus the
    input (through a 1x1 where the width changes)."""

    def __init__(self, cin: int, features: int, norm: str = "gn"):
        super().__init__()
        mid = features // 2
        self.norm_0 = make_norm(norm, cin)
        self.Conv_0 = nn.Conv2d(cin, mid, 1, bias=False)
        self.norm_1 = make_norm(norm, mid)
        self.Conv_1 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.norm_2 = make_norm(norm, mid)
        self.Conv_2 = nn.Conv2d(mid, features, 1, bias=False)
        self.Conv_3 = nn.Conv2d(cin, features, 1, bias=False) if cin != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(torch.relu(self.norm_0(x)))
        y = self.Conv_1(torch.relu(self.norm_1(y)))
        y = self.Conv_2(torch.relu(self.norm_2(y)))
        return (self.Conv_3(x) if self.Conv_3 is not None else x) + y


class _HGDown(nn.Module):
    """One level of the recursion: two skip branches at this resolution, a 2x2
    max-pool, the inner level (or the bottom block), each branch's up block and a
    2x bilinear upsample (half-pixel centres, edges clamped: ``jax.image.resize``'s
    bilinear at 2x)."""

    def __init__(self, features: int, depth: int, norm: str = "gn"):
        super().__init__()
        f = features
        self.skip_a = ResidualBlock(f, f, norm)
        self.skip_b = ResidualBlock(f, f, norm)
        self.down = ResidualBlock(f, f, norm)
        if depth > 1:
            self.inner = _HGDown(f, depth - 1, norm)
        else:
            self.bottom = ResidualBlock(f, f, norm)
        self.up_a = ResidualBlock(f, f, norm)
        self.up_b = ResidualBlock(f, f, norm)
        self.depth = depth

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        up1a, up1b = self.skip_a(x), self.skip_b(x)
        low = self.down(F.max_pool2d(x, 2))
        if self.depth > 1:
            low_a, low_b = self.inner(low)
        else:
            low_a = low_b = self.bottom(low)
        return (up1a + upsample2x(self.up_a(low_a)), up1b + upsample2x(self.up_b(low_b)))


@BACKBONE.register_module("HourglassBisected")
class HourglassBisected(nn.Module):
    """(B, 3, H, W) -> two (B, features, H / 4, W / 4) branch outputs."""

    def __init__(self, features: int = 256, depth: int = 4, norm: str = "gn"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.norm_0 = make_norm(norm, 64)
        self.ResidualBlock_0 = ResidualBlock(64, 128, norm)
        self.ResidualBlock_1 = ResidualBlock(128, features, norm)
        self.hg = _HGDown(features, depth, norm)

    @classmethod
    def from_config(cls, cfg: dict) -> "HourglassBisected":
        return cls(features=cfg.get("FEATURES", 256), depth=cfg.get("DEPTH", 4),
                   norm=cfg.get("NORM", "gn"))

    def forward(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.norm_0(self.Conv_0(image)))
        x = self.ResidualBlock_1(F.max_pool2d(self.ResidualBlock_0(x), 2))
        return self.hg(x)
