"""Norms and residual blocks that HRNet uses (from ``poem_v2_tpu/models/backbones/resnet.py``).

Modules here work on NCHW tensors. Submodule names follow the flax
auto-names (``Conv_0``; norms are ``norm_0``) so that
:mod:`poem_v2_tpu_torch.convert` maps parameters mechanically. The
``ResNet`` backbone itself is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) * weight / sqrt(var + eps) + bias with fixed statistics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight / torch.sqrt(self.running_var + self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x - self.running_mean.view(shape)) * w.view(shape) + self.bias.view(shape)


def make_norm(norm: str, features: int) -> nn.Module:
    """"gn": GroupNorm(32, or the largest of 8/4/2/1 dividing the width), eps 1e-6
    (flax's default); "frozen_bn"; "bn": BatchNorm with running statistics (eval)."""
    if norm == "gn":
        groups = 32 if features % 32 == 0 else next(g for g in (8, 4, 2, 1) if features % g == 0)
        return nn.GroupNorm(groups, features, eps=1e-6)
    if norm == "frozen_bn":
        return FrozenBatchNorm(features)
    if norm == "bn":
        # flax momentum 0.99 is torch momentum 0.01; eval uses running statistics only
        return nn.BatchNorm2d(features, eps=1e-5, momentum=0.01)
    raise ValueError(f"unknown norm {norm!r}")


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=bias)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int = 1, norm: str = "gn"):
        super().__init__()
        self.Conv_0 = conv(cin, features, 3, strides)
        self.norm_0 = make_norm(norm, features)
        self.Conv_1 = conv(features, features, 3)
        self.norm_1 = make_norm(norm, features)
        self.has_residual_conv = cin != features or strides != 1
        if self.has_residual_conv:
            self.Conv_2 = conv(cin, features, 1, strides)
            self.norm_2 = make_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm_0(self.Conv_0(x)))
        y = self.norm_1(self.Conv_1(y))
        residual = self.norm_2(self.Conv_2(x)) if self.has_residual_conv else x
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (4x width) residual block."""

    def __init__(self, cin: int, features: int, strides: int = 1, norm: str = "gn"):
        super().__init__()
        out = features * 4
        self.Conv_0 = conv(cin, features, 1)
        self.norm_0 = make_norm(norm, features)
        self.Conv_1 = conv(features, features, 3, strides)
        self.norm_1 = make_norm(norm, features)
        self.Conv_2 = conv(features, out, 1)
        self.norm_2 = make_norm(norm, out)
        self.has_residual_conv = cin != out or strides != 1
        if self.has_residual_conv:
            self.Conv_3 = conv(cin, out, 1, strides)
            self.norm_3 = make_norm(norm, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm_0(self.Conv_0(x)))
        y = torch.relu(self.norm_1(self.Conv_1(y)))
        y = self.norm_2(self.Conv_2(y))
        residual = self.norm_3(self.Conv_3(x)) if self.has_residual_conv else x
        return torch.relu(y + residual)
