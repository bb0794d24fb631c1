"""ResNet-18 / 34 / 50 backbones, their norms and residual blocks (HRNet shares
the blocks); counterpart of ``poem_v2_tpu/models/backbones/resnet.py``.

Modules here work on NCHW tensors. Submodule names follow the flax names
(``stem_conv``, ``layer1_block0``; inside a block the auto-names ``Conv_0``,
norms ``norm_0``) so that :mod:`poem_v2_tpu_torch.convert` maps parameters
mechanically.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) * weight / sqrt(var + eps) + bias, nothing learnt from batches.

    The statistics are parameters, as the flax module keeps them in ``params``:
    the JAX optimiser masks nothing, so they take gradients and Adam updates
    like the scale and bias, and the port trains them the same way."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

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
        return RunningBatchNorm(features)
    raise ValueError(f"unknown norm {norm!r}")


class RunningBatchNorm(nn.BatchNorm2d):
    """BatchNorm that always normalises with its running statistics and never
    updates them, in ``train()`` too: the flax module is built with
    ``use_running_average=True``. The statistics stay buffers (flax's
    ``batch_stats``, which its optimiser never sees)."""

    def __init__(self, features: int):
        # flax momentum 0.99 is torch momentum 0.01; it is never applied
        super().__init__(features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


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


_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


class ResNet(nn.Module):
    """Four-stage pyramid and a pooled global vector.

    Input (N, 3, H, W) -> dict with ``res_layer1..4`` (strides 4 / 8 / 16 / 32,
    NCHW) and ``res_layer4_mean`` (N, C4)."""

    def __init__(self, arch: str = "resnet34", norm: str = "gn"):
        super().__init__()
        if arch not in _SPECS:
            raise ValueError(f"unknown ResNet {arch!r}; one of {sorted(_SPECS)}")
        self.arch = arch
        block_cls, layers = _SPECS[arch]
        expansion = 4 if block_cls is Bottleneck else 1
        self.stem_conv = conv(3, 64, 7, 2)
        self.stem_norm = make_norm(norm, 64)
        self.blocks = []
        cin = 64
        for i, (width, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            names = []
            for b in range(n_blocks):
                name = f"layer{i + 1}_block{b}"
                self.add_module(name, block_cls(cin, width, 2 if (b == 0 and i > 0) else 1,
                                                norm=norm))
                cin = width * expansion
                names.append(name)
            self.blocks.append(names)

    @classmethod
    def from_config(cls, cfg: dict) -> "ResNet":
        """``TYPE`` resnet18 / 34 / 50 (anything else resnet34); ``FREEZE_BATCHNORM``
        selects ``frozen_bn`` over ``NORM`` (default ``gn``)."""
        arch = cfg["TYPE"].lower() if cfg["TYPE"].lower().startswith("resnet") else "resnet34"
        norm = "frozen_bn" if cfg.get("FREEZE_BATCHNORM", False) else cfg.get("NORM", "gn")
        return cls(arch=arch, norm=norm)

    @property
    def feat_size(self) -> Tuple[int, int, int, int]:
        """Channels of res_layer4 .. res_layer1."""
        if self.arch == "resnet50":
            return (2048, 1024, 512, 256)
        return (512, 256, 128, 64)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.stem_norm(self.stem_conv(image)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for i, names in enumerate(self.blocks):
            for name in names:
                x = getattr(self, name)(x)
            feats[f"res_layer{i + 1}"] = x
        feats["res_layer4_mean"] = x.mean(dim=(2, 3))
        return feats
