"""HRNet backbone (counterpart of ``poem_v2_tpu/models/backbones/hrnet.py``), NCHW.

Stem (stride 4), four bottlenecks, then three multi-resolution stages of
(1, 4, 3) exchange modules over widths (w, 2w, 4w, 8w) with SUM fusion;
returns the four-scale pyramid.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from .resnet import BasicBlock, Bottleneck, conv, make_norm


def _upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Integer-factor nearest upsample (the reference fuse layers' nn.Upsample)."""
    sh, sw = h // x.shape[2], w // x.shape[3]
    if sh * x.shape[2] != h or sw * x.shape[3] != w:
        raise ValueError(f"non-integer upsample {tuple(x.shape[2:])} -> {(h, w)}")
    return x.repeat_interleave(sh, dim=2).repeat_interleave(sw, dim=3)


class FuseLayer(nn.Module):
    """Every branch receives the sum of every branch, resampled to its scale."""

    def __init__(self, channels: Tuple[int, ...], norm: str):
        super().__init__()
        self.n = n = len(channels)
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"up_{j}_to_{i}_conv", conv(channels[j], channels[i], 1))
                    self.add_module(f"up_{j}_to_{i}_norm", make_norm(norm, channels[i]))
                elif j < i:
                    cin = channels[j]
                    for k in range(i - j):
                        ch = channels[i] if k == i - j - 1 else channels[j]
                        self.add_module(f"down_{j}_to_{i}_conv{k}", conv(cin, ch, 3, 2))
                        self.add_module(f"down_{j}_to_{i}_norm{k}", make_norm(norm, ch))
                        cin = ch

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                y = xs[j]
                if j > i:
                    y = getattr(self, f"up_{j}_to_{i}_norm")(getattr(self, f"up_{j}_to_{i}_conv")(y))
                    y = _upsample_nearest(y, xs[i].shape[2], xs[i].shape[3])
                elif j < i:
                    for k in range(i - j):
                        y = getattr(self, f"down_{j}_to_{i}_conv{k}")(y)
                        y = getattr(self, f"down_{j}_to_{i}_norm{k}")(y)
                        if k != i - j - 1:
                            y = torch.relu(y)
                acc = y if acc is None else acc + y
            outs.append(torch.relu(acc))
        return outs


class HRModule(nn.Module):
    def __init__(self, channels: Tuple[int, ...], num_blocks: int, norm: str):
        super().__init__()
        self.channels = channels
        self.num_blocks = num_blocks
        for i, ch in enumerate(channels):
            for b in range(num_blocks):
                self.add_module(f"branch{i}_block{b}", BasicBlock(ch, ch, norm=norm))
        if len(channels) > 1:
            self.fuse = FuseLayer(channels, norm)

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        ys = []
        for i in range(len(self.channels)):
            y = xs[i]
            for b in range(self.num_blocks):
                y = getattr(self, f"branch{i}_block{b}")(y)
            ys.append(y)
        return self.fuse(ys) if len(self.channels) > 1 else ys


class HRNet(nn.Module):
    """HRNet-W{width} on (N, 3, H, W) images; returns the 4-branch pyramid."""

    def __init__(self, width: int = 40, norm: str = "gn",
                 stage_modules: Tuple[int, int, int] = (1, 4, 3), stage_blocks: int = 4):
        super().__init__()
        w = width
        self.stage4_channels = chans = (w, 2 * w, 4 * w, 8 * w)
        self.stage_modules = stage_modules
        self.stem1, self.stem1_norm = conv(3, 64, 3, 2), make_norm(norm, 64)
        self.stem2, self.stem2_norm = conv(64, 64, 3, 2), make_norm(norm, 64)
        for b in range(4):
            self.add_module(f"layer1_block{b}", Bottleneck(64 if b == 0 else 256, 64, norm=norm))
        self.t1_b0, self.t1_b0_norm = conv(256, chans[0], 3), make_norm(norm, chans[0])
        self.t1_b1, self.t1_b1_norm = conv(256, chans[1], 3, 2), make_norm(norm, chans[1])
        self.t2_b2, self.t2_b2_norm = conv(chans[1], chans[2], 3, 2), make_norm(norm, chans[2])
        self.t3_b3, self.t3_b3_norm = conv(chans[2], chans[3], 3, 2), make_norm(norm, chans[3])
        for s, n_br in ((2, 2), (3, 3), (4, 4)):
            for m in range(stage_modules[s - 2]):
                self.add_module(f"stage{s}_m{m}", HRModule(chans[:n_br], stage_blocks, norm))

    @classmethod
    def from_config(cls, cfg: dict) -> "HRNet":
        norm = "frozen_bn" if cfg.get("FREEZE_BATCHNORM", False) else cfg.get("NORM", "gn")
        return cls(width=cfg.get("WIDTH", 40), norm=norm)

    def _stage(self, s: int, xs):
        for m in range(self.stage_modules[s - 2]):
            xs = getattr(self, f"stage{s}_m{m}")(xs)
        return xs

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        x = torch.relu(self.stem1_norm(self.stem1(image)))
        x = torch.relu(self.stem2_norm(self.stem2(x)))
        for b in range(4):
            x = getattr(self, f"layer1_block{b}")(x)
        xs = [torch.relu(self.t1_b0_norm(self.t1_b0(x))), torch.relu(self.t1_b1_norm(self.t1_b1(x)))]
        xs = self._stage(2, xs)
        xs = self._stage(3, xs + [torch.relu(self.t2_b2_norm(self.t2_b2(xs[-1])))])
        return self._stage(4, xs + [torch.relu(self.t3_b3_norm(self.t3_b3(xs[-1])))])
