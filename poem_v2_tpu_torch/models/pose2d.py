"""Single-view 2D / UVD pose models, the auxiliary family (counterpart of
``poem_v2_tpu/models/pose2d.py``).

A backbone and a deconvolution head give per-joint heatmaps, decoded by the
integral soft-argmax (``IntegralPose``; ``softmax`` or ``sigmoid`` maps, 2D or
UVD volumes) or, for ``DarkPose``, by the DARK sub-pixel refinement on the host
(:func:`dark_decode`). Images come in channels-last (B, H, W, 3) and heatmaps
go out (B, J[, D], H, W) float32, as in the JAX package. The deconvolutions are
``ConvTranspose2d(k 4, stride 2, padding 1)``: flax's ``ConvTranspose(padding
"SAME")`` with its kernel flipped in space (``convert.py`` flips it).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..geometry.heatmap import integral_heatmap2d, integral_heatmap3d, normalize_heatmap
from ..utils.registry import HEAD, MODEL
from .backbones.resnet import ResNet, make_norm


def _deconv_stack(module: nn.Module, cin: int, num_deconv: int, features: int,
                  norm: str) -> None:
    for i in range(num_deconv):
        module.add_module(f"deconv{i}", nn.ConvTranspose2d(
            cin if i == 0 else features, features, 4, stride=2, padding=1, bias=False))
        module.add_module(f"deconv{i}_norm", make_norm(norm, features))


def _run_deconvs(module: nn.Module, x: torch.Tensor, num_deconv: int) -> torch.Tensor:
    for i in range(num_deconv):
        x = torch.relu(getattr(module, f"deconv{i}_norm")(getattr(module, f"deconv{i}")(x)))
    return x


def _softmax_maps(hm: torch.Tensor) -> torch.Tensor:
    """Softmax over each joint's whole map or volume, hm (B, J, ...)."""
    B, J = hm.shape[:2]
    return torch.softmax(hm.reshape(B, J, -1), dim=-1).reshape(hm.shape)


@HEAD.register_module("IntegralDeconvHead")
class IntegralDeconvHead(nn.Module):
    """Deconv stages and a 1x1 conv to ``num_joints`` [x ``depth_resolution``]
    heatmaps, normalized and integrated: channels-last features (B, h, w, C) ->
    {"uv" (B, J, 2), "heatmap" (B, J, H, W)} or, with a depth resolution D > 0,
    {"uvd" (B, J, 3), "heatmap" (B, J, D, H, W)}."""

    def __init__(self, in_channels: int, num_joints: int = 21, depth_resolution: int = 0,
                 num_deconv: int = 3, deconv_features: int = 256, norm_type: str = "softmax",
                 norm: str = "gn"):
        super().__init__()
        self.num_joints, self.depth_resolution = num_joints, depth_resolution
        self.num_deconv, self.norm_type = num_deconv, norm_type
        _deconv_stack(self, in_channels, num_deconv, deconv_features, norm)
        cin = deconv_features if num_deconv else in_channels
        self.final = nn.Conv2d(cin, num_joints * max(1, depth_resolution), 1)

    def forward(self, feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = _run_deconvs(self, feat.permute(0, 3, 1, 2), self.num_deconv)
        hm = self.final(x).float()
        B, _, H, W = hm.shape
        if self.depth_resolution:
            hm = hm.reshape(B, self.num_joints, self.depth_resolution, H, W)
        hm = (_softmax_maps(hm) if self.norm_type == "softmax"
              else normalize_heatmap(torch.sigmoid(hm)))
        if self.depth_resolution:
            return {"uvd": integral_heatmap3d(hm), "heatmap": hm}
        return {"uv": integral_heatmap2d(hm), "heatmap": hm}


class IntegralPose(nn.Module):
    """backbone -> IntegralDeconvHead on its coarsest level; images (B, H, W, 3)."""

    def __init__(self, backbone: nn.Module, head: IntegralDeconvHead):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(image.to(self.head.final.weight.dtype).permute(0, 3, 1, 2))
        top = feats["res_layer4"] if isinstance(feats, dict) else feats[-1]
        return self.head(top.permute(0, 2, 3, 1))


class DarkPose(nn.Module):
    """Deconv heatmap regression (MSE supervision); the DARK decode runs on the
    host (:func:`dark_decode`). Images (B, H, W, 3) -> {"heatmap" (B, J, H', W')}."""

    def __init__(self, backbone: ResNet, num_joints: int = 21, num_deconv: int = 3,
                 deconv_features: int = 256, norm: str = "gn"):
        super().__init__()
        self.backbone = backbone
        self.num_deconv = num_deconv
        _deconv_stack(self, backbone.feat_size[0], num_deconv, deconv_features, norm)
        self.final = nn.Conv2d(deconv_features if num_deconv else backbone.feat_size[0],
                               num_joints, 1)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(image.to(self.final.weight.dtype).permute(0, 3, 1, 2))
        x = feats["res_layer4"] if isinstance(feats, dict) else feats[-1]
        return {"heatmap": self.final(_run_deconvs(self, x, self.num_deconv)).float()}


def joints_mse_loss(pred_hm: torch.Tensor, gt_hm: torch.Tensor,
                    joints_vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Half the mean squared heatmap error, each joint's maps weighted by
    ``joints_vis`` (B, J) where given."""
    err = (pred_hm - gt_hm) ** 2
    if joints_vis is not None:
        err = err * joints_vis[..., None, None]
    return 0.5 * err.mean()


def gaussian_blur_reflect101(m: np.ndarray, kernel: int = 11) -> np.ndarray:
    """OpenCV's ``GaussianBlur(m, (kernel, kernel), 0)`` of a float64 map: sigma
    0.3 ((kernel - 1) / 2 - 1) + 0.8, the 1D kernel exp(-x^2 / (2 sigma^2)) over
    its sum, ``BORDER_REFLECT_101`` edges, rows filtered first, then columns,
    each sum accumulated tap by tap from the first."""
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    x = np.arange(kernel, dtype=np.float64) - (kernel - 1) * 0.5
    g = np.exp(x * x * (-0.5 / (sigma * sigma)))
    g = g * (1.0 / g.sum())
    r = kernel // 2
    H, W = m.shape
    p = np.pad(np.asarray(m, np.float64), ((0, 0), (r, r)), mode="reflect")
    rows = g[0] * p[:, 0:W]
    for k in range(1, kernel):
        rows = rows + g[k] * p[:, k:k + W]
    p = np.pad(rows, ((r, r), (0, 0)), mode="reflect")
    out = g[0] * p[0:H]
    for k in range(1, kernel):
        out = out + g[k] * p[k:k + H]
    return out


def dark_decode(heatmap, kernel: int = 11) -> np.ndarray:
    """DARK sub-pixel decode on the host (numpy, float64): heatmaps (B, J, H, W)
    -> (B, J, 2) (x, y) in heatmap pixels. Each map is blurred
    (:func:`gaussian_blur_reflect101`, what the JAX function's OpenCV call
    computes), floored at 1e-10 and logged; away from the border the argmax moves
    by -H^-1 g of the log map's Taylor expansion, clipped to one pixel (Zhang et
    al., CVPR 2020)."""
    if isinstance(heatmap, torch.Tensor):
        heatmap = heatmap.detach().cpu().numpy()
    hm = np.asarray(heatmap, dtype=np.float64)
    B, J, H, W = hm.shape
    coords = np.zeros((B, J, 2))
    for b in range(B):
        for j in range(J):
            m = np.maximum(gaussian_blur_reflect101(hm[b, j], kernel), 1e-10)
            logm = np.log(m)
            y, x = (int(i) for i in np.unravel_index(np.argmax(m), m.shape))
            coords[b, j] = (x, y)
            if 1 <= x < W - 2 and 1 <= y < H - 2:
                dx = 0.5 * (logm[y, x + 1] - logm[y, x - 1])
                dy = 0.5 * (logm[y + 1, x] - logm[y - 1, x])
                dxx = logm[y, x + 1] - 2 * logm[y, x] + logm[y, x - 1]
                dyy = logm[y + 1, x] - 2 * logm[y, x] + logm[y - 1, x]
                dxy = 0.25 * (logm[y + 1, x + 1] - logm[y + 1, x - 1] - logm[y - 1, x + 1]
                              + logm[y - 1, x - 1])
                hess = np.array([[dxx, dxy], [dxy, dyy]])
                if abs(np.linalg.det(hess)) > 1e-10:
                    offset = -np.linalg.inv(hess) @ np.array([dx, dy])
                    coords[b, j] += np.clip(offset, -1.0, 1.0)  # (x, y) order
    return coords


def _on_device(model: nn.Module, device, dtype: torch.dtype, generator) -> nn.Module:
    from .poem import init_parameters

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the pose model targets a CUDA device and none is available; "
                           'pass device="cpu" to build it there')
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.to(device=device, dtype=dtype).eval()


def create_integral_pose(cfg: dict, dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cuda",
                         generator: Optional[torch.Generator] = None) -> IntegralPose:
    """ResNet (``BACKBONE``) + IntegralDeconvHead (``HEAD``: ``NCLASSES`` 21,
    ``DEPTH_RESOLUTION`` 0, ``NUM_DECONV`` 3, ``DECONV_FEATURES`` 256, ``NORM_TYPE``
    softmax; the head's norm is GroupNorm whatever the backbone's), weights from
    ``generator`` (seed 0 if None), in eval mode on ``device`` (the card by
    default)."""
    bb = ResNet.from_config(cfg["BACKBONE"])
    h = cfg["HEAD"]
    head = IntegralDeconvHead(bb.feat_size[0], num_joints=h.get("NCLASSES", 21),
                              depth_resolution=h.get("DEPTH_RESOLUTION", 0),
                              num_deconv=h.get("NUM_DECONV", 3),
                              deconv_features=h.get("DECONV_FEATURES", 256),
                              norm_type=h.get("NORM_TYPE", "softmax"))
    return _on_device(IntegralPose(bb, head), device, dtype, generator)


def create_darkpose(cfg: dict, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda",
                    generator: Optional[torch.Generator] = None) -> DarkPose:
    """ResNet (``BACKBONE``) + 3 deconvs of 256 and ``NCLASSES`` (21) maps."""
    return _on_device(DarkPose(ResNet.from_config(cfg["BACKBONE"]),
                               num_joints=cfg.get("NCLASSES", 21)), device, dtype, generator)


MODEL.register_module("IntegralPose")(create_integral_pose)
MODEL.register_module("DarkPose_ResNet")(create_darkpose)
