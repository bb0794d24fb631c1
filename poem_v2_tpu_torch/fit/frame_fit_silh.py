"""Silhouette-augmented MANO fitting (counterpart of
``poem_v2_tpu/fit/frame_fit_silh.py``): :class:`OneFrameFit`'s objective plus a
multi-view soft-silhouette L1 term rendered by ``soft_raster.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..mano.layer import ManoLayer
from .frame_fit import FitParams, OneFrameFit
from .soft_raster import multiview_silhouette_loss


class OneFrameFitSilh(OneFrameFit):
    def __init__(self, mano_layer: Optional[ManoLayer] = None, lr: float = 1e-2,
                 steps: int = 300, w_reproj: float = 1.0, w_anat: float = 1e-3,
                 w_shape: float = 1e-3, w_joint3d: float = 0.0, w_silh: float = 1.0,
                 img_size: int = 256, sigma: float = 1.0, device: torch.device | str = "cuda"):
        super().__init__(mano_layer, lr, steps, w_reproj, w_anat, w_shape, w_joint3d, device)
        self.w["silh"] = w_silh
        self.img_size = img_size
        self.sigma = sigma
        self.faces = torch.as_tensor(np.asarray(self.mano.faces), dtype=torch.long,
                                     device=self.device)
        self._masks = None  # (B, V, S, S), set by fit()

    def loss(self, params: FitParams, target_2d, cam_intr, cam_extr, view_mask,
             target_joints_3d=None):
        total = super().loss(params, target_2d, cam_intr, cam_extr, view_mask, target_joints_3d)
        if self._masks is not None and self.w["silh"]:
            _, verts, _ = self._forward(params)
            total = total + self.w["silh"] * multiview_silhouette_loss(
                cam_intr, cam_extr, verts, self._masks, self.faces, view_mask=view_mask,
                img_size=self.img_size, sigma=self.sigma)
        return total

    def fit(self, target_2d, cam_intr, cam_extr, view_mask=None, target_joints_3d=None,
            init=None, masks=None):
        """``masks``: (B, V, S, S) target silhouettes in [0, 1]."""
        self._masks = None if masks is None else torch.as_tensor(
            masks, device=self.device).float()
        try:
            return super().fit(target_2d, cam_intr, cam_extr, view_mask, target_joints_3d, init)
        finally:
            self._masks = None
