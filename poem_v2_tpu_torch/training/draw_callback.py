"""Drawing eval callback: predictions over every view (counterpart of
``poem_v2_tpu/training/draw_callback.py``; reference ``DrawingHandCallback``,
lib/utils/testing.py:101-193).

The predicted and ground-truth joints and vertices are projected into each
valid view with the batched camera functions, on the batch's device, and
drawn on the host by the viztools: one tiled grid of views per sample and,
with ``composites``, per valid view a predicted and a ground-truth
``save_a_image_with_mesh_joints`` composite ([raw | 2D skeleton | shaded mesh
overlay]). Every file is a PNG written by the raster core (the JAX package
writes the composites as JPEG through OpenCV).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..geometry.camera import cam_extr_transf, cam_intr_projection, invert_rigid
from ..viztools import raster
from ..viztools.draw import (denormalize_image, draw_joints_2d, draw_verts_2d,
                             save_a_image_with_mesh_joints, tile_views)
from ..viztools.renderer import render_mesh_overlay
from .evaluator import IdleCallback


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class DrawingHandCallback(IdleCallback):
    def __init__(self, exp_dir: str, max_samples: int = 64, render_mesh: bool = False,
                 faces=None, composites: bool = True):
        """``render_mesh=True`` also rasterises the predicted mesh over each view of
        the tiled grid (the reference's OpenDR overlay path). ``composites=True``
        writes the reference's per-view artifacts (testing.py:171-193).
        ``faces``: (F, 3) mesh faces; the MANO model's by default."""
        self.exp_dir = os.path.join(exp_dir, "draws")
        os.makedirs(self.exp_dir, exist_ok=True)
        self.max_samples = max_samples
        self.render_mesh = render_mesh
        self.composites = composites
        self._faces = faces
        self._drawn = 0

    @property
    def faces(self) -> np.ndarray:
        if self._faces is None:
            from ..mano.model import default_mano

            self._faces = np.asarray(default_mano().faces)
        return self._faces

    def __call__(self, preds: Dict, batch: Dict, step_idx: int, **kwargs):
        if self._drawn >= self.max_samples:
            return
        extr = torch.as_tensor(batch["cam_extr"]).float()
        dev = extr.device
        intr = torch.as_tensor(batch["cam_intr"]).float().to(dev)
        m2c = invert_rigid(extr)

        def project(points):
            pts = torch.as_tensor(np.asarray(points), dtype=torch.float32, device=dev)
            return _host(cam_intr_projection(intr, cam_extr_transf(m2c, pts[:, None])))

        pred_j, pred_v = np.asarray(preds["pred_joints_3d"]), np.asarray(preds["pred_verts_3d"])
        gt_j = _host(batch["master_joints_3d"])
        pj2d, pv2d, gj2d = project(pred_j), project(pred_v), project(gt_j)
        gt_v = _host(batch["master_verts_3d"]) if "master_verts_3d" in batch else None
        images, vm = _host(batch["image"]), _host(batch["view_mask"]).astype(bool)
        extr_h, intr_h = _host(extr), _host(intr)

        B, V = vm.shape
        for b in range(B):
            if self._drawn >= self.max_samples:
                break
            panels = []
            for v in range(V):
                if not vm[b, v]:
                    continue
                img = denormalize_image(images[b, v])
                inv = np.linalg.inv(extr_h[b, v].astype(np.float64))
                if self.composites:
                    self._write_composites(img, inv, intr_h[b, v], b, v, step_idx, pred_j[b],
                                           pred_v[b], gt_j[b], pj2d[b, v], gj2d[b, v],
                                           gt_v[b] if gt_v is not None else None)
                if self.render_mesh:
                    v_cam = pred_v[b] @ inv[:3, :3].T + inv[:3, 3]
                    img = render_mesh_overlay(img, v_cam, self.faces, intr_h[b, v])
                img = draw_verts_2d(img, pv2d[b, v])
                img = draw_joints_2d(img, pj2d[b, v])
                img = draw_joints_2d(img, gj2d[b, v], color_override=(64, 64, 255), radius=1)
                panels.append(img)
            grid = tile_views(np.stack(panels), cols=min(4, len(panels)))
            raster.write_png(os.path.join(self.exp_dir, f"step{step_idx:05d}_s{b}.png"), grid)
            self._drawn += 1

    def _write_composites(self, img, inv, intr, b, v, step_idx, pred_j, pred_v, gt_j, pj2d,
                          gj2d, gt_verts):
        """Per-view predicted and ground-truth composites (reference testing.py:171-193)."""
        R, t = inv[:3, :3], inv[:3, 3]
        save_a_image_with_mesh_joints(
            img, intr, pred_v @ R.T + t, self.faces, pj2d, pred_j @ R.T + t,
            os.path.join(self.exp_dir, f"step{step_idx}_frame{b}_view{v}.png"))
        if gt_verts is not None:
            save_a_image_with_mesh_joints(
                img, intr, gt_verts @ R.T + t, self.faces, gj2d, gt_j @ R.T + t,
                os.path.join(self.exp_dir, f"step{step_idx}_frame{b}_view{v}_GT.png"))

    def on_finished(self):
        pass
