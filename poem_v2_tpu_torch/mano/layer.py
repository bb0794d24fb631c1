"""MANO linear blend skinning in PyTorch (counterpart of ``poem_v2_tpu/mano/layer.py``).

Axis-angle pose, no PCA, flat hand mean; returns 778 vertices and 21
joints in OpenPose order (16 LBS joints plus 5 fingertip vertices).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry.rotations import aa_to_rotmat
from .model import ManoModel, default_mano

# fingertip vertex ids keyed by OpenPose keypoint id, and MANO (16 + 5 tips)
# -> OpenPose order (poem_v2_tpu/utils/misc.py CONST)
MANO_KPID_2_VERTICES = {4: [744], 8: [320], 12: [443], 16: [555], 20: [672]}
MANO_TO_OPENPOSE = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]


class ManoOutput(NamedTuple):
    verts: torch.Tensor       # (B, 778, 3)
    joints: torch.Tensor      # (B, 21, 3), OpenPose order
    transforms: torch.Tensor  # (B, 16, 4, 4) global joint transforms


class ManoLayer:
    """Stateless LBS callable over one MANO model's constants (float32). The
    constants are made on the CPU and copied once to each device a pose comes from."""

    def __init__(self, model: Optional[ManoModel] = None, center_idx: Optional[int] = None):
        m = model if model is not None else default_mano()
        self.model = m
        self.faces = m.faces
        self.center_idx = center_idx
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
        self.v_template = t(m.v_template)
        self.shapedirs = t(m.shapedirs)
        self.posedirs = t(m.posedirs.reshape(m.posedirs.shape[0], 3, -1))
        self.j_regressor = t(m.j_regressor)
        self.lbs_weights = t(m.lbs_weights)
        self.parents = np.asarray(m.parents)
        self._on_device = {}

    def _constants(self, device: torch.device):
        """(v_template, shapedirs, posedirs, j_regressor, lbs_weights) on ``device``."""
        if device not in self._on_device:
            # normal tensors even when first copied under inference_mode, so a later
            # forward that records autograd can use them
            with torch.inference_mode(False):
                self._on_device[device] = tuple(
                    t.to(device) for t in (self.v_template, self.shapedirs, self.posedirs,
                                           self.j_regressor, self.lbs_weights))
        return self._on_device[device]

    def __call__(self, pose_aa: torch.Tensor, betas: torch.Tensor) -> ManoOutput:
        """pose_aa (B, 48) axis-angle ([:, :3] global root), betas (B, 10)."""
        B = pose_aa.shape[0]
        pose = pose_aa.reshape(B, 16, 3)
        v_template, shapedirs, posedirs, j_regressor, lbs_weights = self._constants(
            pose_aa.device)
        v_shaped = v_template + torch.einsum("vcs,bs->bvc", shapedirs, betas)
        j_rest = torch.einsum("jv,bvc->bjc", j_regressor, v_shaped)
        rots = aa_to_rotmat(pose)
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        pose_feat = (rots[:, 1:] - eye).reshape(B, -1)
        v_posed = v_shaped + torch.einsum("vcp,bp->bvc", posedirs, pose_feat)
        transforms = self._global_transforms(rots, j_rest)
        j_rest_h = torch.cat([j_rest, torch.zeros_like(j_rest[..., :1])], -1)
        correction = torch.einsum("bjik,bjk->bji", transforms, j_rest_h)
        rel = transforms - torch.cat([torch.zeros_like(transforms[..., :3]),
                                      correction[..., None]], dim=-1)
        vert_t = torch.einsum("vj,bjik->bvik", lbs_weights, rel)
        v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
        verts = torch.einsum("bvik,bvk->bvi", vert_t, v_h)[..., :3]
        joints16 = transforms[..., :3, 3]
        tips = verts[:, [v[0] for _, v in sorted(MANO_KPID_2_VERTICES.items())]]
        joints21 = torch.cat([joints16, tips], dim=1)[:, MANO_TO_OPENPOSE]
        if self.center_idx is not None:
            centre = joints21[:, self.center_idx:self.center_idx + 1]
            verts = verts - centre
            joints21 = joints21 - centre
        return ManoOutput(verts=verts, joints=joints21, transforms=transforms)

    def _global_transforms(self, rots: torch.Tensor, j_rest: torch.Tensor) -> torch.Tensor:
        B = rots.shape[0]
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rots.dtype,
                              device=rots.device).expand(B, 1, 4)

        def make_tf(rot, t):
            return torch.cat([torch.cat([rot, t[..., None]], dim=-1), bottom], dim=-2)

        results = [make_tf(rots[:, 0], j_rest[:, 0])]
        for j in range(1, 16):
            p = int(self.parents[j])
            local = make_tf(rots[:, j], j_rest[:, j] - j_rest[:, p])
            results.append(torch.einsum("bik,bkj->bij", results[p], local))
        return torch.stack(results, dim=1)
