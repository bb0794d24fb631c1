"""Procrustes-aligned MPJPE / MPVPE (counterpart of ``poem_v2_tpu/metrics/pa.py``).

The alignment runs batched on the predictions' device
(:func:`poem_v2_tpu_torch.geometry.procrustes.align_w_scale`); the running
averages are host floats.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..geometry.procrustes import align_w_scale
from .meters import AverageMeter, Metric


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))


class PAEval(Metric):
    def __init__(self, mesh_score: bool = True):
        self.mesh_score = mesh_score
        self.pa_mpjpe = AverageMeter()
        self.mpjpe = AverageMeter()
        self.pa_mpvpe = AverageMeter()
        self.mpvpe = AverageMeter()

    def reset(self):
        for m in (self.pa_mpjpe, self.mpjpe, self.pa_mpvpe, self.mpvpe):
            m.reset()

    @staticmethod
    def _dist(a, b) -> np.ndarray:
        """Per sample, the mean over points of |a - b| (float32 on a's device), as numpy."""
        a, b = _tensor(a).float(), _tensor(b).float().to(_tensor(a).device)
        return torch.linalg.vector_norm(a - b, dim=2).mean(1).cpu().numpy()

    def feed(self, pred_joints, gt_joints, pred_verts=None, gt_verts=None, **kw):
        pred_joints, gt_joints = _tensor(pred_joints), _tensor(gt_joints)
        B = pred_joints.shape[0]
        aligned_j = align_w_scale(gt_joints, pred_joints)
        self.pa_mpjpe.update(self._dist(aligned_j, gt_joints).sum(), B)
        self.mpjpe.update(self._dist(pred_joints, gt_joints).sum(), B)
        if self.mesh_score and pred_verts is not None:
            pred_verts, gt_verts = _tensor(pred_verts), _tensor(gt_verts)
            aligned_v = align_w_scale(gt_verts, pred_verts)
            self.pa_mpvpe.update(self._dist(aligned_v, gt_verts).sum(), B)
            self.mpvpe.update(self._dist(pred_verts, gt_verts).sum(), B)

    def get_measures(self) -> Dict[str, float]:
        out = {"pa_mpjpe": self.pa_mpjpe.avg, "mpjpe": self.mpjpe.avg}
        if self.mesh_score:
            out.update(pa_mpvpe=self.pa_mpvpe.avg, mpvpe=self.mpvpe.avg)
        return out

    def get_result(self) -> float:
        return self.pa_mpjpe.avg

    def __str__(self):
        s = f"pa_mpjpe(mm): {self.pa_mpjpe.avg * 1000.0:6.4f} | mpjpe: {self.mpjpe.avg:6.4f}"
        if self.mesh_score:
            s += f" | pa_mpvpe(mm): {self.pa_mpvpe.avg * 1000.0:6.4f} | mpvpe: {self.mpvpe.avg:6.4f}"
        return s
