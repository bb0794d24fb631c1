"""Mean end-point error (counterpart of ``poem_v2_tpu/metrics/epe.py``), numpy on the host."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .meters import AverageMeter, Metric


class MeanEPE(Metric):
    def __init__(self, name: str = ""):
        self.name = f"{name}_mepe"
        self.avg_meter = AverageMeter()

    def reset(self):
        self.avg_meter.reset()

    def feed(self, pred_kp, gt_kp, **kwargs) -> float:
        pred = np.asarray(pred_kp)
        gt = np.asarray(gt_kp)
        assert pred.ndim == 3, "expected (B, N, C)"
        dist = np.linalg.norm(pred - gt, axis=2)  # (B, N)
        per_sample = dist.mean(axis=1)  # (B,)
        self.avg_meter.update(per_sample.sum(), n=per_sample.shape[0])
        return float(per_sample.sum())

    def get_measures(self) -> Dict[str, float]:
        return {self.name: self.avg_meter.avg}

    def get_result(self) -> float:
        return self.avg_meter.avg

    def __str__(self):
        return f"{self.name}: {self.avg_meter.avg:6.4f}"
