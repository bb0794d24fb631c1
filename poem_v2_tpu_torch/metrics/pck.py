"""PCK curves and AUC (counterpart of ``poem_v2_tpu/metrics/pck.py``).

Per-keypoint Euclidean distances, then the PCK curve over ``steps``
thresholds in [val_min, val_max] integrated by the trapezoid rule (0 to
0.02 m in 20 steps by default).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .meters import Metric


class _PCKMetric(Metric):
    def __init__(self, num_kp: int, val_min: float = 0.0, val_max: float = 0.02, steps: int = 20):
        self.num_kp = num_kp
        self.val_min = val_min
        self.val_max = val_max
        self.steps = steps
        self._dists: List[np.ndarray] = []

    def reset(self):
        self._dists = []

    def feed(self, pred, gt, **kw):
        pred = np.asarray(pred)
        gt = np.asarray(gt)
        d = np.linalg.norm(pred - gt, axis=2)  # (B, K)
        self._dists.append(d)

    def _all(self) -> np.ndarray:
        if not self._dists:
            return np.zeros((0, self.num_kp))
        return np.concatenate(self._dists, axis=0)

    def pck_curve(self):
        dists = self._all()
        thresholds = np.linspace(self.val_min, self.val_max, self.steps)
        if dists.shape[0] == 0:
            return thresholds, np.zeros_like(thresholds)
        pck = (dists[None, :, :] <= thresholds[:, None, None]).mean(axis=(1, 2))
        return thresholds, pck

    def get_auc(self) -> float:
        thr, pck = self.pck_curve()
        if thr[-1] == thr[0]:
            return 0.0
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has trapz only
        return float(trapezoid(pck, thr) / (thr[-1] - thr[0]))

    def get_measures(self) -> Dict[str, float]:
        return {f"auc_{self.num_kp}": self.get_auc()}

    def __str__(self):
        return f"auc({self.num_kp}kp): {self.get_auc():6.4f}"


class Joint3DPCK(_PCKMetric):
    def __init__(self, **kw):
        super().__init__(num_kp=21, **kw)


class Vert3DPCK(_PCKMetric):
    def __init__(self, **kw):
        super().__init__(num_kp=778, **kw)
