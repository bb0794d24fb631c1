"""Metric base classes and running averages (counterpart of ``poem_v2_tpu/metrics/meters.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += float(val)
        self.count += int(n)

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Metric(ABC):
    @abstractmethod
    def reset(self):
        ...

    @abstractmethod
    def feed(self, *args, **kwargs):
        ...

    @abstractmethod
    def get_measures(self) -> Dict[str, float]:
        ...


class LossMetric(Metric):
    """Running averages of every loss term (reference basic_metric.py:60-97)."""

    def __init__(self, cfg=None):
        self._meters: Dict[str, AverageMeter] = {}

    def reset(self):
        for m in self._meters.values():
            m.reset()

    def feed(self, loss_dict: Dict, batch_size: int):
        for k, v in loss_dict.items():
            if k not in self._meters:
                self._meters[k] = AverageMeter()
            self._meters[k].update(float(v) * batch_size, batch_size)

    def get_loss(self, name: str) -> float:
        return self._meters[name].avg if name in self._meters else 0.0

    def get_measures(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self._meters.items()}

    def __str__(self):
        return " | ".join(f"{k}: {m.avg:.4f}" for k, m in self._meters.items())
