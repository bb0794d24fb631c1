"""Metrics: running averages, mean end-point error, PCK / AUC and Procrustes-aligned errors."""

from .meters import AverageMeter, LossMetric, Metric
from .epe import MeanEPE
from .pa import PAEval
from .pck import Joint3DPCK, Vert3DPCK
