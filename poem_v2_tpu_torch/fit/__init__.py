"""Optimisation-based MANO fitting to multi-view keypoints and silhouettes
(counterpart of ``poem_v2_tpu/fit``)."""

from .frame_fit import FitParams, FitResult, OneFrameFit, anatomical_loss
from .frame_fit_silh import OneFrameFitSilh
from .soft_raster import multiview_silhouette_loss, soft_silhouette
