"""Framework-wide constants and small helpers (counterpart of
``poem_v2_tpu/utils/misc.py``; reference lib/utils/misc.py:65-100): the
immutable ``CONST`` class, a parameter count and a singleton decorator."""

from __future__ import annotations

import math

import torch


class _ImmutableMeta(type):
    def __call__(cls, *a, **k):
        raise AttributeError("Cannot instantiate this class")

    def __setattr__(cls, name, value):
        raise AttributeError("Cannot modify immutable class")


class CONST(metaclass=_ImmutableMeta):
    PI = math.pi
    NUM_JOINTS = 21
    NUM_VERTS = 778
    NUM_QUERY = 799  # 21 joints + 778 vertices
    SIDE = "right"
    UVD_DEPTH_RANGE = 0.4  # metres: the depth span of the UVD transform's unit range
    JOINTS_IDX_PARENTS = [0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19]
    REF_BONE_LEN = 0.09473151311686484  # metres

    # fingertip vertex ids on the MANO mesh, keyed by OpenPose keypoint id
    MANO_KPID_2_VERTICES = {4: [744], 8: [320], 12: [443], 16: [555], 20: [672]}

    # MANO (16 regressed joints + 5 tips) -> OpenPose 21-joint order
    MANO_TO_OPENPOSE = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]
    OPENPOSE_TO_MANO = [0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3, 4, 8, 12, 16, 20]


def param_size(module: torch.nn.Module) -> float:
    """The module's parameter count in millions, rounded to 3 decimals."""
    return round(sum(p.numel() for p in module.parameters()) / 1e6, 3)


def singleton(cls):
    instances = {}

    def inner(*args, **kwargs):
        if cls not in instances:
            instances[cls] = cls(*args, **kwargs)
        return instances[cls]

    return inner
