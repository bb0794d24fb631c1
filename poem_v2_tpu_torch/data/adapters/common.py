"""Shared helpers of the per-dataset adapters (counterpart of
``poem_v2_tpu/data/adapters/common.py``).

The reference relies on each dataset's vendor SDK (dex_ycb_toolkit,
oikit, manotorch) plus imageio/torch; these adapters read the published
on-disk layouts directly with numpy + stdlib so the framework has no
extra dependencies. Raw frames are read by ``data/codec.py:read_image`` on
the adapter's ``device`` (nvJPEG on a CUDA device); MANO-parameterised labels
are realised with the port's :class:`~poem_v2_tpu_torch.mano.layer.ManoLayer`
on the CPU in float32.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch

from ..codec import read_image

# OpenPose joint order used across the framework (reference
# lib/utils/transform.py; see utils/misc.py CONST.MANO_TO_OPENPOSE)
MANO_TO_OPENPOSE = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]


def imread_rgb(path: str, device: str = "cpu") -> np.ndarray:
    """Read an image as RGB uint8, decoded on ``device`` (reference uses imageio)."""
    return read_image(path, device)


def persp_project(points_3d: np.ndarray, intr: np.ndarray) -> np.ndarray:
    """(N, 3) camera-space points -> (N, 2) pixels."""
    uvw = points_3d @ np.asarray(intr, dtype=np.float64).T
    return (uvw[:, :2] / np.clip(uvw[:, 2:3], 1e-8, None)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _mano_layer():
    from ...mano.layer import ManoLayer

    return ManoLayer()


def _mano(pose48: np.ndarray, shape10: np.ndarray, flat_hand_mean: bool):
    """The MANO layer once on the CPU in float32; without ``flat_hand_mean`` the
    model's mean hand pose is added to the 15 finger joints' rotations, as the
    JAX layer's ``flat_hand_mean=False`` does."""
    layer = _mano_layer()
    pose = torch.as_tensor(np.asarray(pose48, np.float32).reshape(1, 16, 3)).clone()
    if not flat_hand_mean:
        pose[:, 1:] += torch.as_tensor(np.asarray(layer.model.hands_mean, np.float32)
                                       ).reshape(15, 3)
    with torch.no_grad():
        return layer(pose.reshape(1, 48),
                     torch.as_tensor(np.asarray(shape10, np.float32)).reshape(1, 10))


def mano_verts(pose48: np.ndarray, shape10: np.ndarray, flat_hand_mean: bool = False) -> np.ndarray:
    """(778, 3) float32 vertices in the MANO root frame (no global translation)."""
    return _mano(pose48, shape10, flat_hand_mean).verts[0].numpy()


def mano_joints(pose48: np.ndarray, shape10: np.ndarray, flat_hand_mean: bool = False) -> np.ndarray:
    """(21, 3) float32 joints in OpenPose order, in the MANO root frame."""
    return _mano(pose48, shape10, flat_hand_mean).joints[0].numpy()


def require_dir(path: str, what: str) -> str:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{what} not found at {path!r} — point DATA_ROOT at a directory "
            f"containing the published dataset layout"
        )
    return path


def bbox_center_scale(joints_2d: np.ndarray, expand: float = 2.0) -> Tuple[np.ndarray, np.float32]:
    centre = (joints_2d.max(0) + joints_2d.min(0)) / 2.0
    scale = (joints_2d.max(0) - joints_2d.min(0)).max() * expand
    return centre.astype(np.float32), np.float32(scale)
