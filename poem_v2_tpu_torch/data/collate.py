"""Padded static-shape collation (counterpart of ``poem_v2_tpu/data/collate.py``).

Samples are padded to ``view_max`` views and a boolean (B, V) ``view_mask``
carries how many each has, so one batch shape serves every view-count mix.
Numpy throughout; array for array the JAX package's batches.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# per-view arrays to pad & stack; everything the model and losses consume
VIEW_KEYS = (
    "image",
    "target_cam_intr",
    "target_cam_extr",
    "target_joints_2d",
    "target_joints_3d",
    "target_verts_3d",
)
SAMPLE_KEYS = ("master_joints_3d", "master_verts_3d")


def pad_views(arr: np.ndarray, view_max: int) -> np.ndarray:
    """(n, ...) -> (view_max, ...), zero-padded."""
    n = arr.shape[0]
    if n >= view_max:
        return arr[:view_max]
    pad = np.zeros((view_max - n,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def collate_padded(samples: Sequence[Dict], view_max: int) -> Dict[str, np.ndarray]:
    """Collate processed samples into one padded batch.

    Batch layout: image (B, V, H, W, 3) float32 NHWC; cam_intr/extr
    (B, V, 3, 3)/(B, V, 4, 4); view_mask (B, V) bool; master joints /
    verts (B, 21/778, 3); mano pose/shape of the master view.
    Padded extrinsics are identity (keeps DLT/projection matrices
    well-formed; their rows are masked out everywhere they matter).
    """
    B = len(samples)
    batch: Dict[str, np.ndarray] = {}
    n_views = np.asarray([s["image"].shape[0] for s in samples])
    view_mask = np.arange(view_max)[None, :] < n_views[:, None]
    batch["view_mask"] = view_mask

    out_key = {
        "image": "image",
        "target_cam_intr": "cam_intr",
        "target_cam_extr": "cam_extr",
        "target_joints_2d": "target_joints_2d",
        "target_joints_3d": "target_joints_3d",
        "target_verts_3d": "target_verts_3d",
    }
    for k in VIEW_KEYS:
        if k not in samples[0]:
            continue
        stacked = np.stack([pad_views(np.asarray(s[k]), view_max) for s in samples])
        batch[out_key[k]] = stacked.astype(np.float32)

    # identity extrinsics on padding (avoid singular matrices)
    if "cam_extr" in batch:
        eye = np.eye(4, dtype=np.float32)
        inv = ~view_mask
        batch["cam_extr"][inv] = eye
    if "cam_intr" in batch:
        eye3 = np.eye(3, dtype=np.float32)
        batch["cam_intr"][~view_mask] = eye3

    for k in SAMPLE_KEYS:
        if k in samples[0]:
            batch[k] = np.stack([np.asarray(s[k]) for s in samples]).astype(np.float32)

    if "mano_pose" in samples[0]:
        batch["mano_pose"] = np.stack(
            [np.asarray(s["mano_pose"][0]) for s in samples]
        ).astype(np.float32)
    if "mano_shape" in samples[0]:
        batch["mano_shape"] = np.stack(
            [np.asarray(s["mano_shape"][0]) for s in samples]
        ).astype(np.float32)
    return batch


def batch_iterator(dataset, batch_size: int, view_max: int, epoch_size: int = 0):
    """Group a sample stream into padded batches (with_epoch equivalent)."""
    it = iter(dataset)
    count = 0
    buf: List[Dict] = []
    for sample in it:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate_padded(buf, view_max)
            buf = []
            count += batch_size
            if epoch_size and count >= epoch_size:
                return
