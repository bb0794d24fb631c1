"""MANO hand model constants and loaders (numpy only).

Counterpart of ``poem_v2_tpu/mano/model.py``, with the same arrays bit for
bit: :func:`load_mano_pkl` reads the official ``MANO_RIGHT.pkl`` (not
redistributable, an optional runtime input) and :func:`synthetic_mano`
builds a deterministic synthetic right hand with MANO's tensor shapes.
The pickle is read with :mod:`pickle`, so only load a file you trust.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np

NUM_VERTS = 778
NUM_MANO_JOINTS = 16
NUM_SHAPE = 10
NUM_POSE_BASIS = 135  # 9 * 15

# Kinematic tree: wrist(0); index 1-3, middle 4-6, pinky 7-9, ring 10-12,
# thumb 13-15 (MANO joint layout).
PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class ManoModel:
    """Static MANO parameters (all numpy; the layer makes tensors of them)."""

    v_template: np.ndarray  # (778, 3)
    shapedirs: np.ndarray  # (778, 3, 10)
    posedirs: np.ndarray  # (778, 3, 135)
    j_regressor: np.ndarray  # (16, 778)
    lbs_weights: np.ndarray  # (778, 16)
    hands_mean: np.ndarray  # (45,)
    faces: np.ndarray  # (F, 3) int32
    parents: np.ndarray = dataclasses.field(default_factory=lambda: PARENTS.copy())


def _undo_chumpy(x):
    return np.asarray(x.r if hasattr(x, "r") else x, dtype=np.float64)


def load_mano_pkl(path: str) -> ManoModel:
    """Load the official MANO pickle (``MANO_RIGHT.pkl``)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    j_reg = data["J_regressor"]
    if hasattr(j_reg, "todense"):
        j_reg = np.asarray(j_reg.todense())
    return ManoModel(
        v_template=_undo_chumpy(data["v_template"]).astype(np.float32),
        shapedirs=_undo_chumpy(data["shapedirs"]).astype(np.float32),
        posedirs=_undo_chumpy(data["posedirs"]).astype(np.float32),
        j_regressor=np.asarray(j_reg, dtype=np.float32),
        lbs_weights=_undo_chumpy(data["weights"]).astype(np.float32),
        hands_mean=_undo_chumpy(data["hands_mean"]).astype(np.float32),
        faces=np.asarray(data["f"], dtype=np.int32),
    )


def synthetic_mano(seed: int = 42) -> ManoModel:
    """Deterministic synthetic right hand with MANO tensor shapes.

    Vertices are scattered as tubes around the finger bones of a
    hand-shaped skeleton; skinning weights fall off smoothly with
    distance to each bone segment; the joint regressor selects vertices
    near each joint. Scale is metric (hand ~18 cm), so geometry-dependent
    constants (BPS radius 0.1 m, depth ranges) behave like the real asset.
    """
    rs = np.random.RandomState(seed)

    # --- skeleton (rest pose, right hand, palm facing -z, fingers +y) ---
    joints = np.zeros((NUM_MANO_JOINTS, 3), dtype=np.float64)
    # finger base x-offsets (index, middle, pinky, ring, thumb)
    finger_x = {1: 0.022, 4: 0.000, 7: -0.044, 10: -0.022, 13: 0.045}
    base_y = {1: 0.085, 4: 0.088, 7: 0.075, 10: 0.082, 13: 0.030}
    seg_len = {1: 0.030, 4: 0.032, 7: 0.024, 10: 0.029, 13: 0.031}
    for root in (1, 4, 7, 10, 13):
        x = finger_x[root]
        y0 = base_y[root]
        ln = seg_len[root]
        direction = np.array([0.35 if root == 13 else 0.0, 1.0, 0.0])
        direction = direction / np.linalg.norm(direction)
        for k in range(3):
            joints[root + k] = np.array([x, y0, 0.0]) + direction * ln * k

    # --- vertices: tubes around each bone + palm blob --------------------
    segments = []  # (start, end, joint_for_weights)
    for j in range(1, NUM_MANO_JOINTS):
        p = PARENTS[j]
        segments.append((joints[p], joints[j], j))
        # fingertip extension segment beyond the distal joint
        if j in (3, 6, 9, 12, 15):
            tip = joints[j] + (joints[j] - joints[PARENTS[j]]) * 0.9
            segments.append((joints[j], tip, j))

    verts = []
    n_per_seg = NUM_VERTS // (len(segments) + 6)
    for (a, b, _) in segments:
        t = rs.rand(n_per_seg, 1)
        centre = a + (b - a) * t
        verts.append(centre + rs.randn(n_per_seg, 3) * 0.006)
    # palm blob
    remaining = NUM_VERTS - n_per_seg * len(segments)
    palm = rs.randn(remaining, 3) * np.array([0.03, 0.03, 0.008]) + np.array([0.0, 0.04, 0.0])
    verts.append(palm)
    v_template = np.concatenate(verts, axis=0)[:NUM_VERTS]

    # --- skinning weights: softmin distance to bones ----------------------
    def point_seg_dist(p, a, b):
        ab = b - a
        t = np.clip(((p - a) @ ab) / (ab @ ab + 1e-12), 0.0, 1.0)
        proj = a + t[:, None] * ab
        return np.linalg.norm(p - proj, axis=1)

    dists = np.full((NUM_VERTS, NUM_MANO_JOINTS), 1e3)
    for (a, b, j) in segments:
        d = point_seg_dist(v_template, a, b)
        dists[:, j] = np.minimum(dists[:, j], d)
    # wrist/palm bone: segment from origin to middle finger base
    dists[:, 0] = point_seg_dist(v_template, joints[0], np.array([0.0, 0.06, 0.0]))
    w = np.exp(-((dists / 0.012) ** 2))
    w = w / (w.sum(axis=1, keepdims=True) + 1e-9)
    # sharpen: keep top-4 influences like real MANO
    order = np.argsort(-w, axis=1)
    keep = np.zeros_like(w)
    rows = np.arange(NUM_VERTS)[:, None]
    keep[rows, order[:, :4]] = w[rows, order[:, :4]]
    lbs_weights = keep / keep.sum(axis=1, keepdims=True)

    # --- joint regressor: inverse-distance over nearest vertices ---------
    j_reg = np.zeros((NUM_MANO_JOINTS, NUM_VERTS))
    for j in range(NUM_MANO_JOINTS):
        d = np.linalg.norm(v_template - joints[j], axis=1)
        idx = np.argsort(d)[:12]
        inv = 1.0 / (d[idx] + 1e-4)
        j_reg[j, idx] = inv / inv.sum()
    # exact rest-joint recovery: re-centre the regressor output
    rest_from_reg = j_reg @ v_template
    # shift template joints to what the regressor reproduces, keeping tree valid
    joints = rest_from_reg

    shapedirs = rs.randn(NUM_VERTS, 3, NUM_SHAPE) * 0.002
    posedirs = rs.randn(NUM_VERTS, 3, NUM_POSE_BASIS) * 0.0004
    hands_mean = rs.randn(45) * 0.1

    # faces: arbitrary but valid triangle indices (viz only)
    faces = rs.randint(0, NUM_VERTS, size=(1538, 3)).astype(np.int32)

    return ManoModel(
        v_template=v_template.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        j_regressor=j_reg.astype(np.float32),
        lbs_weights=lbs_weights.astype(np.float32),
        hands_mean=hands_mean.astype(np.float32),
        faces=faces,
    )


def default_mano(assets_root: Optional[str] = None) -> ManoModel:
    """Load MANO_RIGHT.pkl if available, else the synthetic hand.

    Search order: explicit ``assets_root``, ``$MANO_ASSETS_ROOT``,
    ``assets/mano_v1_2``.
    """
    candidates = []
    for root in (assets_root, os.environ.get("MANO_ASSETS_ROOT"), "assets/mano_v1_2"):
        if root:
            candidates += [
                os.path.join(root, "models", "MANO_RIGHT.pkl"),
                os.path.join(root, "MANO_RIGHT.pkl"),
            ]
    for path in candidates:
        if os.path.exists(path):
            return load_mano_pkl(path)
    return synthetic_mano()
