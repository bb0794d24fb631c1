"""The hand model the benchmark's traffic and reference use: a frozen copy of
the port's synthetic MANO constants (``poem_v2_tpu_torch/mano/model.py:synthetic_mano``,
numpy, bit for bit) and a plain linear-blend-skinning forward written anew
(Rodrigues' formula, float32). The repository ships no ``MANO_RIGHT.pkl``, and
without it the port builds the same synthetic hand.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_VERTS = 778
NUM_MANO_JOINTS = 16
PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], dtype=np.int32)
# OpenPose keypoint id -> fingertip vertex, and MANO (16 joints + 5 tips) -> OpenPose order
TIP_VERTS = (744, 320, 443, 555, 672)
MANO_TO_OPENPOSE = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]


def synthetic_mano(seed: int = 42) -> dict:
    """v_template (778, 3), shapedirs (778, 3, 10), posedirs (778, 3, 135),
    j_regressor (16, 778), lbs_weights (778, 16), float32 numpy."""
    rs = np.random.RandomState(seed)
    joints = np.zeros((NUM_MANO_JOINTS, 3), dtype=np.float64)
    finger_x = {1: 0.022, 4: 0.000, 7: -0.044, 10: -0.022, 13: 0.045}
    base_y = {1: 0.085, 4: 0.088, 7: 0.075, 10: 0.082, 13: 0.030}
    seg_len = {1: 0.030, 4: 0.032, 7: 0.024, 10: 0.029, 13: 0.031}
    for root in (1, 4, 7, 10, 13):
        direction = np.array([0.35 if root == 13 else 0.0, 1.0, 0.0])
        direction = direction / np.linalg.norm(direction)
        for k in range(3):
            joints[root + k] = np.array([finger_x[root], base_y[root], 0.0]) \
                + direction * seg_len[root] * k
    segments = []
    for j in range(1, NUM_MANO_JOINTS):
        p = PARENTS[j]
        segments.append((joints[p], joints[j], j))
        if j in (3, 6, 9, 12, 15):
            segments.append((joints[j], joints[j] + (joints[j] - joints[PARENTS[j]]) * 0.9, j))
    verts = []
    n_per_seg = NUM_VERTS // (len(segments) + 6)
    for (a, b, _) in segments:
        t = rs.rand(n_per_seg, 1)
        verts.append(a + (b - a) * t + rs.randn(n_per_seg, 3) * 0.006)
    remaining = NUM_VERTS - n_per_seg * len(segments)
    verts.append(rs.randn(remaining, 3) * np.array([0.03, 0.03, 0.008]) + np.array([0.0, 0.04, 0.0]))
    v_template = np.concatenate(verts, axis=0)[:NUM_VERTS]

    def point_seg_dist(p, a, b):
        ab = b - a
        t = np.clip(((p - a) @ ab) / (ab @ ab + 1e-12), 0.0, 1.0)
        return np.linalg.norm(p - (a + t[:, None] * ab), axis=1)

    dists = np.full((NUM_VERTS, NUM_MANO_JOINTS), 1e3)
    for (a, b, j) in segments:
        dists[:, j] = np.minimum(dists[:, j], point_seg_dist(v_template, a, b))
    dists[:, 0] = point_seg_dist(v_template, joints[0], np.array([0.0, 0.06, 0.0]))
    w = np.exp(-((dists / 0.012) ** 2))
    w = w / (w.sum(axis=1, keepdims=True) + 1e-9)
    order = np.argsort(-w, axis=1)
    keep = np.zeros_like(w)
    rows = np.arange(NUM_VERTS)[:, None]
    keep[rows, order[:, :4]] = w[rows, order[:, :4]]
    lbs_weights = keep / keep.sum(axis=1, keepdims=True)
    j_reg = np.zeros((NUM_MANO_JOINTS, NUM_VERTS))
    for j in range(NUM_MANO_JOINTS):
        d = np.linalg.norm(v_template - joints[j], axis=1)
        idx = np.argsort(d)[:12]
        inv = 1.0 / (d[idx] + 1e-4)
        j_reg[j, idx] = inv / inv.sum()
    shapedirs = rs.randn(NUM_VERTS, 3, 10) * 0.002
    posedirs = rs.randn(NUM_VERTS, 3, 135) * 0.0004
    f32 = lambda a: np.asarray(a, np.float32)
    return {"v_template": f32(v_template), "shapedirs": f32(shapedirs), "posedirs": f32(posedirs),
            "j_regressor": f32(j_reg), "lbs_weights": f32(lbs_weights)}


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    angle = torch.sqrt((aa * aa).sum(-1, keepdim=True) + 1e-16)
    axis = aa / angle
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).reshape(aa.shape[:-1] + (3, 3))
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * k + (1 - c) * (k @ k)


def regress_joints(j_regressor: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """(16, 778) regressor, (..., 778, 3) vertices -> 21 OpenPose joints (..., 21, 3)."""
    j16 = torch.einsum("jv,...vc->...jc", j_regressor, verts)
    return torch.cat([j16, verts[..., list(TIP_VERTS), :]], -2)[..., MANO_TO_OPENPOSE, :]


def mano_forward(m: dict, pose: torch.Tensor, betas: torch.Tensor):
    """pose (B, 48) axis-angle, betas (B, 10) -> (verts (B, 778, 3), joints (B, 21, 3))."""
    dev = pose.device
    t = {k: torch.as_tensor(v, device=dev) for k, v in m.items()}
    B = pose.shape[0]
    v_shaped = t["v_template"] + torch.einsum("vcs,bs->bvc", t["shapedirs"], betas)
    j_rest = torch.einsum("jv,bvc->bjc", t["j_regressor"], v_shaped)
    rots = rodrigues(pose.reshape(B, 16, 3))
    eye = torch.eye(3, dtype=pose.dtype, device=dev)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", t["posedirs"], (rots[:, 1:] - eye).reshape(B, -1))
    glob_r, glob_t = [rots[:, 0]], [j_rest[:, 0]]
    for j in range(1, 16):
        p = int(PARENTS[j])
        glob_r.append(glob_r[p] @ rots[:, j])
        glob_t.append(glob_t[p] + (glob_r[p] @ (j_rest[:, j] - j_rest[:, p])[..., None])[..., 0])
    R, T = torch.stack(glob_r, 1), torch.stack(glob_t, 1)          # (B, 16, 3, 3), (B, 16, 3)
    T_rel = T - (R @ j_rest[..., None])[..., 0]                      # skinning translation
    W = t["lbs_weights"]
    Rv = torch.einsum("vj,bjik->bvik", W, R)
    Tv = torch.einsum("vj,bji->bvi", W, T_rel)
    verts = (Rv @ v_posed[..., None])[..., 0] + Tv
    joints = torch.cat([T, verts[:, list(TIP_VERTS)]], 1)[:, MANO_TO_OPENPOSE]
    return verts, joints
