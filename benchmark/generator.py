"""The one traffic generator: padded multi-view batches from a workload's
``traffic`` parameters and a seed.

A copy of the port's generators, not an import: cameras on a sphere looking
at a hand centre in the master frame are ``poem_v2_tpu_torch/data/synthetic.py``'s,
the fixed ring of cameras is
``poem_v2_tpu_torch/serving/predictor.py:ring_cameras``, and padded views sit
at the end with zero images and 2D joints and identity cameras, as
``data/collate.py`` lays them out. What differs: valid-view counts are a
fixed, balanced multiset in an order drawn from the seed (every seed gets the
same set of sizes), and images are noise drawn on the device in one call.

Parameters (a file ``benchmark/traffic/<mix>.json``):
  batch, view_bucket, image_size, pool (distinct batches made at set-up),
  views [lo, hi] (valid views a sample, balanced over lo..hi),
  image "uint8" (0..255) or "float32" (in [-0.5, 0.5)),
  cameras "sphere" (a hand-centred sphere a sample) or "ring" (one fixed rig).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def ring_cameras(views: int, size: int, target_z: float = 0.5, radius: float = 0.5):
    """(V, 3, 3) intrinsics and (V, 4, 4) camera->master extrinsics of ``views``
    cameras on a horizontal ring around (0, 0, ``target_z``), each looking at it."""
    intr = np.zeros((views, 3, 3), np.float32)
    extr = np.zeros((views, 4, 4), np.float32)
    target = np.array([0.0, 0.0, target_z])
    for v in range(views):
        a = 2 * np.pi * v / views
        centre = target + radius * np.array([np.sin(a), 0.0, -np.cos(a)])
        z = (target - centre) / np.linalg.norm(target - centre)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        extr[v, :3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
        extr[v, :3, 3] = centre
        extr[v, 3, 3] = 1.0
        intr[v] = [[1.5 * size, 0, size / 2], [0, 1.5 * size, size / 2], [0, 0, 1]]
    return intr, extr


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, z)) > 0.98:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=1)


def view_counts(n: int, lo: int, hi: int, rs: np.random.RandomState) -> np.ndarray:
    """n valid-view counts covering lo..hi as evenly as n allows, in a seeded order."""
    counts = np.resize(np.arange(lo, hi + 1), n)
    return counts[rs.permutation(n)]


def make_pool(traffic: Dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` distinct batches (numpy, as a caller hands them over)."""
    B, V, S, P = (traffic[k] for k in ("batch", "view_bucket", "image_size", "pool"))
    lo, hi = traffic["views"]
    rs = np.random.RandomState(np.random.SeedSequence(seed).generate_state(1)[0])
    counts = view_counts(P * B, lo, hi, rs).reshape(P, B)
    gen = torch.Generator(device=device).manual_seed(int(rs.randint(2 ** 62)))
    shape = (P, B, V, S, S, 3)
    if traffic["image"] == "uint8":
        images = torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
    else:
        images = torch.rand(shape, generator=gen, device=device) - 0.5
    images = images.cpu().numpy()
    pool = []
    for p in range(P):
        mask = np.arange(V)[None, :] < counts[p][:, None]
        img = images[p]
        img[~mask] = 0
        batch = {"image": img, "view_mask": mask}
        if traffic["cameras"] == "ring":
            intr, extr = ring_cameras(V, S)
            batch["cam_intr"] = np.tile(intr, (B, 1, 1, 1))
            batch["cam_extr"] = np.tile(extr, (B, 1, 1, 1))
            centre = np.tile([[0.0, 0.0, 0.5]], (B, 1))
        else:
            centre = np.stack([rs.uniform(-0.05, 0.05, B), rs.uniform(-0.05, 0.05, B),
                               rs.uniform(0.45, 0.75, B)], axis=1).astype(np.float32)
            extr = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
            for b in range(B):
                for v in range(1, V):
                    angle, elev = rs.uniform(0, 2 * np.pi), rs.uniform(-0.6, 0.6)
                    radius = np.linalg.norm(centre[b]) * rs.uniform(0.8, 1.2)
                    eye = centre[b] + radius * np.array([np.cos(angle) * np.cos(elev), np.sin(elev),
                                                         np.sin(angle) * np.cos(elev)])
                    extr[b, v, :3, :3] = _look_at(eye, centre[b].astype(np.float64))
                    extr[b, v, :3, 3] = eye
            intr = np.zeros((B, V, 3, 3), np.float32)
            intr[..., 0, 0] = intr[..., 1, 1] = S * 1.8
            intr[..., 0, 2] = intr[..., 1, 2] = S / 2
            intr[..., 2, 2] = 1.0
            batch["cam_intr"], batch["cam_extr"] = intr, extr
        # padded views: identity cameras, zero 2D joints (data/collate.py)
        batch["cam_extr"][~mask] = np.eye(4, dtype=np.float32)
        batch["cam_intr"][~mask] = np.eye(3, dtype=np.float32)
        pool.append(batch)
    return pool
