"""The traffic generator of the training cells: a pool of padded multi-view
training batches with synthetic-hand targets, from a ``traffic`` file and a seed.

A copy of the port's synthetic training sampler, not an import:
``poem_v2_tpu_torch/data/synthetic.py:SyntheticMultiviewDataset.sample_batch``
(MANO pose N(0, 0.1), shape N(0, 0.3), the hand placed at z 0.45-0.75 m in front
of the master camera, the other cameras on a sphere around the hand looking at
it, focal 1.8 x the crop, the ground-truth joints projected into every view),
with the hand model of ``reference/mano_ref.py``. Padded views sit at the end
with zero images and 2D joints and identity cameras, as ``data/collate.py``
lays them out. What differs: valid-view counts are a fixed multiset
apportioned from the mixture of the traffic's ``view_ranges`` (every seed gets
the same set of sizes, in its own order), and images are uint8 noise drawn on
the device in one call, normalised as the data pipeline does (x / 255 - 0.5).

Parameters (a file ``benchmark/traffic/<mix>.json``): batch, view_bucket,
image_size, pool (distinct batches made at set-up and held on the device),
view_ranges (a list of [lo, hi], each a source of samples with views uniform
in it), mix_ratios (each source's weight), pose_std, shape_std.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Sequence

import numpy as np
import torch

from .generator import _look_at
from .reference.mano_ref import mano_forward, synthetic_mano

KEYS = ("image", "view_mask", "cam_intr", "cam_extr", "master_joints_3d", "master_verts_3d",
        "target_joints_2d", "mano_pose", "mano_shape")


def mixture_counts(n: int, view_ranges: Sequence[Sequence[int]],
                   ratios: Sequence[float]) -> np.ndarray:
    """n valid-view counts apportioned (largest remainder, ties to fewer views)
    from the mixture of uniform ranges weighted by ``ratios``, in ascending order."""
    weights = [Fraction(str(r)) for r in ratios]
    if len(weights) != len(view_ranges):
        raise ValueError("one mix ratio a view range")
    share: Dict[int, Fraction] = {}
    for (lo, hi), w in zip(view_ranges, weights):
        for v in range(lo, hi + 1):
            share[v] = share.get(v, Fraction(0)) + w / (sum(weights) * (hi - lo + 1))
    exact = {v: share[v] * n for v in sorted(share)}
    counts = {v: int(x) for v, x in exact.items()}
    left = n - sum(counts.values())
    for v in sorted(exact, key=lambda v: (-(exact[v] - counts[v]), v))[:left]:
        counts[v] += 1
    return np.repeat(np.array(sorted(counts)), [counts[v] for v in sorted(counts)])


def make_train_pool(traffic: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` distinct batches, each a dict of ``KEYS`` as tensors on
    ``device`` (the training feed's layout, ``training/prefetch.py:cache_on_device``)."""
    B, V, S, P = (traffic[k] for k in ("batch", "view_bucket", "image_size", "pool"))
    rs = np.random.RandomState(np.random.SeedSequence([seed, 7]).generate_state(1)[0])
    counts = mixture_counts(P * B, traffic["view_ranges"], traffic["mix_ratios"])
    if counts.max() > V:
        raise ValueError(f"a view range reaches {counts.max()} views, the bucket holds {V}")
    counts = counts[rs.permutation(P * B)].reshape(P, B)
    mano = synthetic_mano()
    gen = torch.Generator(device=device).manual_seed(int(rs.randint(2 ** 62)))
    images = torch.randint(0, 256, (P, B, V, S, S, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    pool = []
    for p in range(P):
        pose = (rs.randn(B, 48) * traffic["pose_std"]).astype(np.float32)
        betas = (rs.randn(B, 10) * traffic["shape_std"]).astype(np.float32)
        with torch.no_grad():
            verts, joints = mano_forward(mano, torch.from_numpy(pose), torch.from_numpy(betas))
        offset = np.stack([rs.uniform(-0.05, 0.05, B), rs.uniform(-0.05, 0.05, B),
                           rs.uniform(0.45, 0.75, B)], axis=1).astype(np.float32)
        joints = joints.numpy() + offset[:, None]
        verts = verts.numpy() + offset[:, None]
        extr = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
        for b in range(B):
            centre = joints[b].mean(0)
            for v in range(1, V):
                angle, elev = rs.uniform(0, 2 * np.pi), rs.uniform(-0.6, 0.6)
                radius = np.linalg.norm(centre) * rs.uniform(0.8, 1.2)
                eye = centre + radius * np.array([np.cos(angle) * np.cos(elev), np.sin(elev),
                                                  np.sin(angle) * np.cos(elev)])
                extr[b, v, :3, :3] = _look_at(eye.astype(np.float64), centre.astype(np.float64))
                extr[b, v, :3, 3] = eye
        intr = np.zeros((B, V, 3, 3), np.float32)
        intr[..., 0, 0] = intr[..., 1, 1] = S * 1.8
        intr[..., 0, 2] = intr[..., 1, 2] = S / 2
        intr[..., 2, 2] = 1.0
        m2c = np.linalg.inv(extr)
        cam = np.einsum("bvij,bnj->bvni", m2c[..., :3, :3], joints) + m2c[..., :3, 3][:, :, None]
        proj = np.einsum("bvni,bvji->bvnj", cam, intr)
        joints_2d = (proj[..., :2] / proj[..., 2:]).astype(np.float32)
        mask = np.arange(V)[None, :] < counts[p][:, None]
        # padded views: identity cameras, zero 2D joints and images (data/collate.py)
        extr[~mask] = np.eye(4, dtype=np.float32)
        intr[~mask] = np.eye(3, dtype=np.float32)
        joints_2d[~mask] = 0.0
        img = images[p].float() / 255.0 - 0.5
        img[torch.as_tensor(~mask, device=device)] = 0.0
        t = lambda a: torch.as_tensor(a).to(device)
        pool.append({"image": img, "view_mask": t(mask), "cam_intr": t(intr), "cam_extr": t(extr),
                     "master_joints_3d": t(joints.astype(np.float32)),
                     "master_verts_3d": t(verts.astype(np.float32)),
                     "target_joints_2d": t(joints_2d), "mano_pose": t(pose.reshape(B, 16, 3)),
                     "mano_shape": t(betas)})
    del images
    return pool
