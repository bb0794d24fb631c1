"""Serving predictor for POEM (counterpart of ``poem_v2_tpu/serving/predictor.py``).

Wraps a built model: requests are padded to a fixed view bucket (padded
views get identity x 100 intrinsics, identity extrinsics and a False view
mask) and to the smallest batch bucket that holds them (padded rows copy
row 0); the model runs in bfloat16 by default; numpy in, numpy out.

Typical use::

    pred = Predictor.from_config(MEDIUM, ckpt_path="medium.pt", device="cuda")
    out = pred(images, cam_intr, cam_extr)   # ragged views / batch are padded
    out["joints_3d"]                         # (B, 21, 3) master space

``warmup(batch_size)`` runs one forward of a bucket ahead of traffic.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.poem import create_poem_model
from ..utils.profiling import span, sync_point
from ..utils.recorder import Recorder


def ring_cameras(views: int, size: int, target_z: float = 0.5, radius: float = 0.5):
    """(V, 3, 3) intrinsics and (V, 4, 4) camera->master extrinsics of ``views``
    cameras on a horizontal ring around (0, 0, ``target_z``), each looking at it;
    camera 0 sits at the master's origin."""
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


class Predictor:
    def __init__(self, model: torch.nn.Module, view_bucket: int = 8, image_size: int = 256,
                 batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)):
        self.model = model.eval()
        self.view_bucket = view_bucket
        self.image_size = image_size
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.device = next(model.parameters()).device

    @classmethod
    def from_config(cls, cfg: dict, ckpt_path: Optional[str] = None,
                    state_dict: Optional[dict] = None, view_bucket: int = 8,
                    dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda",
                    seed: int = 0) -> "Predictor":
        """Build from a config with ``MODEL`` (and optionally ``DATA_PRESET``) sections.

        ``ckpt_path`` is a port checkpoint or weights file (what ``--reload``
        reads: a train checkpoint, or the output of ``scripts/torch_convert_checkpoint.py``
        or ``scripts/torch_export_checkpoint.py``); ``state_dict`` a converted JAX
        parameter tree (:mod:`..convert`). Without either the weights are random,
        drawn from ``seed``."""
        model, _ = create_poem_model(cfg["MODEL"], dtype=torch.float32, device="cpu",
                                     generator=torch.Generator().manual_seed(seed))
        if ckpt_path is not None:
            Recorder.load_params(ckpt_path, model)
        if state_dict is not None:
            model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                                   state_dict.items()})
        size = cfg.get("DATA_PRESET", {}).get("IMAGE_SIZE", [256])[0]
        return cls(model.to(device=device, dtype=dtype), view_bucket=view_bucket, image_size=size)

    def warmup(self, batch_size: int = 1) -> float:
        """Run one forward of the bucket that holds ``batch_size`` at the view
        bucket and wait for the device: the counterpart of the JAX Predictor's
        compile ahead of traffic (here: the kernels' build and first launches,
        cuDNN's algorithm choice, the caching allocator's blocks). The request is
        blank views from a ring of cameras around a point 0.5 m in front of the
        master (the JAX package's identity cameras would make every view the same
        ray bundle, and the triangulation degenerate). Returns the seconds it took."""
        t = time.perf_counter()
        B, V, S = self._batch_bucket(batch_size), self.view_bucket, self.image_size
        intr, extr = ring_cameras(V, S)
        self(np.zeros((B, V, S, S, 3), np.float32), np.tile(intr, (B, 1, 1, 1)),
             np.tile(extr, (B, 1, 1, 1)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t

    def _batch_bucket(self, b: int) -> int:
        for bb in self.batch_buckets:
            if bb >= b:
                return bb
        return b

    def pad(self, images: np.ndarray, cam_intr: np.ndarray, cam_extr: np.ndarray,
            view_mask: Optional[np.ndarray] = None):
        """Pad a request to (batch bucket, view bucket); returns numpy arrays."""
        images = np.asarray(images)
        B, V = images.shape[:2]
        if view_mask is None:
            view_mask = np.ones((B, V), bool)
        view_mask = np.asarray(view_mask, bool)
        cam_intr = np.asarray(cam_intr, np.float32)
        cam_extr = np.asarray(cam_extr, np.float32)
        pad = self.view_bucket - V
        if pad < 0:
            raise ValueError(f"got {V} views > bucket {self.view_bucket}")
        if pad:
            images = np.concatenate([images, np.zeros((B, pad) + images.shape[2:], images.dtype)],
                                    axis=1)
            view_mask = np.concatenate([view_mask, np.zeros((B, pad), bool)], axis=1)
            eye3 = np.broadcast_to(np.eye(3, dtype=np.float32) * 100, (B, pad, 3, 3))
            eye4 = np.broadcast_to(np.eye(4, dtype=np.float32), (B, pad, 4, 4))
            cam_intr = np.concatenate([cam_intr, eye3], axis=1)
            cam_extr = np.concatenate([cam_extr, eye4], axis=1)
        Bp = self._batch_bucket(B)
        if Bp > B:
            def bpad(a):
                return np.concatenate([a, np.broadcast_to(a[:1], (Bp - B,) + a.shape[1:])], 0)

            images, view_mask, cam_intr, cam_extr = map(bpad, (images, view_mask, cam_intr,
                                                               cam_extr))
        return images, view_mask, cam_intr, cam_extr

    @torch.inference_mode()
    def __call__(self, images: np.ndarray, cam_intr: np.ndarray, cam_extr: np.ndarray,
                 view_mask: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """images (B, V, H, W, 3) uint8 or float in [-0.5, 0.5]; cameras (B, V, 3, 3) and
        (B, V, 4, 4) camera->master; optional (B, V) mask. Returns host float32 arrays."""
        with span("request", request=True):
            B, V = np.shape(images)[:2]
            with span("pad"):
                images, view_mask, cam_intr, cam_extr = self.pad(images, cam_intr, cam_extr,
                                                                 view_mask)
            dev = self.device
            with sync_point("h2d", dev, 4):  # four blocking copies
                img = torch.as_tensor(images).to(dev)
                if img.dtype == torch.uint8:
                    img = img.float() / 255.0 - 0.5
                mask_d = torch.as_tensor(view_mask).to(dev)
                intr_d = torch.as_tensor(cam_intr).to(dev)
                extr_d = torch.as_tensor(cam_extr).to(dev)
            with span("forward"):
                preds = self.model(
                    img.float(), mask_d, intr_d, extr_d,
                    torch.zeros((images.shape[0], 21, 3), dtype=torch.float32, device=dev))
            with sync_point("readback", dev, 5):  # one blocking copy an output
                host = lambda k: preds[k].float().cpu().numpy()
                return {
                    "joints_3d": host("pred_joints_3d")[:B],
                    "verts_3d": host("pred_verts_3d")[:B],
                    "joints_3d_rel": host("pred_joints_3d_rel")[:B],
                    "verts_3d_rel": host("pred_verts_3d_rel")[:B],
                    "joints_uv": host("pred_joints_uv")[:B, :V],
                }
