"""Serving predictor for POEM (counterpart of ``poem_v2_tpu/serving/predictor.py``).

Wraps a built model: requests are padded to a fixed view bucket (padded
views get identity x 100 intrinsics, identity extrinsics and a False view
mask) and to the smallest batch bucket that holds them (padded rows copy
row 0); the model runs in bfloat16 by default; numpy in, numpy out.

Typical use::

    pred = Predictor.from_config(MEDIUM, ckpt_path="medium.pt", device="cuda")
    out = pred(images, cam_intr, cam_extr)   # ragged views / batch are padded
    out["joints_3d"]                         # (B, 21, 3) master space
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.poem import create_poem_model
from ..utils.recorder import Recorder


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
            images = np.concatenate([images, np.zeros_like(images[:, :pad])], axis=1)
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
        B, V = np.shape(images)[:2]
        images, view_mask, cam_intr, cam_extr = self.pad(images, cam_intr, cam_extr, view_mask)
        dev = self.device
        img = torch.as_tensor(images).to(dev)
        if img.dtype == torch.uint8:
            img = img.float() / 255.0 - 0.5
        preds = self.model(
            img.float(), torch.as_tensor(view_mask).to(dev),
            torch.as_tensor(cam_intr).to(dev), torch.as_tensor(cam_extr).to(dev),
            torch.zeros((images.shape[0], 21, 3), dtype=torch.float32, device=dev))
        host = lambda k: preds[k].float().cpu().numpy()
        return {
            "joints_3d": host("pred_joints_3d")[:B],
            "verts_3d": host("pred_verts_3d")[:B],
            "joints_3d_rel": host("pred_joints_3d_rel")[:B],
            "verts_3d_rel": host("pred_verts_3d_rel")[:B],
            "joints_uv": host("pred_joints_uv")[:B, :V],
        }
