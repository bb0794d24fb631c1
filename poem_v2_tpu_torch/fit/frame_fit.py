"""Optimisation-based MANO fitting to multi-view keypoints (counterpart of
``poem_v2_tpu/fit/frame_fit.py``).

Gradient descent over (quaternion pose 16 x 4, shape 10, translation 3),
batched over frames, minimising the multi-view 2D reprojection error plus the
axis-aware anatomical regularisers (``hand_loss.py``), a shape prior and,
optionally, a 3D joint term. The JAX package runs the loop as one ``lax.scan``
over ``optax.adam(exponential_decay(lr, steps // 3, 0.5, staircase=True))``;
here it is a loop of ``torch.optim.Adam`` whose rate is set before each step
from the count of updates made (optax reads its count before the update, and
returns the constant rate when ``steps // 3`` is 0).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from ..geometry.camera import cam_extr_transf, cam_intr_projection, invert_rigid
from ..geometry.rotations import quat_to_aa
from ..mano.layer import ManoLayer
from .hand_loss import anatomical_loss as axis_anatomical_loss


class FitParams(NamedTuple):
    quat: torch.Tensor   # (B, 16, 4)
    shape: torch.Tensor  # (B, 10)
    tsl: torch.Tensor    # (B, 3)


class FitResult(NamedTuple):
    params: FitParams
    pose_aa: torch.Tensor  # (B, 48)
    verts: torch.Tensor    # (B, 778, 3)
    joints: torch.Tensor   # (B, 21, 3)
    losses: torch.Tensor   # (steps,)


def _init_params(batch: int, device=None) -> FitParams:
    """Identity quaternions, zero shape and translation."""
    quat = torch.zeros((batch, 16, 4), device=device)
    quat[..., 0] = 1.0
    return FitParams(quat=quat, shape=torch.zeros((batch, 10), device=device),
                     tsl=torch.zeros((batch, 3), device=device))


def anatomical_loss(pose_aa: torch.Tensor) -> torch.Tensor:
    """Cheap axis-angle penalty for callers without MANO outputs: the fingers'
    twist (x) and splay (y) kept small, flexion (z) free up to 2 rad. The fitter
    uses the axis-aware stack of ``hand_loss.py``."""
    finger = pose_aa.reshape(pose_aa.shape[0], 16, 3)[:, 1:]
    over_flex = torch.clamp_min(finger[..., 2].abs() - 2.0, 0.0)
    return ((finger[..., 0] ** 2).mean() + (finger[..., 1] ** 2).mean() * 0.5
            + (over_flex ** 2).mean())


def _as_tensor(x, device, dtype=torch.float32):
    return None if x is None else torch.as_tensor(x, device=device).to(dtype)


class OneFrameFit:
    """Batched multi-view MANO fitting on ``device`` (the card by default)."""

    def __init__(self, mano_layer: Optional[ManoLayer] = None, lr: float = 1e-2,
                 steps: int = 300, w_reproj: float = 1.0, w_anat: float = 1e-3,
                 w_shape: float = 1e-3, w_joint3d: float = 0.0,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the fitter targets a CUDA device and none is available; "
                               'pass device="cpu" to fit there')
        self.mano = mano_layer if mano_layer is not None else ManoLayer()
        self.lr = lr
        self.steps = steps
        self.w = dict(reproj=w_reproj, anat=w_anat, shape=w_shape, joint3d=w_joint3d)

    def learning_rate(self, count: int) -> float:
        """optax ``exponential_decay(lr, steps // 3, 0.5, staircase=True)`` at update
        ``count`` (0 for the first)."""
        every = self.steps // 3
        return self.lr if every <= 0 else self.lr * 0.5 ** (count // every)

    def _forward(self, params: FitParams):
        quat = params.quat / torch.linalg.vector_norm(params.quat, dim=-1,
                                                      keepdim=True).clamp_min(1e-8)
        pose_aa = quat_to_aa(quat).reshape(quat.shape[0], 48)
        out = self.mano(pose_aa, params.shape)
        return pose_aa, out.verts + params.tsl[:, None], out.joints + params.tsl[:, None]

    def loss(self, params: FitParams, target_2d: torch.Tensor, cam_intr: torch.Tensor,
             cam_extr: torch.Tensor, view_mask: torch.Tensor,
             target_joints_3d: Optional[torch.Tensor] = None) -> torch.Tensor:
        """target_2d (B, V, 21, 2), cam_intr (B, V, 3, 3), cam_extr (B, V, 4, 4)
        camera -> world, view_mask (B, V) -> the scalar objective."""
        quat_normed = params.quat / torch.linalg.vector_norm(params.quat, dim=-1,
                                                             keepdim=True).clamp_min(1e-8)
        pose_aa = quat_to_aa(quat_normed).reshape(quat_normed.shape[0], 48)
        out = self.mano(pose_aa, params.shape)
        joints = out.joints + params.tsl[:, None]

        j_cam = cam_extr_transf(invert_rigid(cam_extr), joints[:, None])
        err = ((cam_intr_projection(cam_intr, j_cam) - target_2d) ** 2).sum(-1)  # (B, V, 21)
        mask = view_mask[..., None].to(err.dtype)
        reproj = (err * mask).sum() / (mask.sum() * 21).clamp_min(1.0)

        # the axis frames come from the untranslated MANO output: they read only
        # joint differences and local rotations
        anat = axis_anatomical_loss(params.quat, quat_normed, params.shape, out.joints,
                                    out.transforms)
        total = self.w["reproj"] * reproj
        total = total + self.w["anat"] * anat
        total = total + self.w["shape"] * (params.shape ** 2).mean()
        if target_joints_3d is not None and self.w["joint3d"]:
            total = total + self.w["joint3d"] * ((joints - target_joints_3d) ** 2).mean()
        return total

    def make_optimizer(self, params: FitParams) -> torch.optim.Adam:
        """Adam over the leaves of ``params`` (optax's defaults: betas 0.9 / 0.999,
        eps 1e-8)."""
        return torch.optim.Adam(list(params), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def step(self, params: FitParams, opt: torch.optim.Adam, count: int,
             loss_fn: Callable[[FitParams], torch.Tensor]) -> torch.Tensor:
        """One update at ``count``: the loss at ``params`` (returned, detached), its
        gradient, and Adam at ``learning_rate(count)``."""
        for group in opt.param_groups:
            group["lr"] = self.learning_rate(count)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        return loss.detach()

    def fit(self, target_2d, cam_intr, cam_extr, view_mask=None, target_joints_3d=None,
            init: Optional[FitParams] = None) -> FitResult:
        """Fit ``steps`` updates from ``init`` (identity pose; the translation at the
        mean of ``target_joints_3d`` where given). Arrays or tensors, on any device."""
        dev = self.device
        target_2d, cam_intr, cam_extr = (_as_tensor(a, dev) for a in (target_2d, cam_intr,
                                                                      cam_extr))
        target_joints_3d = _as_tensor(target_joints_3d, dev)
        B = target_2d.shape[0]
        view_mask = (torch.ones(target_2d.shape[:2], dtype=torch.bool, device=dev)
                     if view_mask is None else torch.as_tensor(view_mask, device=dev))
        params = _init_params(B, dev) if init is None else FitParams(
            *(_as_tensor(p, dev) for p in init))
        if target_joints_3d is not None and init is None:
            params = params._replace(tsl=target_joints_3d.mean(1))
        params = FitParams(*(p.detach().clone().requires_grad_(True) for p in params))
        opt = self.make_optimizer(params)

        def loss_fn(p):
            return self.loss(p, target_2d, cam_intr, cam_extr, view_mask, target_joints_3d)

        losses: List[torch.Tensor] = [self.step(params, opt, t, loss_fn)
                                      for t in range(self.steps)]
        params = FitParams(*(p.detach() for p in params))
        with torch.no_grad():
            pose_aa, verts, joints = self._forward(params)
        return FitResult(params=params, pose_aa=pose_aa, verts=verts, joints=joints,
                         losses=torch.stack(losses) if losses else target_2d.new_zeros(0))
