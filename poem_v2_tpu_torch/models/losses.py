"""POEM loss stack (counterpart of ``poem_v2_tpu/models/losses.py``).

Heatmap-2D joint loss (x10), 3D joints L2 (+ joints from the mesh by the
MANO J-regressor), 3D verts L1, the clamped multi-camera 2D reprojection
loss and the optional MANO pose / shape MSE, over padded (B, V) batches
with a view mask. All float32.

Under data parallel (a process group of R > 1 ranks, each holding its rows
of the global batch) every term is built so that the mean of the ranks'
values, and so ``DistributedDataParallel``'s mean of their gradients, is the
term of the global batch: a masked view mean divides the rank's sum by the
valid views of the whole batch (all-reduced) and multiplies by R, and a plain
mean is the local mean, since every rank holds as many rows. Outside such a
group the arithmetic is the single-process one, bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from ..geometry.camera import cam_extr_transf, cam_intr_projection, invert_rigid, mano_to_openpose
from ..parallel import mesh


def count_over_ranks(count: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(``count`` summed over the ranks of the process group, its world size);
    ``(count, 1)`` outside a group of more than one rank."""
    world = mesh.world_size()
    if world == 1:
        return count, 1
    return mesh.all_reduce_sum(count), world


def masked_view_mean(x: torch.Tensor, view_mask: torch.Tensor) -> torch.Tensor:
    """Mean of x (B, V, ...) over valid views and all trailing dims; under data
    parallel this rank's share of the global batch's mean (see the module)."""
    mask = view_mask.to(x.dtype)
    extra = x.dim() - 2
    total = (x * mask.reshape(mask.shape + (1,) * extra)).sum()
    count, world = count_over_ranks(mask.sum())
    denom = count * math.prod(x.shape[2:]) if extra else count
    mean = total / torch.clamp_min(denom, 1.0)
    return mean if world == 1 else mean * world


def reprojection_loss(pred_points: torch.Tensor, cam_extr: torch.Tensor, cam_intr: torch.Tensor,
                      gt_2d: torch.Tensor, view_mask: torch.Tensor,
                      img_scale: float) -> torch.Tensor:
    """Clamped, diagonal-normalised multi-camera 2D loss: points (B, N, 3) in the
    master frame, cameras (B, V, 4, 4) camera->master and (B, V, 3, 3), gt (B, V, N, 2)."""
    pts_cam = cam_extr_transf(invert_rigid(cam_extr), pred_points[:, None])
    pred_2d = cam_intr_projection(cam_intr, pts_cam)
    offset = torch.clamp(pred_2d - gt_2d, -0.5 * img_scale, 0.5 * img_scale) / img_scale
    return masked_view_mean((offset ** 2).sum(-1), view_mask)


def poem_loss(preds: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
              j_regressor: torch.Tensor, loss_cfg: Mapping, num_joints: int = 21,
              transformer_center_idx: int = 9, parametric: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and the per-term dict; ``loss_cfg`` is the config's ``MODEL.LOSS``."""
    all_coords = preds["all_coords_preds"]  # (n_blocks, B, 799, 3)
    view_mask = batch["view_mask"]
    H, W = batch["image"].shape[2], batch["image"].shape[3]
    img_scale = math.sqrt(float(W ** 2 + H ** 2))
    gt_joints = batch["master_joints_3d"]
    gt_verts = batch["master_verts_3d"]
    gt_2d = batch["target_joints_2d"]
    j_regressor = j_regressor.to(gt_verts.device)

    joints_l2 = loss_cfg.get("JOINTS_LOSS_TYPE", "l2") == "l2"
    verts_l2 = loss_cfg.get("VERTICES_LOSS_TYPE", "l1") == "l2"

    def recon(pred, gt, use_l2):
        d = pred - gt
        return (d ** 2).mean() if use_l2 else d.abs().mean()

    loss_dict: Dict[str, torch.Tensor] = {}
    hm_off = (preds["pred_joints_uv"] - gt_2d) / img_scale
    loss_hm = masked_view_mean((hm_off ** 2).sum(-1), view_mask)
    loss_dict["loss_heatmap_joints"] = loss_hm
    loss = loss_cfg.get("HEATMAP_JOINTS_WEIGHT", 10.0) * loss_hm

    pred_joints = all_coords[-1, :, :num_joints]
    pred_verts = all_coords[-1, :, num_joints:]
    loss_3d_joints = recon(pred_joints, gt_joints, joints_l2)
    loss_3d_joints_from_mesh = recon(mano_to_openpose(j_regressor, pred_verts),
                                     mano_to_openpose(j_regressor, gt_verts), joints_l2)
    loss_recon = loss_cfg.get("JOINTS_LOSS_WEIGHT", 1.0) * (
        loss_3d_joints + loss_3d_joints_from_mesh)

    if parametric:
        # parametric output is root-relative at the transformer centre joint
        centre = gt_joints[:, transformer_center_idx][:, None]
        loss_3d_verts = recon(pred_verts - centre, gt_verts - centre, verts_l2)
    else:
        loss_3d_verts = recon(pred_verts, gt_verts, verts_l2)
    loss_recon = loss_recon + loss_cfg.get("VERTICES_LOSS_WEIGHT", 1.0) * loss_3d_verts

    w2d = loss_cfg.get("JOINTS_2D_LOSS_WEIGHT", 1.0)
    if w2d != 0:
        loss_2d = reprojection_loss(pred_joints, batch["cam_extr"], batch["cam_intr"], gt_2d,
                                    view_mask, img_scale)
        loss_recon = loss_recon + w2d * loss_2d
        loss_dict["loss_2d_joints"] = loss_2d

    w2dv = loss_cfg.get("VERTICES_2D_LOSS_WEIGHT", 0.0)
    if w2dv != 0:
        gt_v_cam = cam_extr_transf(invert_rigid(batch["cam_extr"]), gt_verts[:, None])
        gt_v2d = cam_intr_projection(batch["cam_intr"], gt_v_cam)
        loss_2d_verts = reprojection_loss(pred_verts, batch["cam_extr"], batch["cam_intr"],
                                          gt_v2d, view_mask, img_scale)
        loss_recon = loss_recon + w2dv * loss_2d_verts
        loss_dict["loss_2d_verts"] = loss_2d_verts

    if parametric and "pred_pose" in preds:
        loss_pose = ((preds["pred_pose"] - batch["mano_pose"]) ** 2).mean()
        loss_shape = ((preds["pred_shape"] - batch["mano_shape"]) ** 2).mean()
        loss_recon = (loss_recon + loss_cfg.get("POSE_LOSS_WEIGHT", 0.001) * loss_pose
                      + loss_cfg.get("SHAPE_LOSS_WEIGHT", 0.0005) * loss_shape)
        loss_dict["loss_pose"] = loss_pose
        loss_dict["loss_shape"] = loss_shape

    loss = loss + loss_recon
    loss_dict["loss_3d_joints"] = loss_3d_joints
    loss_dict["loss_3d_joints_from_mesh"] = loss_3d_joints_from_mesh
    loss_dict["loss_3d_verts"] = loss_3d_verts
    loss_dict["loss_recon"] = loss_recon
    loss_dict["loss"] = loss
    return loss, loss_dict
