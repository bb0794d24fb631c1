"""The MVP baseline: multi-view pose with projective deformable attention
(counterpart of ``poem_v2_tpu/models/mvp.py``).

21 joint queries are refined layer by layer. Each layer projects its
reference joints into every view, samples each view's features around the
projections (``ProjAttn``: per head, level and point, a bilinear gather of a
ray-conditioned value map, weighted by a softmax), fuses the views by a
masked mean, and regresses MANO pose and shape off the flattened queries;
the head owns a per-layer branch that refines the joints in sigmoid space.
The gather is the 4-tap :func:`..ops.sampling.grid_sample_points`, plain
PyTorch on every device as it is XLA in the JAX package.

What the JAX module keeps from the reference, and so does this one:

* the offsets' and weights' lvl-major -> head-major ``reshape`` (only
  consistent for one linear level, ``lin_levels`` 1; anything else raises);
* the reference pixels are normalised by their maximum over the WHOLE batch,
  padded views included: the output depends on what padded views hold, so
  parity holds only on identical padded inputs;
* world -> camera by the full ``inv(cam_extr)`` in float32, the rays with
  ``K`` rescaled by ``W / image_size[0]``, all as float32 products and sums;
* the reference joints enter each layer's projection detached;
* padded views leave the view mean (divided by max(n_valid, 1)) and the
  pooled reference feature, the JAX package's masked-batch change.

LayerNorms here have eps 1e-5 (set explicitly in the JAX module); the
``feat_delayer`` ConvBlocks' BatchNorm always uses its running statistics.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..geometry.camera import cam_extr_transf, cam_intr_projection, inverse_sigmoid
from ..mano.layer import ManoLayer
from ..ops.sampling import grid_sample_points
from ..utils.registry import HEAD, MODEL
from .backbones.resnet import ResNet
from .bricks.transformer_layer import MultiheadAttention
from .neck import ConvBlock
from .petr import (POSITION_RANGE, build_baseline, data_preset, matmul_f32, maybe_autocast,
                   no_autocast, with_final_level)


def get_camera_rays(image_size: Sequence[int], H: int, W: int, intr: torch.Tensor,
                    extr: torch.Tensor) -> torch.Tensor:
    """Unit ray directions of every pixel of an H x W map, float32 (B, V, H, W, 3):
    K rescaled by ``W / image_size[0]``, ``rays_o = -R^T T``, ``pixel_world =
    (xy1 K^-T - T^T) R`` (R = extr[:3, :3], T = extr[:3, 3:], camera -> master)."""
    B, V = intr.shape[:2]
    dev = intr.device
    with no_autocast(dev):
        K = intr.float()
        K = torch.cat([K[..., :2, :] * (W / image_size[0]), K[..., 2:, :]], dim=-2)
        R = extr[..., :3, :3].float()
        T = extr[..., :3, 3:].float()
        rays_o = -matmul_f32(R.transpose(-1, -2), T)  # (B, V, 3, 1)
        j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                              torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        xy1 = torch.stack([i, j, torch.ones_like(i)], dim=-1).reshape(1, 1, H * W, 3)
        pixel_camera = matmul_f32(xy1, torch.linalg.inv(K).transpose(-1, -2))
        pixel_world = matmul_f32(pixel_camera - T.transpose(-1, -2), R)
        rays_d = pixel_world - rays_o.transpose(-1, -2)
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_d.reshape(B, V, H, W, 3)


def offset_bias(n_heads: int, n_points: int) -> np.ndarray:
    """The sampling offsets' initial bias: per-head compass directions scaled by
    the point index, flat (heads, 1 level, points, 2)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = grid[:, None, :] * np.arange(1, n_points + 1, dtype=np.float32)[None, :, None]
    return grid.reshape(-1).astype(np.float32)


class ProjAttn(nn.Module):
    """Projective multi-scale deformable attention (the reference's 'use_rayconv'
    mode) over L levels of one view each row."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_points: int = 4,
                 lin_levels: int = 1):
        super().__init__()
        if lin_levels != 1:
            raise NotImplementedError(
                "the reference ProjAttn reshape is only consistent for num_feature_levels == 1")
        self.embed_dims, self.num_heads, self.num_points = embed_dims, num_heads, num_points
        self.rayconv = nn.Linear(embed_dims + 3, embed_dims)
        self.sampling_offsets = nn.Linear(embed_dims, num_heads * lin_levels * num_points * 2)
        self.attention_weights = nn.Linear(embed_dims, num_heads * lin_levels * num_points)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def reset_offsets(self) -> None:
        """The flax initialisers: offsets = the compass bias, uniform weights."""
        with torch.no_grad():
            for lin in (self.sampling_offsets, self.attention_weights):
                lin.weight.zero_()
                lin.bias.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(offset_bias(
                self.num_heads, self.num_points)))

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                src_views: List[torch.Tensor], camera_rays: List[torch.Tensor]) -> torch.Tensor:
        """query (BV, Q, C), reference_points (BV, Q, L, 2) normalised, src_views and
        camera_rays L x (BV, H, W, C) / (BV, H, W, 3) channels-last -> (BV, Q, C)."""
        BV, Q, C = query.shape
        nh, npt = self.num_heads, self.num_points
        L = len(src_views)
        hd = self.embed_dims // nh
        # each level's features at the clamped reference points
        sample_grid = torch.clamp(reference_points * 2.0 - 1.0, -1.1, 1.1)
        ref_stack = torch.stack([grid_sample_points(src, sample_grid[:, :, lvl].to(src.dtype))
                                 for lvl, src in enumerate(src_views)], dim=2)  # (BV, Q, L, C)
        flat_feats = torch.cat([s.reshape(BV, -1, C) for s in src_views], dim=1)
        flat_rays = torch.cat([r.reshape(BV, -1, 3).to(flat_feats.dtype) for r in camera_rays],
                              dim=1)
        value = self.rayconv(torch.cat([flat_feats, flat_rays], dim=-1))

        mix = ref_stack + query[:, :, None, :]
        offsets = self.sampling_offsets(mix).reshape(BV, Q, nh, L, npt, 2).float()
        weights = torch.softmax(self.attention_weights(mix).reshape(BV, Q, nh, L * npt), dim=-1)
        weights = weights.reshape(BV, Q, nh, L, npt)
        shapes_wh = torch.tensor([[s.shape[2], s.shape[1]] for s in src_views],
                                 dtype=torch.float32, device=query.device)  # (L, 2) = (W, H)
        loc = (reference_points[:, :, None, :, None, :].float()
               + offsets / shapes_wh[None, None, None, :, None, :])  # (BV, Q, nh, L, npt, 2)

        out = torch.zeros((BV, Q, nh, hd), dtype=torch.float32, device=query.device)
        start = 0
        for lvl, src in enumerate(src_views):
            H, W = src.shape[1], src.shape[2]
            v = value[:, start:start + H * W].reshape(BV, H, W, nh, hd)
            start += H * W
            v = v.movedim(3, 1).reshape(BV * nh, H, W, hd)
            g = (loc[:, :, :, lvl] * 2.0 - 1.0).movedim(2, 1).reshape(BV * nh, Q * npt, 2)
            s = grid_sample_points(v, g.to(v.dtype)).reshape(BV, nh, Q, npt, hd)
            with no_autocast(query.device):
                out = out + torch.einsum("bhqpd,bqhp->bqhd", s.float(),
                                         weights[:, :, :, lvl].float())
        out = out.reshape(BV, Q, nh * hd).to(self.output_proj.weight.dtype)
        return self.output_proj(out)


class MvPDecoderLayer(nn.Module):
    """Self-attention, per-view projective attention, the masked view mean, the
    FFN and the MANO branch off the flattened queries."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_points: int = 4,
                 lin_levels: int = 1, d_ffn: int = 1024, dropout: float = 0.1,
                 num_joints: int = 21, mano_ncomps: int = 58,
                 position_range: Sequence[float] = POSITION_RANGE):
        super().__init__()
        E = embed_dims
        self.position_range = tuple(float(p) for p in position_range)
        self.self_attn = MultiheadAttention(E, num_heads, dropout)
        self.norm2 = nn.LayerNorm(E, eps=1e-5)
        self.proj_attn = ProjAttn(E, num_heads, num_points, lin_levels)
        self.norm1 = nn.LayerNorm(E, eps=1e-5)
        self.linear1 = nn.Linear(E, d_ffn)
        self.linear2 = nn.Linear(d_ffn, E)
        self.norm3 = nn.LayerNorm(E, eps=1e-5)
        self.linear_mano_1 = nn.Linear(num_joints * E, E)
        self.linear_mano_2 = nn.Linear(E, mano_ncomps)
        self.norm4 = nn.LayerNorm(mano_ncomps, eps=1e-5)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt: torch.Tensor, query_pos: torch.Tensor,
                reference_points: torch.Tensor, src_views: List[torch.Tensor],
                camera_rays: List[torch.Tensor], view_mask: torch.Tensor,
                cam_intr: torch.Tensor, cam_extr: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tgt / query_pos (B, Q, C), reference_points (B, Q, 3) in [0, 1], src_views
        and camera_rays L x (B, V, H, W, C / 3) -> (tgt, MANO parameters (B, 58))."""
        B, Q, C = tgt.shape
        V = src_views[0].shape[1]
        dev = tgt.device
        tgt = self.norm2(tgt + self.drop(self.self_attn(tgt, tgt, tgt, query_pos, query_pos)))

        with no_autocast(dev):
            pr = torch.tensor(self.position_range, dtype=torch.float32, device=dev)
            ref = reference_points.float().detach()
            ref_abs = ref[:, None].expand(B, V, Q, 3) * (pr[3:] - pr[:3]) + pr[:3]
            pts_cam = cam_extr_transf(torch.linalg.inv(cam_extr.float()), ref_abs)
            uv = cam_intr_projection(cam_intr.float(), pts_cam)  # (B, V, Q, 2)
            shapes_wh = torch.tensor([[s.shape[3], s.shape[2]] for s in src_views],
                                     dtype=torch.float32, device=dev)
            ref_lvl = uv.reshape(B * V, Q, 1, 2) * shapes_wh / (shapes_wh - 1.0)
            ref_lvl = ref_lvl / ref_lvl.max()  # over the whole batch, padded views too

        tgt_v = tgt[:, None].expand(B, V, Q, C).reshape(B * V, Q, C)
        pos_v = query_pos[:, None].expand(B, V, Q, C).reshape(B * V, Q, C)
        tgt2 = self.proj_attn(tgt_v + pos_v, ref_lvl,
                              [s.reshape((B * V,) + s.shape[2:]) for s in src_views],
                              [r.reshape((B * V,) + r.shape[2:]) for r in camera_rays])
        tgt2 = tgt2.reshape(B, V, Q, C)
        vm = view_mask[:, :, None, None].to(tgt2.dtype)
        n_valid = view_mask.to(tgt2.dtype).sum(1).clamp_min(1.0)
        tgt2 = (tgt2 * vm).sum(1) / n_valid[:, None, None]
        tgt = self.norm1(tgt + self.drop(tgt2))

        h = self.linear2(self.drop(torch.relu(self.linear1(tgt))))
        tgt = self.norm3(tgt + self.drop(h))

        m = self.drop(torch.relu(self.linear_mano_1(tgt.reshape(B, Q * C))))
        return tgt, self.norm4(self.linear_mano_2(m))


@HEAD.register_module("MVPHead")
class MVPHead(nn.Module):
    """21 joint queries -> per-layer refined joints and the MANO mesh.

    ``in_channels`` are the widths of the three deepest backbone levels, deepest
    first; ``num_views`` the views of a padded batch (the pooled reference
    feature's input is ``num_views * 3 * embed_dims`` wide; flax infers it)."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 6, num_heads: int = 8,
                 num_points: int = 4, lin_levels: int = 1, d_ffn: int = 1024,
                 num_joints: int = 21, dropout: float = 0.1, mano_pose_ncomps: int = 45,
                 center_idx: int = 0, position_range: Sequence[float] = POSITION_RANGE,
                 image_size: Tuple[int, int] = (256, 256), delayer_norm: str = "bn",
                 mano_layer: Optional[ManoLayer] = None,
                 in_channels: Sequence[int] = (512, 256, 128), num_views: int = 8):
        super().__init__()
        if mano_pose_ncomps != 45:
            raise NotImplementedError(
                "PCA pose space not supported; the reference default "
                "(MANO_POSE_NCOMPS=45) is full axis-angle")
        E = embed_dims
        self.embed_dims, self.num_layers, self.num_joints = E, num_layers, num_joints
        self.mano_pose_ncomps, self.center_idx = mano_pose_ncomps, center_idx
        self.position_range = tuple(float(p) for p in position_range)
        self.image_size = tuple(image_size)
        self.mano_layer = mano_layer if mano_layer is not None else ManoLayer(center_idx=center_idx)
        for i, cin in enumerate(in_channels):
            self.add_module(f"feat_delayer_{i}", ConvBlock(cin, E, 3, norm=delayer_norm))
        self.reference_feats = nn.Linear(num_views * len(in_channels) * E, E)
        self.tgt_pose_embedding = nn.Parameter(torch.rand(num_joints, 2 * E))
        self.reference_points = nn.Linear(E, 3)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", MvPDecoderLayer(
                E, num_heads, num_points, lin_levels, d_ffn, dropout, num_joints,
                3 + mano_pose_ncomps + 10, self.position_range))
            self.add_module(f"reg_branch_{i}_fc", nn.Linear(E, E))
            self.add_module(f"reg_branch_{i}_out", nn.Linear(E, 3))

    def forward(self, mlvl_feats: Sequence[torch.Tensor], view_mask: torch.Tensor,
                cam_intr: torch.Tensor, cam_extr: torch.Tensor) -> Dict[str, torch.Tensor]:
        """mlvl_feats: the backbone's levels finest first, (B, V, H, W, C) each
        channels-last; view_mask (B, V); cam_intr (B, V, 3, 3); cam_extr (B, V, 4, 4)
        camera -> master -> ``all_coords_preds`` (L, B, 799, 3) metres and
        ``mano_pose_shape`` (L, B, 58)."""
        B, V = mlvl_feats[0].shape[:2]
        E, Q = self.embed_dims, self.num_joints
        dev = view_mask.device
        proc = []
        for i, f in enumerate(list(mlvl_feats[::-1])[:3]):  # deepest first
            h, w = f.shape[2], f.shape[3]
            x = f.reshape(B * V, h, w, f.shape[-1]).permute(0, 3, 1, 2)
            x = getattr(self, f"feat_delayer_{i}")(x.to(self.reference_feats.weight.dtype))
            proc.append(x.permute(0, 2, 3, 1).reshape(B, V, h, w, E))

        vm = view_mask[:, :, None]
        pooled = torch.cat([p.mean(dim=(2, 3)) * vm.to(p.dtype) for p in proc], dim=-1)
        ref_feats = self.reference_feats(pooled.reshape(B, -1))[:, None, :]
        tgt_pose = torch.sigmoid(self.tgt_pose_embedding)[None].expand(B, Q, 2 * E)
        tgt, query_embed = tgt_pose[..., :E], tgt_pose[..., E:]
        reference_points = torch.sigmoid(self.reference_points(query_embed + ref_feats)).float()
        camera_rays = [get_camera_rays(self.image_size, p.shape[2], p.shape[3], cam_intr,
                                       cam_extr) for p in proc]

        inter_refs, inter_mano = [], []
        for i in range(self.num_layers):
            tgt, mano_params = getattr(self, f"layer_{i}")(
                tgt, query_embed, reference_points, proc, camera_rays, view_mask, cam_intr,
                cam_extr)
            h = torch.relu(getattr(self, f"reg_branch_{i}_fc")(tgt))
            tmp = getattr(self, f"reg_branch_{i}_out")(h)
            reference_points = torch.sigmoid(tmp.float() + inverse_sigmoid(reference_points))
            inter_refs.append(reference_points)
            inter_mano.append(mano_params.float())
        inter_refs = torch.nan_to_num(torch.stack(inter_refs))  # (L, B, 21, 3)
        inter_mano = torch.nan_to_num(torch.stack(inter_mano))  # (L, B, 58)

        n_pose = 3 + self.mano_pose_ncomps
        with no_autocast(dev):
            verts = [self.mano_layer(inter_mano[lvl, :, :n_pose], inter_mano[lvl, :, n_pose:]).verts
                     + inter_refs[lvl, :, self.center_idx][:, None]
                     for lvl in range(self.num_layers)]
            pr = torch.tensor(self.position_range, dtype=torch.float32, device=dev)
            all_coords = torch.cat([inter_refs, torch.stack(verts)], dim=-2)
        return {"all_coords_preds": all_coords * (pr[3:] - pr[:3]) + pr[:3],
                "mano_pose_shape": inter_mano}


class MVP(nn.Module):
    """Backbone + MVPHead on a padded batch (images (B, V, H, W, 3), view mask);
    ``compute_dtype`` as :class:`.petr.PETRMultiView`'s."""

    def __init__(self, backbone: nn.Module, head: MVPHead, num_joints: int = 21,
                 center_idx: int = 0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone, self.head = backbone, head
        self.num_joints, self.center_idx = num_joints, center_idx
        self.compute_dtype = compute_dtype

    def forward(self, images: torch.Tensor, view_mask: torch.Tensor, cam_intr: torch.Tensor,
                cam_extr: torch.Tensor, master_joints_3d: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        dt = self.head.reference_feats.weight.dtype
        B, V, H, W, _ = images.shape
        with maybe_autocast(images.device, self.compute_dtype, dt):
            feats = self.backbone(images.reshape(B * V, H, W, 3).to(dt).permute(0, 3, 1, 2))
            levels = [feats[f"res_layer{i}"] for i in range(1, 5)]
            levels = [f.permute(0, 2, 3, 1).reshape(B, V, f.shape[2], f.shape[3], -1)
                      for f in levels]
            preds = self.head(levels, view_mask, cam_intr, cam_extr)
        pose_shape = preds["mano_pose_shape"][-1]
        out = with_final_level(preds, self.num_joints, self.center_idx)
        out.update(pred_pose=pose_shape[:, :48].reshape(B, 16, 3), pred_shape=pose_shape[:, 48:])
        return out


def create_mvp_model(cfg: dict, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda",
                     generator: Optional[torch.Generator] = None,
                     param_dtype: Optional[torch.dtype] = None
                     ) -> Tuple[MVP, Dict[str, Any]]:
    """Build MVP from the ``MODEL`` section of a config (``BACKBONE`` a ResNet;
    ``HEAD.EMBED_DIMS`` and optionally ``NUM_PREDS`` 6, ``NUM_HEADS`` 8,
    ``NUM_POINTS`` 4, ``DIM_FEEDFORWARD`` 4 x embed, ``DROPOUT`` 0.1,
    ``POSITION_RANGE``, ``IMAGE_SIZE`` 256, ``CAMERA_NUM`` 8: the padded view
    count, which fixes the pooled reference feature's width). The sampling
    offsets start at the flax initialisers' compass bias. Arguments and return
    as :func:`.petr.create_petr_model`'s."""
    head_cfg = cfg["HEAD"]
    num_joints, center_idx = data_preset(cfg)
    E = head_cfg["EMBED_DIMS"]
    mano = ManoLayer(center_idx=center_idx)  # numpy-backed constants: not on the meta device
    image_size = head_cfg.get("IMAGE_SIZE", (256, 256))
    if isinstance(image_size, int):
        image_size = (image_size, image_size)

    def make(compute_dtype):
        backbone = ResNet.from_config(cfg["BACKBONE"])
        head = MVPHead(
            embed_dims=E, num_layers=head_cfg.get("NUM_PREDS", 6),
            num_heads=head_cfg.get("NUM_HEADS", 8), num_points=head_cfg.get("NUM_POINTS", 4),
            d_ffn=head_cfg.get("DIM_FEEDFORWARD", 4 * E), dropout=head_cfg.get("DROPOUT", 0.1),
            center_idx=center_idx,
            position_range=tuple(head_cfg.get("POSITION_RANGE", POSITION_RANGE)),
            image_size=tuple(image_size), mano_layer=mano,
            in_channels=backbone.feat_size[:3], num_views=head_cfg.get("CAMERA_NUM", 8))
        return MVP(backbone, head, num_joints, center_idx, compute_dtype)

    model = build_baseline(make, "create_mvp_model", dtype, device, generator, param_dtype)
    for m in model.modules():
        if isinstance(m, ProjAttn):
            m.reset_offsets()
    model = model.to(device=device, dtype=param_dtype or dtype).eval()
    return model, {"mano_layer": ManoLayer(center_idx=None)}


MODEL.register_module("MVP")(create_mvp_model)
