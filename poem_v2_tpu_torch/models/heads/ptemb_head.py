"""POEM generalized head
(counterpart of ``poem_v2_tpu/models/heads/ptemb_head.py``).

The 4096-point BPS cloud around reference joint 9 is projected into every
view, sampled from the positional-encoded feature maps (kernel K4 in eval;
in training the differentiable interpolation-matrix sampler, with the grid
and the weights in the compute dtype, as the JAX head trains), reordered by
the reference's ``.view(1, -1, V, C)`` scramble (a reshape when every sample
has all its views; else kernel K5 in eval and the plain row gather in
training), merged across views, and decoded by the point-embedded decoder.
With ``parametric_output`` the final block's coordinates are replaced by
the MANO surface of the regressed pose and shape. ``decoder_type``
"PtEmbedTRv3" decodes with the METRO + point-transformer decoder instead
(``models/decoder_v3.py``; no parametric output), and ``petr_embedding``
adds the camera-frustum embedding (``models/frustum.py``) onto the sine one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...geometry.camera import project_world_to_pixel
from ...geometry.rotations import rot6d_to_aa
from ...ops.bilinear import grid_sample_points
from ...ops.sampling import grid_sample_points_matmul, pixel_to_grid
from ...ops.scramble import plain_scrambled_merge_gather, scrambled_merge_gather
from ..bricks.attention import MLP
from ..decoder import PtEmbedDecoder
from ..frustum import FrustumPositionEncoder
from ..positional import sine_positional_encoding_3d_factors
from ...utils.profiling import span, sync_point


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype matrix products take here: autocast's where it is on, else t's."""
    dev = t.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else t.dtype


class AdaptPos3D(nn.Module):
    """The adapt_pos3d 1x1 conv applied to the three sine factors separately:
    conv(concat(n, y, x)) = n @ K_n + y @ K_y + x @ K_x + bias."""

    def __init__(self, embed_dims: int, num_feats: int):
        super().__init__()
        self.num_feats = num_feats
        self.weight = nn.Parameter(torch.empty(embed_dims, 3 * num_feats, 1, 1))
        self.bias = nn.Parameter(torch.zeros(embed_dims))

    def forward(self, pos_n, pos_y, pos_x):
        F_ = self.num_feats
        k = self.weight[:, :, 0, 0].t()  # (3F, C)
        dt = k.dtype
        pn = (pos_n.to(dt) @ k[:F_])[:, :, None, None]
        py = (pos_y.to(dt) @ k[F_:2 * F_])[:, :, :, None]
        px = (pos_x.to(dt) @ k[2 * F_:])[:, :, None, :]
        return pn + py + px + self.bias


def generate_bps_basis(n_points: int = 4096, radius: float = 0.1, seed: int = 77) -> np.ndarray:
    """Uniform sample inside a 3-ball of ``radius`` metres, (N, 3) float32."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n_points, 3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = rs.rand(n_points, 1) ** (1.0 / 3.0)
    return (x * r * radius).astype(np.float32)


class MergeFeaturesMV(nn.Module):
    """Masked master-query cross-view merge (view 0 is the master)."""

    def __init__(self, embed_dims: int = 256):
        super().__init__()
        self.merge_net_0 = MLP(embed_dims, embed_dims, embed_dims // 2)
        self.merge_net_1 = MLP(embed_dims // 2, embed_dims // 2, embed_dims)

    def forward(self, feats: torch.Tensor, view_mask: torch.Tensor) -> torch.Tensor:
        """feats (B, V, N, C), view_mask (B, V) -> (B, N, C)."""
        q = feats.transpose(1, 2)
        q1 = q[:, :, 0]
        qm = self.merge_net_0(q)
        master, others = qm[:, :, 0], qm[:, :, 1:]
        others_mask = view_mask[:, 1:].to(feats.dtype)
        score = torch.einsum("bnvc,bnc->bnv", others, master) * others_mask[:, None, :]
        agg = torch.einsum("bnv,bnvc->bnc", score, others * others_mask[:, None, :, None])
        n_views = view_mask.to(feats.dtype).sum(1)
        mv = q1 + self.merge_net_1(agg) / torch.clamp_min(n_views, 1.0)[:, None, None]
        sv = q1 + self.merge_net_1(self.merge_net_0(q1))
        return torch.where((n_views <= 1.0)[:, None, None], sv, mv)


def scramble_views(a_flat: torch.Tensor, n_val: torch.Tensor, fused: bool = False
                   ) -> torch.Tensor:
    """The reference's merge-input scramble: (B, V, C, NS) sampled features ->
    (B, NS, V, C) with scr[b, i, j] = the C-run at (i * n_b + j) * C of the
    sample's flat (V, C, NS) layout. A batch whose samples all use V views
    is a plain reshape; a mixed batch gathers the rows (rows j >= n_b alias
    later data and are masked out by the merge): with ``fused`` (eval) by
    kernel K5 on the card, else by the differentiable plain gather."""
    B, V, C, NS = a_flat.shape
    with sync_point("scramble_check", n_val.device):  # a read of a device value
        uniform = bool((n_val == V).all())
    if uniform:
        return a_flat.reshape(B, NS, V, C)
    gather = scrambled_merge_gather if fused else plain_scrambled_merge_gather
    return gather(a_flat.reshape(B, V * NS * C), n_val, V, C)


class POEMGeneralizedHead(nn.Module):
    """BPS feature fusion + point-embedded decoder; static geometry passed as numpy."""

    def __init__(self, embed_dims: int = 256, pt_feat_dim: int = 256, in_channels: int = 128,
                 num_query: int = 799, nsample: int = 4096, radius: float = 0.1,
                 pe_num_feats: int = 128, center_idx: int = 9,
                 bps_basis: Optional[np.ndarray] = None,
                 template_mesh: Optional[np.ndarray] = None,
                 query_anchor_idx: Optional[np.ndarray] = None,
                 pt_anchor_idx: Optional[np.ndarray] = None,
                 anchor_xyz: Optional[np.ndarray] = None,
                 n_blocks: int = 3, num_heads: int = 4, n_neighbor: int = 32,
                 n_neighbor_query: int = 32, dropout: float = 0.1,
                 parametric_output: bool = False, mano_layer=None, use_flash_train: bool = True,
                 petr_embedding: bool = False, depth_num: int = 32, depth_start: float = 0.0,
                 depth_end: float = 1.2, lid: bool = False,
                 position_range: Tuple[float, ...] = (-0.6, -0.6, 0.0, 0.6, 0.6, 1.2),
                 decoder_type: str = "PtEmbedTR"):
        super().__init__()
        if parametric_output and mano_layer is None:
            raise ValueError("parametric_output needs the MANO layer")
        if decoder_type not in ("PtEmbedTR", "PtEmbedTRv3"):
            raise ValueError(f"unknown decoder_type {decoder_type!r}")
        if decoder_type == "PtEmbedTRv3" and parametric_output:
            raise ValueError("PtEmbedTRv3 has no parametric (MANO) output branch")
        self.decoder_type = decoder_type
        self.parametric_output, self.mano_layer = parametric_output, mano_layer
        self.embed_dims, self.nsample, self.radius = embed_dims, nsample, radius
        self.pe_num_feats, self.center_idx = pe_num_feats, center_idx
        self.input_proj = nn.Conv2d(in_channels, embed_dims, 1)
        self.adapt_pos3d = AdaptPos3D(embed_dims, pe_num_feats)
        self.merge_feature = MergeFeaturesMV(embed_dims)
        if petr_embedding:
            # the ptEmb position_encoder hides at embed_dims * 2
            self.position_encoder = FrustumPositionEncoder(
                embed_dims, depth_num, depth_start, depth_end, lid, position_range, hidden_mult=2)
        self.petr_embedding = petr_embedding
        self.query_feat_embedding = nn.Parameter(torch.empty(num_query, pt_feat_dim))
        if decoder_type == "PtEmbedTRv3":
            from ..decoder_v3 import PtEmbedTRv3  # local: that module imports this one

            self.transformer = PtEmbedTRv3(
                feat_dim=pt_feat_dim, pt_n_blocks=n_blocks, pt_n_neighbor=n_neighbor,
                pt_n_neighbor_query=n_neighbor_query, dropout=dropout,
                max_positions=num_query + nsample, map_dim=embed_dims,
                use_fused_knn_train=use_flash_train)
        else:
            self.transformer = PtEmbedDecoder(n_blocks, pt_feat_dim, num_heads, n_neighbor,
                                              n_neighbor_query, dropout, parametric_output,
                                              num_query, use_flash_train)
        # float32 geometry constants, kept out of the state dict and of dtype casts
        self._np_consts = {
            "bps": np.asarray(bps_basis, np.float32),
            "template": np.asarray(template_mesh, np.float32),
            "q_anchor_idx": np.asarray(query_anchor_idx, np.int64),
            "pt_anchor_idx": np.asarray(pt_anchor_idx, np.int64),
        }
        if anchor_xyz is not None:
            self._np_consts["anchor_xyz"] = np.asarray(anchor_xyz, np.float32)
        self._consts: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def consts(self, device: torch.device) -> Dict[str, torch.Tensor]:
        if device not in self._consts:
            self._consts[device] = {k: torch.as_tensor(v, device=device)
                                    for k, v in self._np_consts.items()}
        return self._consts[device]

    def forward(self, mlvl_feat: torch.Tensor, view_mask: torch.Tensor, cam_intr: torch.Tensor,
                cam_extr: torch.Tensor, ref_joints: torch.Tensor,
                inp_res: Tuple[int, int] = (256, 256)) -> Dict[str, torch.Tensor]:
        """mlvl_feat (B, V, H, W, C_in) channels-last -> {"all_coords_preds":
        (n_blocks, B, 799, 3), with PtEmbedTRv3 (1 + n_blocks, B, 799, 3)}, with
        ``parametric_output`` also "pred_pose" (B, 16, 3) axis-angle and
        "pred_shape" (B, 10)."""
        B, V, H, W, _ = mlvl_feat.shape
        C, NS = self.embed_dims, self.nsample
        c = self.consts(mlvl_feat.device)
        dt = self.input_proj.weight.dtype

        with span("embed"):
            w = self.input_proj.weight[:, :, 0, 0]
            x = torch.nn.functional.linear(mlvl_feat.to(dt), w, self.input_proj.bias)
            sin = self.adapt_pos3d(*sine_positional_encoding_3d_factors(
                view_mask, H, W, num_feats=self.pe_num_feats))
            if self.petr_embedding:
                sin = sin + self.position_encoder(cam_intr, cam_extr, (H, W), inp_res)[0]
            x = x + sin

        with span("sample"):
            ref_center = ref_joints[:, self.center_idx].float()
            bps_world = c["bps"][None] + ref_center[:, None]
            proj = project_world_to_pixel(bps_world, cam_extr.float(), cam_intr.float())
            grid = pixel_to_grid(proj, inp_res).reshape(B * V, NS, 2)
            if self.training:
                cdt = _compute_dtype(x)
                feats_flat = grid_sample_points_matmul(x.reshape(B * V, H, W, C).to(cdt),
                                                       grid.to(cdt))
            else:
                feats_flat = grid_sample_points(x.reshape(B * V, H, W, C), grid)
            bps_feats = feats_flat.reshape(B, V, NS, C)
        n_val = view_mask.to(torch.int64).sum(1)
        scr = scramble_views(bps_feats.transpose(2, 3), n_val, fused=not self.training)
        with span("merge"):
            merged = self.merge_feature(scr.transpose(1, 2), view_mask)

        with span("decoder"):
            query_feat = self.query_feat_embedding[None].expand(B, -1, -1)
            pt_xyz = (c["bps"] / self.radius)[None].expand(B, NS, 3)
            query_xyz = (c["template"] / self.radius)[None].expand(B, -1, 3)
            if self.decoder_type == "PtEmbedTRv3":
                coords = self.transformer(pt_xyz, merged, query_xyz, query_feat, x, view_mask,
                                          cam_intr, cam_extr, ref_center, self.radius, inp_res)
                coords = torch.nan_to_num(coords.float())
                return {"all_coords_preds": coords * self.radius + ref_center[None, :, None, :]}
            coords, pose6d, shape = self.transformer(
                query_xyz, query_feat, pt_xyz, merged, c["q_anchor_idx"], c["pt_anchor_idx"],
                c.get("anchor_xyz"))
            coords = torch.nan_to_num(coords.float())
            centre = ref_center[None, :, None, :]
            if not self.parametric_output:
                return {"all_coords_preds": coords * self.radius + centre}
            # intermediate blocks are normalised; the final block is replaced by the
            # MANO surface (metres, centred at the reference joint) plus the centre.
            # Rotations and LBS stay float32, outside any autocast
            with torch.autocast(mlvl_feat.device.type, enabled=False):
                pose_aa = rot6d_to_aa(pose6d.float().reshape(B, 16, 6)).reshape(B, 48)
                mano_out = self.mano_layer(pose_aa, shape.float())
            mano_mesh = torch.cat([mano_out.joints, mano_out.verts], dim=1)  # (B, 799, 3)
            all_coords = torch.cat([coords[:-1] * self.radius + centre, mano_mesh[None] + centre],
                                   0)
            return {"all_coords_preds": all_coords, "pred_pose": pose_aa.reshape(B, 16, 3),
                    "pred_shape": shape.float()}
