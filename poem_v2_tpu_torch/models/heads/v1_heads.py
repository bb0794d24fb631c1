"""The POEM v1 heads (counterpart of ``poem_v2_tpu/models/heads/v1_heads.py``).

* :class:`POEMPositionEmbeddedAggregationHead` (the reference's "ptemb" head):
  ball-query ``nsample`` frustum points around the reference mesh's centroid,
  take their features out of the positional-encoded feature volume, and decode
  with PtEmbedTRv2 in position-range-normalised space.
* :class:`POEMProjectiveSelfAggregationHead` (the reference's "proj_selfagg"
  head): ball-query points, project them into every view, sample bilinearly,
  merge across views (master attention or a masked sum), and decode.

Both mask padded views' frustum points out of the ball query by moving them
1e6 m away. The ball query, the projections and the 4-tap sampler are plain
PyTorch on every device (XLA in the JAX package); the decoder's vector
attention runs K1 on the card in eval, K6 in training.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...geometry.camera import project_world_to_pixel
from ...ops.points import ball_query, index_points
from ...ops.sampling import grid_sample_points, pixel_to_grid
from ..bricks.attention import MLP
from ..decoder_v2 import PtEmbedTRv2
from ..frustum import FrustumPositionEncoder
from ..positional import pos2posemb3d, sine_positional_encoding_3d
from .ptemb_head import MergeFeaturesMV, _compute_dtype

QUERY_TYPES = ("POEM", "KPT", "MVP", "METRO")


def normalize_by_range(x: torch.Tensor, position_range: Sequence[float]) -> torch.Tensor:
    pr = torch.tensor(position_range, dtype=x.dtype, device=x.device)
    return (x - pr[:3]) / (pr[3:] - pr[:3])


def denormalize_by_range(x: torch.Tensor, position_range: Sequence[float]) -> torch.Tensor:
    pr = torch.tensor(position_range, dtype=x.dtype, device=x.device)
    return x * (pr[3:] - pr[:3]) + pr[:3]


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution on channels-last x (..., C_in)."""
    w = conv.weight
    return nn.functional.linear(x.to(w.dtype), w[:, :, 0, 0], conv.bias)


class CenterShift(nn.Module):
    """centroid + 0.01 * an MLP over the query axis."""

    def __init__(self, num_query: int = 799):
        super().__init__()
        self.center_shift = MLP(num_query, num_query, 1)

    def forward(self, reference_points: torch.Tensor) -> torch.Tensor:
        centre = reference_points.mean(1, keepdim=True)
        shift = self.center_shift(reference_points.transpose(1, 2))  # (B, 3, 1)
        return centre + 0.01 * shift.transpose(1, 2)


class _V1Base(nn.Module):
    def __init__(self, embed_dims: int = 256, pt_feat_dim: int = 256, in_channels: int = 128,
                 num_query: int = 799, nsample: int = 2048, radius: float = 0.2,
                 depth_num: int = 32, depth_start: float = 0.0, depth_end: float = 1.2,
                 lid: bool = False,
                 position_range: Tuple[float, ...] = (-0.6, -0.6, 0.0, 0.6, 0.6, 1.2),
                 pe_num_feats: int = 128, center_shift: bool = False, n_blocks: int = 6,
                 n_neighbor: int = 16, n_neighbor_query: int = 16, use_fused_knn: bool = True,
                 use_fused_knn_train: bool = True):
        super().__init__()
        self.embed_dims, self.pt_feat_dim, self.num_query = embed_dims, pt_feat_dim, num_query
        self.nsample, self.radius, self.depth_num = nsample, radius, depth_num
        self.position_range = tuple(float(p) for p in position_range)
        self.pe_num_feats = pe_num_feats
        self.input_proj = nn.Conv2d(in_channels, embed_dims, 1)
        self.adapt_pos3d = nn.Conv2d(3 * pe_num_feats, embed_dims, 1)
        self.position_encoder = FrustumPositionEncoder(
            embed_dims, depth_num, depth_start, depth_end, lid, position_range)
        if center_shift:
            self.CenterShift_0 = CenterShift(num_query)
        self.center_shift = center_shift
        self.transformer = PtEmbedTRv2(n_blocks, n_neighbor, n_neighbor_query, pt_feat_dim,
                                       pt_feat_dim, use_fused_knn=use_fused_knn,
                                       use_fused_knn_train=use_fused_knn_train)

    def _encode_features(self, mlvl_feat, view_mask, cam_intr, cam_extr, inp_res):
        """input_proj + sine PE + frustum PE: (x + posi, posi, frustum points)."""
        B, V, H, W, _ = mlvl_feat.shape
        x = _conv1x1(self.input_proj, mlvl_feat)
        sin = _conv1x1(self.adapt_pos3d, sine_positional_encoding_3d(
            view_mask, H, W, num_feats=self.pe_num_feats))
        coords_embed, coords3d_abs, _ = self.position_encoder(cam_intr, cam_extr, (H, W),
                                                              inp_res)
        posi = sin + coords_embed
        return x + posi, posi, coords3d_abs

    def _centre(self, reference_points):
        if self.center_shift:
            return self.CenterShift_0(reference_points)
        return reference_points.mean(1, keepdim=True)

    def _ball_points(self, coords3d_abs, view_mask, centre, generator):
        """The ball query over the valid views' frustum points: (idx (B, nsample), xyz)."""
        B, V = view_mask.shape
        pts = coords3d_abs.reshape(B, -1, 3)
        vm = view_mask.repeat_interleave(pts.shape[1] // V, dim=1)
        pts = torch.where(vm[..., None], pts, 1e6)
        idx, xyz = ball_query(centre.float(), pts, self.nsample, self.radius, generator)
        return idx[:, 0], xyz[:, 0]

    def _decode(self, pt_xyz, pt_feats, ref_norm, **kw) -> Dict[str, torch.Tensor]:
        coords = self.transformer(normalize_by_range(pt_xyz, self.position_range), pt_feats,
                                  ref_norm, **kw)
        coords = torch.nan_to_num(coords.float())
        return {"all_coords_preds": denormalize_by_range(coords, self.position_range)}


class POEMPositionEmbeddedAggregationHead(_V1Base):
    def __init__(self, **kw):
        super().__init__(**kw)
        E, D = self.embed_dims, self.depth_num
        self.transition_up = nn.Linear(E // D, self.pt_feat_dim)
        self.reference_embed = nn.Parameter(torch.rand(self.num_query, 3))
        self.query_embedding = MLP(3 * (E // 2) + 6, E, self.pt_feat_dim)

    def forward(self, mlvl_feat: torch.Tensor, view_mask: torch.Tensor, cam_intr: torch.Tensor,
                cam_extr: torch.Tensor, reference_points: torch.Tensor,
                template_mesh: torch.Tensor, inp_res: Tuple[int, int] = (256, 256),
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """mlvl_feat (B, V, H, W, C_in) channels-last, reference_points (B, 799, 3) in
        the master frame, template_mesh (799, 3); ``generator`` draws the ball
        query's random hits (None: the nearest). -> {"all_coords_preds"
        (n_blocks, B, 799, 3)}."""
        B, V, H, W, _ = mlvl_feat.shape
        x, _, coords3d_abs = self._encode_features(mlvl_feat, view_mask, cam_intr, cam_extr,
                                                   inp_res)
        centre = self._centre(reference_points)
        # the feature volume: channel f * D + d of the map is point d's feature f
        D = self.depth_num
        f_init = self.embed_dims // D
        feats = x.reshape(B, V, H, W, f_init, D).permute(0, 1, 3, 2, 5, 4)
        feats = feats.reshape(B, -1, f_init).float()
        idx, pt_xyz = self._ball_points(coords3d_abs, view_mask, centre, generator)
        pt_feats = index_points(feats, idx.clamp_min(0))
        pt_feats = self.transition_up(pt_feats.to(self.transition_up.weight.dtype))

        ref_emb = pos2posemb3d(self.reference_embed.float(), num_pos_feats=self.embed_dims // 2)
        ref_norm = normalize_by_range(reference_points.float(), self.position_range)
        template = template_mesh.float()[None].expand(B, -1, 3)
        query_in = torch.cat([ref_emb[None].expand(B, -1, -1), ref_norm, template], dim=-1)
        query_embeds = self.query_embedding(query_in.to(self.transition_up.weight.dtype))
        return self._decode(pt_xyz, pt_feats, ref_norm, query_emb=query_embeds)


class POEMProjectiveSelfAggregationHead(_V1Base):
    def __init__(self, merge_mode: str = "attn", query_type: str = "KPT",
                 global_feat_dim: Optional[int] = None, **kw):
        """``global_feat_dim``: the width of the per-view global features the
        ``MVP`` and ``METRO`` query types need (their ``layer_global_feat``)."""
        super().__init__(**kw)
        if merge_mode not in ("attn", "sum"):
            raise ValueError(f"unknown merge_mode {merge_mode!r}")
        if query_type not in QUERY_TYPES:
            raise ValueError(f"unknown query_type {query_type!r}")
        if query_type in ("MVP", "METRO") and global_feat_dim is None:
            raise ValueError(f"query_type {query_type} needs global_feat_dim")
        self.merge_mode, self.query_type = merge_mode, query_type
        E = self.embed_dims
        if merge_mode == "attn":
            self.merge_feature = MergeFeaturesMV(E)
        self.reference_embed = nn.Parameter(torch.rand(self.num_query, E))
        if global_feat_dim is not None and query_type != "KPT":
            self.layer_global_feat = nn.Linear(global_feat_dim, E)
        q_in = {"POEM": E + 6, "KPT": E, "MVP": E, "METRO": E + 3}[query_type]
        self.query_embedding = MLP(q_in, E, self.pt_feat_dim)

    def forward(self, mlvl_feat: torch.Tensor, view_mask: torch.Tensor, cam_intr: torch.Tensor,
                cam_extr: torch.Tensor, reference_points: torch.Tensor,
                template_mesh: torch.Tensor, inp_res: Tuple[int, int] = (256, 256),
                global_feat: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """As the other v1 head, with ``global_feat`` (B, V, global_feat_dim) for the
        ``MVP`` / ``METRO`` query types."""
        B, V, H, W, _ = mlvl_feat.shape
        E = self.embed_dims
        x, posi_embed, coords3d_abs = self._encode_features(mlvl_feat, view_mask, cam_intr,
                                                            cam_extr, inp_res)
        centre = self._centre(reference_points)
        _, pt_xyz = self._ball_points(coords3d_abs, view_mask, centre, generator)
        intr, extr = cam_intr.float(), cam_extr.float()
        fdt = _compute_dtype(x)

        def sample(fmap, points):  # (B, N, 3) -> (B, V, N, E)
            grid = pixel_to_grid(project_world_to_pixel(points, extr, intr), inp_res)
            flat = grid_sample_points(fmap.reshape(B * V, H, W, E).to(fdt),
                                      grid.reshape(B * V, points.shape[1], 2).to(fdt))
            return flat.reshape(B, V, points.shape[1], E)

        pt_sampled = sample(x, pt_xyz)
        query_sampled = sample(x, reference_points.float())
        m = view_mask[:, :, None, None].to(fdt)
        if self.merge_mode == "attn":
            pt_feats = self.merge_feature(pt_sampled, view_mask)
            query_feat = self.merge_feature(query_sampled, view_mask)
        else:
            pt_feats, query_feat = (pt_sampled * m).sum(1), (query_sampled * m).sum(1)
        # the sampled points' positional embedding, summed over the valid views
        pt_embed = (sample(posi_embed, pt_xyz) * m).sum(1)

        ref_emb = self.reference_embed[None].expand(B, -1, -1)
        ref_norm = normalize_by_range(reference_points.float(), self.position_range)
        template = template_mesh.float()[None].expand(B, -1, 3)
        g = None
        if global_feat is not None and self.query_type != "KPT":
            g = self.layer_global_feat(global_feat.to(self.layer_global_feat.weight.dtype))
            g = (g * view_mask[..., None].to(g.dtype)).sum(1)[:, None].expand(B, self.num_query, E)
        if self.query_type in ("MVP", "METRO") and g is None:
            raise ValueError(f"query_type {self.query_type} needs global_feat")
        query_in = {"POEM": lambda: torch.cat([ref_emb.float(), ref_norm, template], -1),
                    "KPT": lambda: ref_emb,
                    "MVP": lambda: g + ref_emb,
                    "METRO": lambda: torch.cat([g.float(), template], -1)}[self.query_type]()
        w = self.query_embedding.Dense_0.weight
        query_embeds = self.query_embedding(query_in.to(w.dtype))
        return self._decode(pt_xyz, pt_feats, ref_norm, query_feat=query_feat,
                            pt_embed=pt_embed, query_emb=query_embeds)
