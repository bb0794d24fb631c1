"""PtEmbedTRv3, the METRO + point-transformer decoder
(counterpart of ``poem_v2_tpu/models/decoder_v3.py``).

A METRO stage (three BERT encoder blocks over the (xyz ‖ feature) tokens of
the 799 template points and the N BPS points) regresses a coarse 799-point
mesh; the coarse mesh is projected into every view and its features are
sampled from the positional-encoded maps (the interpolation-matrix sampler,
its grid in the features' dtype, as the JAX decoder casts it) and merged
across views; PtEmbedTRv2 then refines it in normalised space. On the card
the METRO stage's attention runs K3 in eval (12 launches at the default
depth) and the einsum path in training; the refinement runs K1 in eval and
K6 in training.

Spans (``utils/profiling.py``, under the head's ``decoder``): ``metro`` (the
METRO stage, which also counts ``metro_tokens``, the tokens it attends over in
the request), ``coarse_sample`` (the projection, the sampler and the merge) and
``refine`` (PtEmbedTRv2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..geometry.camera import project_world_to_pixel
from ..ops.sampling import grid_sample_points_matmul, pixel_to_grid
from ..utils.profiling import count, span
from .decoder_v2 import PtEmbedTRv2
from .heads.ptemb_head import MergeFeaturesMV, _compute_dtype
from .metro import METROEncoderBlock


class PtEmbedTRv3(nn.Module):
    def __init__(self, feat_dim: int = 256, vt_hidden_dims: Sequence[int] = (1024, 256, 64),
                 vt_output_dims: Sequence[int] = (512, 128, 3), vt_num_layers: int = 4,
                 vt_num_heads: int = 4, pt_n_blocks: int = 3, pt_n_neighbor: int = 16,
                 pt_n_neighbor_query: int = 16, dropout: float = 0.1,
                 max_positions: int = 799 + 4096, map_dim: Optional[int] = None,
                 use_fused_knn: bool = True, use_fused_knn_train: bool = True):
        """``feat_dim``: the query and cloud features' width; ``map_dim`` (default
        ``feat_dim``): the feature maps' width, that of the merge and the
        refinement; ``max_positions``: the token count (queries + cloud points)."""
        super().__init__()
        map_dim = map_dim or feat_dim
        in_dims = (3 + feat_dim,) + tuple(vt_output_dims[:-1])
        self.n_metro = len(vt_hidden_dims)
        for i, (d_in, h, o) in enumerate(zip(in_dims, vt_hidden_dims, vt_output_dims)):
            self.add_module(f"metro_block_{i}", METROEncoderBlock(
                d_in, h, o, vt_num_layers, vt_num_heads, dropout, max_positions))
        self.merge_branch = MergeFeaturesMV(map_dim)
        self.point_transformer = PtEmbedTRv2(
            n_blocks=pt_n_blocks, n_neighbor=pt_n_neighbor, n_neighbor_query=pt_n_neighbor_query,
            feat_dim=map_dim, transformer_dim=map_dim, use_fused_knn=use_fused_knn,
            use_fused_knn_train=use_fused_knn_train)

    def forward(self, pt_xyz: torch.Tensor, pt_feats: torch.Tensor, query_xyz: torch.Tensor,
                query_feat: torch.Tensor, feature_map: torch.Tensor, view_mask: torch.Tensor,
                cam_intr: torch.Tensor, cam_extr: torch.Tensor, ref_center: torch.Tensor,
                radius: float, inp_res: Tuple[int, int] = (256, 256)) -> torch.Tensor:
        """pt_xyz (B, N, 3) the normalised cloud, pt_feats (B, N, F), query_xyz (B, 799, 3)
        the normalised template, query_feat (B, 799, F), feature_map (B, V, H, W, F)
        positional-encoded, view_mask (B, V), cameras, ref_center (B, 3) metres.
        Returns (1 + pt_n_blocks, B, 799, 3): the coarse mesh, then each refinement."""
        B, V, H, W, F_ = feature_map.shape
        nq = query_xyz.shape[1]
        cdt = _compute_dtype(query_feat)
        tokens = torch.cat([torch.cat([query_xyz.to(cdt), query_feat.to(cdt)], -1),
                            torch.cat([pt_xyz.to(cdt), pt_feats.to(cdt)], -1)], dim=1)
        with span("metro"):
            count("metro_tokens", B * tokens.shape[1])
            x = tokens
            for i in range(self.n_metro):
                x = getattr(self, f"metro_block_{i}")(x)
            pred_metro = x[:, :nq].float()

        with span("coarse_sample"):
            pred_world = pred_metro * radius + ref_center[:, None]
            proj = project_world_to_pixel(pred_world, cam_extr.float(), cam_intr.float())
            grid = pixel_to_grid(proj, inp_res)
            fdt = _compute_dtype(feature_map)
            sampled = grid_sample_points_matmul(
                feature_map.reshape(B * V, H, W, F_).to(fdt), grid.reshape(B * V, nq, 2).to(fdt)
            ).reshape(B, V, nq, F_)
            query_feat2 = self.merge_branch(sampled, view_mask)
        with span("refine"):
            refined = self.point_transformer(pt_xyz, pt_feats, pred_metro, query_feat=query_feat2)
        return torch.cat([pred_metro[None], refined], dim=0)
