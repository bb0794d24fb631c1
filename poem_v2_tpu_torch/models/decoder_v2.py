"""PtEmbedTRv2, the point-transformer decoder (counterpart of
``poem_v2_tpu/models/decoder_v2.py``).

A KNN self-attention over the sampled cloud, then N blocks, each a query
KNN self-attention, a query KNN cross-attention into the cloud and a Δxyz
regression; returns every block's coordinates. The second half of
PtEmbedTRv3 and the decoder of the v1 heads. The blocks are the port's
vector-attention bricks with the flagship decoder's flags: on the card K1 in
eval, K6 (backward K6b, then K7) in training. They select exactly; the JAX
blocks' ``approx_max_k`` is exact ``top_k`` on the CPU, and the port has no
approximate path.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ..geometry.camera import inverse_sigmoid
from .bricks.attention import MLP
from .bricks.point_transformer import PtCrossAttnBlock, PtSelfAttnBlock


class PtEmbedTRv2(nn.Module):
    def __init__(self, n_blocks: int = 6, n_neighbor: int = 16, n_neighbor_query: int = 16,
                 feat_dim: int = 256, transformer_dim: int = 256, with_point_embed: bool = True,
                 predict_inv_sigmoid: bool = False, use_fused_knn: bool = True,
                 use_fused_knn_train: bool = True):
        super().__init__()
        self.n_blocks = n_blocks
        self.with_point_embed, self.predict_inv_sigmoid = with_point_embed, predict_inv_sigmoid
        flags = dict(use_fused_knn=use_fused_knn, use_fused_knn_train=use_fused_knn_train)
        self.feats_self_attn = PtSelfAttnBlock(feat_dim, transformer_dim, n_neighbor, **flags)
        for i in range(n_blocks):
            self.add_module(f"query_self_attn_{i}", PtSelfAttnBlock(
                feat_dim, transformer_dim, n_neighbor_query, **flags))
            self.add_module(f"query_cross_attn_{i}", PtCrossAttnBlock(
                feat_dim, transformer_dim, n_neighbor, d_cloud=feat_dim, **flags))
            self.add_module(f"reg_branch_{i}", MLP(feat_dim, feat_dim, 3))

    @classmethod
    def from_config(cls, cfg: Mapping, **flags) -> "PtEmbedTRv2":
        return cls(n_blocks=cfg["N_BLOCKS"], n_neighbor=cfg["N_NEIGHBOR"],
                   n_neighbor_query=cfg["N_NEIGHBOR_QUERY"], feat_dim=cfg["POINTS_FEAT_DIM"],
                   transformer_dim=cfg["TRANSFORMER_DIM"],
                   with_point_embed=cfg.get("WITH_POSI_EMBED", True),
                   predict_inv_sigmoid=cfg.get("PREDICT_INV_SIGMOID", False), **flags)

    def forward(self, pt_xyz: torch.Tensor, pt_feats: torch.Tensor, query_xyz: torch.Tensor,
                query_feat: Optional[torch.Tensor] = None, pt_embed: Optional[torch.Tensor] = None,
                query_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pt_xyz (B, N, 3), pt_feats (B, N, F), query_xyz (B, M, 3) float32; query
        features ``query_feat`` and / or ``query_emb`` (B, M, F), added; ``pt_embed``
        (B, N, F) added onto the cloud's features with ``with_point_embed``.
        Returns the blocks' coordinates (n_blocks, B, M, 3)."""
        if pt_embed is not None and self.with_point_embed:
            pt_feats = pt_feats + pt_embed
        if query_feat is None:
            query_feats = query_emb
        else:
            query_feats = query_feat if query_emb is None else query_feat + query_emb
        pt_feats = self.feats_self_attn(pt_xyz, pt_feats)
        coords = []
        for i in range(self.n_blocks):
            query_feats = getattr(self, f"query_self_attn_{i}")(query_xyz, query_feats)
            query_feats = getattr(self, f"query_cross_attn_{i}")(pt_xyz, pt_feats, query_xyz,
                                                                  query_feats)
            delta = getattr(self, f"reg_branch_{i}")(query_feats)
            if self.predict_inv_sigmoid:
                query_xyz = torch.sigmoid(delta.float() + inverse_sigmoid(query_xyz))
            else:
                query_xyz = query_xyz + delta.to(query_xyz.dtype)
            coords.append(query_xyz)
        return torch.stack(coords, dim=0)
