"""Point-embedded transformer decoder (counterpart of ``poem_v2_tpu/models/decoder.py``).

Each block: shared Linear embedding (+ dropout) of queries and BPS
features, two BERT cross-attentions into the BPS features, the pointer
layer (KNN self- and cross- vector attention, Δxyz head), a gelu FFN.
Block 0 uses 32 fixed anchors in place of KNN. Non-parametric output only.

Training mode (``module.train()``) turns the dropout on and, with grad
enabled, runs each block under ``torch.utils.checkpoint``: the backward
recomputes the block, except the kernels' outputs (the dense attention
outputs, K6's outputs and neighbour indices), which are kept from the
forward as the JAX ``save_only_these_names`` policy keeps them
(:mod:`poem_v2_tpu_torch.ops.remat`), so no kernel runs twice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.remat import KernelOutputStore
from .bricks.attention import BertFFN, MLP, MultiHeadCrossAttention
from .bricks.point_transformer import PtCrossAttnBlock, PtSelfAttnBlock


class PointerLayer(nn.Module):
    def __init__(self, feat_dim: int, n_neighbor: int, n_neighbor_query: int, init_block: bool):
        super().__init__()
        self.init_block = init_block
        self.query_self_attn = PtSelfAttnBlock(feat_dim, feat_dim, n_neighbor_query)
        self.query_cross_attn = PtCrossAttnBlock(feat_dim, feat_dim, n_neighbor)
        self.reg_branch = MLP(feat_dim, feat_dim, 3)

    def forward(self, pt_xyz, pt_feats, query_xyz, query_feat, query_anchor_idx=None,
                pt_anchor_idx=None, anchor_xyz=None) -> Tuple[torch.Tensor, torch.Tensor]:
        a_xyz = anchor_xyz if self.init_block else None
        query_feat = self.query_self_attn(
            query_xyz, query_feat, query_anchor_idx if self.init_block else None, a_xyz)
        query_feat = self.query_cross_attn(
            pt_xyz, pt_feats, query_xyz, query_feat,
            pt_anchor_idx if self.init_block else None, a_xyz)
        delta = self.reg_branch(query_feat)
        return query_feat, query_xyz + delta.to(query_xyz.dtype)


class PointMetroBlock(nn.Module):
    def __init__(self, hidden_size: int = 256, num_heads: int = 4, n_neighbor: int = 32,
                 n_neighbor_query: int = 32, init_block: bool = False, dropout: float = 0.1):
        super().__init__()
        self.embedding = nn.Linear(hidden_size, hidden_size)
        self.drop = nn.Dropout(dropout)
        self.attn = MultiHeadCrossAttention(hidden_size, num_heads, dropout)
        self.cross_attn = MultiHeadCrossAttention(hidden_size, num_heads, dropout)
        self.vec_attn = PointerLayer(hidden_size, n_neighbor, n_neighbor_query, init_block)
        self.ffn = BertFFN(hidden_size, hidden_size * 4, dropout)

    def forward(self, query_xyz, query_feats, pt_xyz, pt_feats, query_anchor_idx=None,
                pt_anchor_idx=None, anchor_xyz=None):
        q_emb = self.drop(self.embedding(query_feats))
        k_emb = self.drop(self.embedding(pt_feats))
        attn_out = self.cross_attn(self.attn(q_emb, k_emb), k_emb)
        feats, xyz = self.vec_attn(pt_xyz, k_emb, query_xyz, attn_out, query_anchor_idx,
                                   pt_anchor_idx, anchor_xyz)
        return self.ffn(feats), xyz


class PtEmbedDecoder(nn.Module):
    """Stack of PointMetroBlocks; returns per-block coordinates (n_blocks, B, M, 3)."""

    def __init__(self, n_blocks: int = 3, hidden_size: int = 256, num_heads: int = 4,
                 n_neighbor: int = 32, n_neighbor_query: int = 32, dropout: float = 0.1):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"block_{i}", PointMetroBlock(
                hidden_size, num_heads, n_neighbor, n_neighbor_query, init_block=(i == 0),
                dropout=dropout))

    def forward(self, query_xyz, query_feats, pt_xyz, pt_feats,
                query_anchor_idx: Optional[torch.Tensor] = None,
                pt_anchor_idx: Optional[torch.Tensor] = None,
                anchor_xyz: Optional[torch.Tensor] = None) -> torch.Tensor:
        coords = []
        use_remat = self.training and torch.is_grad_enabled()
        for i in range(self.n_blocks):
            block = getattr(self, f"block_{i}")
            args = (query_xyz, query_feats, pt_xyz, pt_feats, query_anchor_idx, pt_anchor_idx,
                    anchor_xyz)
            if use_remat:
                store = KernelOutputStore()
                query_feats, query_xyz = checkpoint(block, *args, use_reentrant=False,
                                                    context_fn=store.contexts)
            else:
                query_feats, query_xyz = block(*args)
            coords.append(query_xyz)
        return torch.stack(coords, dim=0)
