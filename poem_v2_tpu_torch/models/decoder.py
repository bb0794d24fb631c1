"""Point-embedded transformer decoder (counterpart of ``poem_v2_tpu/models/decoder.py``).

Each block: shared Linear embedding (+ dropout) of queries and BPS
features, two BERT cross-attentions into the BPS features, the pointer
layer (KNN self- and cross- vector attention, Δxyz head), a gelu FFN.
Block 0 uses 32 fixed anchors in place of KNN. With ``parametric_output``
the final block also emits 16 6D rotations and 10 MANO shape parameters
(``flat_verts``: a Dense(1) over the 799 tokens, then ``mano_linear``).

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
    """Vector self-attention, cross-attention and the Δxyz head. ``use_fused``
    and ``use_fused_knn`` select the attention path of both blocks
    (see :mod:`.bricks.point_transformer`)."""

    def __init__(self, feat_dim: int, n_neighbor: int, n_neighbor_query: int, init_block: bool,
                 use_fused: bool = False, use_fused_knn: bool = True):
        super().__init__()
        self.init_block = init_block
        self.query_self_attn = PtSelfAttnBlock(feat_dim, feat_dim, n_neighbor_query,
                                               use_fused, use_fused_knn)
        self.query_cross_attn = PtCrossAttnBlock(feat_dim, feat_dim, n_neighbor,
                                                 use_fused, use_fused_knn)
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
                 n_neighbor_query: int = 32, init_block: bool = False, dropout: float = 0.1,
                 parametric_head: bool = False, num_query: int = 799):
        super().__init__()
        self.embedding = nn.Linear(hidden_size, hidden_size)
        self.drop = nn.Dropout(dropout)
        self.attn = MultiHeadCrossAttention(hidden_size, num_heads, dropout)
        self.cross_attn = MultiHeadCrossAttention(hidden_size, num_heads, dropout)
        # use_fused stays False here, as in the JAX block: K8 is reached through PointerLayer
        self.vec_attn = PointerLayer(hidden_size, n_neighbor, n_neighbor_query, init_block,
                                     use_fused=False)
        self.ffn = BertFFN(hidden_size, hidden_size * 4, dropout)
        self.parametric_head = parametric_head
        if parametric_head:  # the final block of a parametric decoder
            self.flat_verts = nn.Linear(num_query, 1)
            self.mano_linear = nn.Linear(hidden_size, 106)

    def forward(self, query_xyz, query_feats, pt_xyz, pt_feats, query_anchor_idx=None,
                pt_anchor_idx=None, anchor_xyz=None):
        q_emb = self.drop(self.embedding(query_feats))
        k_emb = self.drop(self.embedding(pt_feats))
        attn_out = self.cross_attn(self.attn(q_emb, k_emb), k_emb)
        feats, xyz = self.vec_attn(pt_xyz, k_emb, query_xyz, attn_out, query_anchor_idx,
                                   pt_anchor_idx, anchor_xyz)
        feats = self.ffn(feats)
        if not self.parametric_head:
            return feats, xyz
        # (B, 799, D) -> a mix over the 799 tokens per channel -> 96 + 10 parameters
        params = self.mano_linear(self.flat_verts(feats.transpose(1, 2))[..., 0])
        return feats, xyz, params[:, :96], params[:, 96:]


class PtEmbedDecoder(nn.Module):
    """Stack of PointMetroBlocks; returns (per-block coordinates (n_blocks, B, M, 3),
    pose6d (B, 96), shape (B, 10)), the last two None unless ``parametric_output``."""

    def __init__(self, n_blocks: int = 3, hidden_size: int = 256, num_heads: int = 4,
                 n_neighbor: int = 32, n_neighbor_query: int = 32, dropout: float = 0.1,
                 parametric_output: bool = False, num_query: int = 799):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"block_{i}", PointMetroBlock(
                hidden_size, num_heads, n_neighbor, n_neighbor_query, init_block=(i == 0),
                dropout=dropout, parametric_head=parametric_output and i == n_blocks - 1,
                num_query=num_query))

    def forward(self, query_xyz, query_feats, pt_xyz, pt_feats,
                query_anchor_idx: Optional[torch.Tensor] = None,
                pt_anchor_idx: Optional[torch.Tensor] = None,
                anchor_xyz: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        coords = []
        pose6d = shape = None
        use_remat = self.training and torch.is_grad_enabled()
        for i in range(self.n_blocks):
            block = getattr(self, f"block_{i}")
            args = (query_xyz, query_feats, pt_xyz, pt_feats, query_anchor_idx, pt_anchor_idx,
                    anchor_xyz)
            if use_remat:
                store = KernelOutputStore()
                out = checkpoint(block, *args, use_reentrant=False, context_fn=store.contexts)
            else:
                out = block(*args)
            query_feats, query_xyz = out[:2]
            if len(out) == 4:
                pose6d, shape = out[2:]
            coords.append(query_xyz)
        return torch.stack(coords, dim=0), pose6d, shape
