"""Point-transformer vector attention blocks
(counterpart of ``poem_v2_tpu/models/bricks/point_transformer.py``).

With ``use_fused_knn`` (the default, the serving path) the attention core
runs in eval in kernel K1 (exact KNN neighbourhoods) or K2 (fixed anchors,
block 0). In training (``module.train()``) with ``use_fused_knn_train`` (the
default) the KNN neighbourhoods run K6, whose backward is K6b (the kernels of
``csrc/knn_attn_bwd.cu``, then K7's scatter to the cloud), and the anchors
take the gathered path: autograd through
:func:`~poem_v2_tpu_torch.ops.vector_attn.vector_attention_reference` on
(B, M, A, D) tensors. With ``use_fused_knn_train=False`` (``--no-flash_train``)
training takes the gathered path for the KNN neighbourhoods too.

The gathered path (``use_fused_knn=False``, ``use_fused_knn_train=False`` in
training, and the anchors in training) is the JAX blocks' un-fused one:
exact ``knn_points`` (lowest index wins ties), one gather of the shared fc1
activations (in bfloat16 by :func:`~poem_v2_tpu_torch.ops.scatter.index_points_mxu`,
whose backward is K7, as the JAX ``_gather_shared`` takes ``index_points_mxu``;
float32 by the plain gather), ``w_ks`` / ``w_vs`` on the gathered tensor (for
anchors: the full projections gathered by the anchor indices and broadcast
over the queries), then kernel K8
(:func:`~poem_v2_tpu_torch.ops.vector_attn.fused_vector_attention`, eval
only) with ``use_fused``, else
:func:`~poem_v2_tpu_torch.ops.vector_attn.vector_attention_reference`.
``w_qs``, ``fc1``, ``fc2`` and the projections are plain products around
them, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...ops.knn_attn import (fused_anchor_vector_attention, fused_knn_vector_attention,
                             knn_vector_attention_trainable)
from ...ops.points import index_points, knn_points
from ...ops.scatter import index_points_mxu
from ...ops.vector_attn import fused_vector_attention, vector_attention_reference


def gather_shared(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of the shared fc1 activations x (B, N, D) by idx (B, M, K): bfloat16
    through ``index_points_mxu`` (backward K7), float32 by the plain gather."""
    if x.dtype == torch.bfloat16:
        return index_points_mxu(x, idx)
    return index_points(x, idx)


class RawDense(nn.Module):
    """Bias-free dense whose ``kernel`` stays (in, out): the kernels take it as a matrix."""

    def __init__(self, d_in: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, features))
        nn.init.normal_(self.kernel, std=1.0 / math.sqrt(d_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel


class _VectorAttention(nn.Module):
    """Parameters shared by both blocks: w_qs, w_ks, w_vs, fc_delta, fc_gamma, fc1, fc2."""

    def __init__(self, d_points: int, d_model: int, k: int, fc1_in: int, qs_in: int,
                 use_fused: bool = False, use_fused_knn: bool = True,
                 use_fused_knn_train: bool = True):
        super().__init__()
        self.k = k
        self.use_fused, self.use_fused_knn = use_fused, use_fused_knn
        self.use_fused_knn_train = use_fused_knn_train
        self.fc1 = nn.Linear(fc1_in, d_model)
        self.fc2 = nn.Linear(d_model, d_points)
        self.w_qs = nn.Linear(qs_in, d_model, bias=False)
        self.w_ks = RawDense(d_model, d_model)
        self.w_vs = RawDense(d_model, d_model)
        for name, d_in in (("fc_delta", 3), ("fc_gamma", d_model)):
            setattr(self, f"{name}_w1", nn.Parameter(torch.empty(d_in, d_model)))
            setattr(self, f"{name}_b1", nn.Parameter(torch.zeros(d_model)))
            setattr(self, f"{name}_w2", nn.Parameter(torch.empty(d_model, d_model)))
            setattr(self, f"{name}_b2", nn.Parameter(torch.zeros(d_model)))
            nn.init.normal_(getattr(self, f"{name}_w1"), std=1.0 / math.sqrt(d_in))
            nn.init.normal_(getattr(self, f"{name}_w2"), std=1.0 / math.sqrt(d_model))

    def mlps(self):
        return ((self.fc_delta_w1, self.fc_delta_b1, self.fc_delta_w2, self.fc_delta_b2),
                (self.fc_gamma_w1, self.fc_gamma_b1, self.fc_gamma_w2, self.fc_gamma_b2))

    def attend(self, q, query_xyz, cloud_xyz, x_cloud, anchor_idx, anchor_xyz):
        fc_delta, fc_gamma = self.mlps()
        # the train kernel needs the eval one on, as create_poem_model's flags do in JAX
        fused = self.use_fused_knn and (self.use_fused_knn_train or not self.training)
        if fused and anchor_idx is None:
            knn = knn_vector_attention_trainable if self.training else fused_knn_vector_attention
            return knn(q, query_xyz, cloud_xyz, x_cloud, self.w_ks.kernel, self.w_vs.kernel,
                       fc_delta, fc_gamma, n_neighbor=self.k)
        B, M, D = q.shape
        if anchor_idx is None:
            _, idx, nn_xyz = knn_points(query_xyz, cloud_xyz, self.k)
            x_g = gather_shared(x_cloud, idx)
            k_g, v_g = self.w_ks(x_g), self.w_vs(x_g)
        else:
            A = anchor_idx.shape[0]
            a_xyz = anchor_xyz if anchor_xyz is not None else cloud_xyz[:, anchor_idx]
            if self.use_fused_knn and not self.training:
                x_a = x_cloud[:, anchor_idx]
                return fused_anchor_vector_attention(
                    q, query_xyz, self.w_ks(x_a), self.w_vs(x_a), a_xyz, fc_delta, fc_gamma)
            # every query attends to the same A anchors (point_transformer.py:207-210, 302-305)
            a_xyz = a_xyz if a_xyz.dim() == 3 else a_xyz[None].expand(B, A, 3)
            nn_xyz = a_xyz[:, None].expand(B, M, A, 3)
            k_g = self.w_ks(x_cloud)[:, anchor_idx][:, None].expand(B, M, A, D)
            v_g = self.w_vs(x_cloud)[:, anchor_idx][:, None].expand(B, M, A, D)
        delta = query_xyz[:, :, None] - nn_xyz
        dt = q.dtype
        attention = fused_vector_attention if self.use_fused else vector_attention_reference
        return attention(q, k_g.to(dt), v_g.to(dt), delta.to(dt), [p.to(dt) for p in fc_delta],
                         [p.to(dt) for p in fc_gamma])


class PtSelfAttnBlock(_VectorAttention):
    """Vector self-attention of a point set over its K nearest points (or the anchors)."""

    def __init__(self, d_points: int, d_model: int, k: int, use_fused: bool = False,
                 use_fused_knn: bool = True, use_fused_knn_train: bool = True):
        super().__init__(d_points, d_model, k, fc1_in=d_points, qs_in=d_model,
                         use_fused=use_fused, use_fused_knn=use_fused_knn,
                         use_fused_knn_train=use_fused_knn_train)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                anchor_idx: Optional[torch.Tensor] = None,
                anchor_xyz: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.fc1(features)
        res = self.attend(self.w_qs(x), xyz, xyz, x, anchor_idx, anchor_xyz)
        return self.fc2(res) + features


class PtCrossAttnBlock(_VectorAttention):
    """Vector cross-attention of queries over their K nearest cloud points (or the anchors)."""

    def __init__(self, d_points: int, d_model: int, k: int, use_fused: bool = False,
                 use_fused_knn: bool = True, use_fused_knn_train: bool = True,
                 d_cloud: Optional[int] = None):
        # d_cloud: the cloud features' width (default d_model), fc1's input
        super().__init__(d_points, d_model, k, fc1_in=d_cloud or d_model, qs_in=d_points,
                         use_fused=use_fused, use_fused_knn=use_fused_knn,
                         use_fused_knn_train=use_fused_knn_train)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor, query_xyz: torch.Tensor,
                query_feat: torch.Tensor, anchor_idx: Optional[torch.Tensor] = None,
                anchor_xyz: Optional[torch.Tensor] = None) -> torch.Tensor:
        res = self.attend(self.w_qs(query_feat), query_xyz, xyz, self.fc1(features),
                          anchor_idx, anchor_xyz)
        return self.fc2(res) + query_feat
