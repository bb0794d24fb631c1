"""Vector attention on pre-gathered neighbours, in the dtype of its inputs.

Counterpart of ``poem_v2_tpu/ops/pallas_vector_attn.py:vector_attention_reference``,
the training math of the point-transformer blocks: every product, the
softmax over the neighbour axis and the aggregate run in the inputs'
dtype, with the 1/sqrt(D) scale cast to it, as the JAX function computes
them. (The eval kernels' plain version, ``knn_attn.vector_attention_plain``,
upcasts to float32 instead, as the TPU kernels do.) The fused kernel of
that file (K8) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def vector_attention_reference(
    q: torch.Tensor,      # (B, M, D)
    k_g: torch.Tensor,    # (B, M, K, D)
    v_g: torch.Tensor,    # (B, M, K, D)
    delta: torch.Tensor,  # (B, M, K, 3)
    fc_delta: Sequence[torch.Tensor],  # (w1 (3, D), b1, w2 (D, D), b2)
    fc_gamma: Sequence[torch.Tensor],  # (g0 (D, D), c0, g1 (D, D), c1)
) -> torch.Tensor:
    """(B, M, D): sum_k softmax_k(gamma(q - k + pos)) * (v + pos), pos = delta(xyz)."""
    with torch.autocast(q.device.type, enabled=False):
        w1, b1, w2, b2 = fc_delta
        g0, c0, g1, c1 = fc_gamma
        t1 = torch.relu(delta @ w1 + b1)
        pos = t1 @ w2 + b2
        x = q[:, :, None] - k_g + pos
        g = torch.relu(x @ g0 + c0) @ g1 + c1
        # sqrt(D) rounded to float32, then to g's dtype, as jnp.sqrt(float32(D)).astype
        scale = float(torch.tensor(math.sqrt(k_g.shape[-1]), dtype=torch.float32).to(g.dtype))
        attn = torch.softmax(g / scale, dim=-2)
        return (attn * (v_g + pos)).sum(-2)
