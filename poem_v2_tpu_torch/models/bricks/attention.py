"""BERT-style attention bricks (counterpart of ``poem_v2_tpu/models/bricks/attention.py``).

The attention core is the dense kernel's autograd Function (K3 forward,
K3b backward) in eval and, with ``use_flash_train`` (the default), in
training, where it applies no dropout to the attention probabilities (the
JAX package's documented deviation #4). With ``use_flash_train=False``,
training takes the reference's einsum path: logits scaled by 1/sqrt(head
dim), softmax, dropout on the probabilities, then the values; plain PyTorch
on every device, as it is XLA in the JAX package. A ``kv_mask`` also selects
that path. Output-projection and FFN dropout are on in training mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cross_attn import dense_cross_attention


class MultiHeadCrossAttention(nn.Module):
    """MHA through the dense attention kernel (K3/K3b) or the einsum path +
    output proj + dropout + residual + LayerNorm."""

    def __init__(self, hidden_size: int = 256, num_heads: int = 4, dropout: float = 0.1,
                 use_flash_train: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash_train = use_flash_train
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.out = nn.Linear(hidden_size, hidden_size)
        self.drop = nn.Dropout(dropout)
        self.ln = nn.LayerNorm(hidden_size, eps=1e-6)  # flax's default eps

    def forward(self, hidden: torch.Tensor, kv: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden (B, Q, H) queries, kv (B, N, H), kv_mask (B, N) bool: keys to keep."""
        B, Q, H = hidden.shape
        nh = self.num_heads
        hd = H // nh
        q, k, v = self.query(hidden), self.key(kv), self.value(kv)
        if (not self.training or self.use_flash_train) and kv_mask is None:
            ctx = dense_cross_attention(q, k, v, num_heads=nh, sm_scale=1.0 / float(hd) ** 0.5)
        else:
            qh, kh, vh = (t.reshape(B, -1, nh, hd) for t in (q, k, v))
            logits = torch.einsum("bqhd,bnhd->bhqn", qh, kh) / math.sqrt(hd)
            if kv_mask is not None:
                logits = torch.where(kv_mask[:, None, None, :], logits, -1e9)
            probs = self.drop(torch.softmax(logits, dim=-1))
            ctx = torch.einsum("bhqn,bnhd->bqhd", probs, vh).reshape(B, Q, H)
        return self.ln(self.drop(self.out(ctx)) + hidden)


class BertFFN(nn.Module):
    """dense -> exact gelu -> dense -> dropout + residual + LayerNorm."""

    def __init__(self, hidden_size: int = 256, intermediate_size: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.intermediate = nn.Linear(hidden_size, intermediate_size)
        self.output = nn.Linear(intermediate_size, hidden_size)
        self.drop = nn.Dropout(dropout)
        self.ln = nn.LayerNorm(hidden_size, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.output(F.gelu(self.intermediate(x), approximate="none"))
        return self.ln(self.drop(h) + x)


class MLP(nn.Module):
    """Linear -> ReLU -> Linear."""

    def __init__(self, d_in: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(d_in, hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.Dense_0(x)))
