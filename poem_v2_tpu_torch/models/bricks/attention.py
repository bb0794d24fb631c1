"""BERT-style attention bricks (counterpart of ``poem_v2_tpu/models/bricks/attention.py``).

The attention core is the dense kernel's autograd Function (K3 forward,
K3b backward) in eval and in training. As in the JAX package's
``use_flash_train`` path, training applies no dropout to the attention
probabilities (its documented deviation #4); output-projection and FFN
dropout are on in training mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cross_attn import dense_cross_attention


class MultiHeadCrossAttention(nn.Module):
    """MHA through the dense attention kernel (K3/K3b) + output proj + dropout
    + residual + LayerNorm."""

    def __init__(self, hidden_size: int = 256, num_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.out = nn.Linear(hidden_size, hidden_size)
        self.drop = nn.Dropout(dropout)
        self.ln = nn.LayerNorm(hidden_size, eps=1e-6)  # flax's default eps

    def forward(self, hidden: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        hd = hidden.shape[-1] // self.num_heads
        ctx = dense_cross_attention(self.query(hidden), self.key(kv), self.value(kv),
                                    num_heads=self.num_heads, sm_scale=1.0 / float(hd) ** 0.5)
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
