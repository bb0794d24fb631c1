"""The operation-order transformer layer kit of the PETR and MVP baselines
(counterpart of ``poem_v2_tpu/models/bricks/transformer_layer.py``).

mmcv's ``BaseTransformerLayer`` semantics: a tuple such as ``("self_attn",
"norm", "cross_attn", "norm", "ffn", "norm")`` sets both the sequence of
operations and where the norms sit (a leading ``"norm"`` makes a layer
pre-norm). Attention and FFN add a residual to the tensor that entered them.

Attention is einsum attention with a boolean key mask, plain PyTorch on
every device (XLA in the JAX package; kernel K3 takes no mask): positional
embeddings are added to the queries and keys only, the logits are float32
(under bfloat16 autocast too) and masked keys take -1e9 before the softmax,
dropout falls on the probabilities and on the output. The norms are flax
LayerNorms: eps 1e-6, not torch's 1e-5.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ...utils.registry import ATTENTION, TRANSFORMER

DEFAULT_ORDER = ("self_attn", "norm", "cross_attn", "norm", "ffn", "norm")


def layer_norm(dims: int) -> nn.LayerNorm:
    """flax's default LayerNorm (eps 1e-6)."""
    return nn.LayerNorm(dims, eps=1e-6)


class FFN(nn.Module):
    """Linear -> ReLU -> Dropout -> Linear -> Dropout, plus the identity; no norm
    of its own (the operation order places the norms)."""

    def __init__(self, embed_dims: int = 256, feedforward_channels: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(embed_dims, feedforward_channels)
        self.fc2 = nn.Linear(feedforward_channels, embed_dims)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.drop(self.fc2(self.drop(torch.relu(self.fc1(x)))))


@ATTENTION.register_module("MultiheadAttention")
class MultiheadAttention(nn.Module):
    """Multi-head attention with q / k / v / out projections; ``query_pos`` and
    ``key_pos`` are added to the query and key inputs, never to the values."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.q_proj = nn.Linear(embed_dims, embed_dims)
        self.k_proj = nn.Linear(embed_dims, embed_dims)
        self.v_proj = nn.Linear(embed_dims, embed_dims)
        self.out_proj = nn.Linear(embed_dims, embed_dims)
        self.drop = nn.Dropout(dropout)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                query_pos: Optional[torch.Tensor] = None, key_pos: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Q, C), key and value (B, N, C), key_mask (B, N) bool: keys to keep."""
        B, Q, C = query.shape
        N = key.shape[1]
        nh = self.num_heads
        hd = C // nh
        q = self.q_proj(query if query_pos is None else query + query_pos).reshape(B, Q, nh, hd)
        k = self.k_proj(key if key_pos is None else key + key_pos).reshape(B, N, nh, hd)
        v = self.v_proj(value).reshape(B, N, nh, hd)
        logits = torch.einsum("bqhd,bnhd->bhqn", q, k).float() / math.sqrt(hd)
        if key_mask is not None:
            logits = torch.where(key_mask[:, None, None, :], logits, -1e9)
        probs = self.drop(torch.softmax(logits, dim=-1))
        ctx = torch.einsum("bhqn,bnhd->bqhd", probs.to(v.dtype), v).reshape(B, Q, C)
        return self.drop(self.out_proj(ctx))


@TRANSFORMER.register_module("BaseTransformerLayer")
class BaseTransformerLayer(nn.Module):
    """One layer driven by ``operation_order`` over {self_attn, cross_attn, norm,
    ffn}: self_attn is q = k = v = x with ``query_pos``; cross_attn takes the
    memory as keys and values with ``memory_pos`` and ``memory_mask``. Submodules
    are numbered per kind in order (``attn_i``, ``norm_i``, ``ffn_i``), as flax
    names them."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 1024, dropout: float = 0.1,
                 operation_order: Sequence[str] = DEFAULT_ORDER):
        super().__init__()
        self.operation_order = tuple(operation_order)
        counts = {"attn": 0, "norm": 0, "ffn": 0}
        for op in self.operation_order:
            kind = {"self_attn": "attn", "cross_attn": "attn"}.get(op, op)
            if kind not in counts:
                raise ValueError(f"Unknown operation {op!r}")
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            if kind == "attn":
                self.add_module(name, MultiheadAttention(embed_dims, num_heads, dropout))
            elif kind == "norm":
                self.add_module(name, layer_norm(embed_dims))
            else:
                self.add_module(name, FFN(embed_dims, feedforward_channels, dropout))

    def forward(self, query: torch.Tensor, memory: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None,
                memory_pos: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = query
        counts = {"attn": 0, "norm": 0, "ffn": 0}

        def next_module(kind):
            m = getattr(self, f"{kind}_{counts[kind]}")
            counts[kind] += 1
            return m

        for op in self.operation_order:
            if op == "self_attn":
                x = x + next_module("attn")(x, x, x, query_pos, query_pos)
            elif op == "cross_attn":
                if memory is None:
                    raise ValueError("operation_order has cross_attn but no memory given")
                x = x + next_module("attn")(x, memory, memory, query_pos, memory_pos,
                                            memory_mask)
            else:
                x = next_module(op)(x)
        return x


@TRANSFORMER.register_module("TransformerLayerSequence")
class TransformerLayerSequence(nn.Module):
    """``num_layers`` identical :class:`BaseTransformerLayer` s (``layer_i``);
    with ``return_intermediate`` every layer's output, stacked (L, B, Q, C)."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 1024, dropout: float = 0.1,
                 operation_order: Sequence[str] = DEFAULT_ORDER,
                 return_intermediate: bool = True):
        super().__init__()
        self.num_layers, self.return_intermediate = num_layers, return_intermediate
        for i in range(num_layers):
            self.add_module(f"layer_{i}", BaseTransformerLayer(
                embed_dims, num_heads, feedforward_channels, dropout, operation_order))

    def forward(self, query: torch.Tensor, memory: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None,
                memory_pos: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        outs, x = [], query
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, memory, query_pos, memory_pos, memory_mask)
            outs.append(x)
        return torch.stack(outs) if self.return_intermediate else x
