"""Operation and byte counts of the METRO stage's attention modules (PtEmbedTRv3),
from shapes, and their least time on the card.

An attention module (``MultiHeadCrossAttention`` as self-attention over N tokens
of width H) must at least run its four H x H products a token (query, key,
value, output) and the attention itself, K3's two products a head, QK^T and PV:
4 N^2 d a head, 4 N^2 H over the heads, 2 operations a multiply-add. Bytes: the
tokens read once and written once, the four weights, their biases and the layer
norm's scale and shift, in the compute dtype. The softmax, the residual and the
norm are left out of the operations, so the least time is a floor.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

from .kernels import bound_ms

_QUERY = re.compile(r"head\.transformer\.metro_block_\d+\.layer\d+_attn\.query\.weight")


def attention_module_flops(B: int, N: int, H: int) -> float:
    """Least operations of one attention module: 4 H x H products a token and
    4 N^2 H of attention a sample."""
    return 4 * 2.0 * B * N * H * H + 4.0 * B * N * N * H


def attention_module_bytes(B: int, N: int, H: int, elem: int) -> float:
    """Least bytes of one attention module: tokens in and out, four H x H weights
    and H biases, the norm's two H vectors."""
    return elem * (2 * B * N * H + 4 * H * H + 6 * H)


def attention_widths(param_shapes: Sequence[Tuple[str, Tuple[int, ...]]]) -> List[int]:
    """The width H of every METRO attention module the program built, from its
    query weight's shape."""
    return [shape[0] for name, shape in param_shapes if _QUERY.fullmatch(name)]


def metro_attention_least_ms(B: int, N: int, widths: Sequence[int], elem: int = 2) -> float:
    """Least time of one forward's METRO attention modules of these widths."""
    return sum(bound_ms(attention_module_bytes(B, N, H, elem), attention_module_flops(B, N, H))[0]
               for H in widths)
