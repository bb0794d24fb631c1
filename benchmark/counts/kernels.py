"""Operation and byte counts of the kernels' work, from shapes, and the least
time the card could take for them.

``bound_ms``, ``attention_flops`` and ``knn_attention_flops`` are copied from
``chip_smoke.py:399-417``.
The counts never look at what the program launches: a later change that
replaces or removes a kernel leaves them as they are.
"""

from __future__ import annotations

from .peaks import PEAK_BYTES_PER_S, PEAK_FLOPS


def bound_ms(nbytes: float, flops: float, dtype: str = "bfloat16"):
    """The least time the card could take: (ms, "bytes" or "operations"), the
    larger of bytes over the memory rate and operations over the dtype's peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_flops(rows: int, D: int, products: int) -> float:
    """``products`` D x D products and the 3 -> D position layer for every
    (query, neighbour) row, 2 operations a multiply-add."""
    return rows * (products * 2.0 * D * D + 2.0 * 3 * D)


def knn_attention_flops(B: int, M: int, K: int, N: int, D: int) -> float:
    """The least work of K1: three D x D products a (query, neighbour) row, the
    k / v projection (two D x D products) once a cloud point, and the squared
    distances to the cloud (8 operations a pair)."""
    return attention_flops(B * M * K, D, 3) + B * N * 2 * 2.0 * D * D + 8.0 * B * M * N


def anchor_attention_flops(B: int, M: int, A: int, D: int) -> float:
    """The least work of K2: K1's three products a (query, anchor) row and the
    k / v projection of the A anchors; no selection."""
    return attention_flops(B * M * A, D, 3) + B * A * 2 * 2.0 * D * D


def vector_block_bytes(B: int, M: int, N: int, D: int, elem: int) -> float:
    """Bytes a vector-attention call must move at least: the queries' input and
    output, the cloud features, the (3 -> D, D x D) weights and the coordinates,
    each once."""
    return elem * (2 * B * M * D + B * N * D + 6 * D * D) + 4 * 3 * B * (M + N)
