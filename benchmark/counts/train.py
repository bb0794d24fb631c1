"""Operation and byte counts of the train step's kernels, from shapes.

K6b (``csrc/knn_attn_bwd.cu``, the backward of the K-nearest-neighbour vector
attention) must at least run the backward of the three D x D products of every
(query, neighbour) row: the position layer's second product and the two of the
attention MLP, each a product for the input's gradient and one for the
weight's, 6 products a row at 2 operations a multiply-add. The forward rerun,
the 3 -> D layer, the softmax and the scatter to the cloud (K7, cuBLAS) are
left out, so the least time is a floor of what the ``knn_bwd_*`` kernels do.
Bytes: the rows' queries, the gradient in and out of the queries, and the
cloud's features and their gradient, each once, in the compute dtype.
"""

from __future__ import annotations

from .kernels import bound_ms


def knn_bwd_flops(B: int, M: int, K: int, D: int) -> float:
    """Least operations of one K6b call: 6 D x D products a (query, neighbour) row."""
    return B * M * K * 6 * 2.0 * D * D


def knn_bwd_bytes(B: int, M: int, N: int, D: int, elem: int) -> float:
    """Least bytes of one K6b call: queries, their gradient in and out, the cloud's
    features and their gradient, the three D x D weights."""
    return elem * (3 * B * M * D + 2 * B * N * D + 3 * D * D)


def knn_bwd_least_ms(cell) -> float:
    """Least time of a train step's K6b calls: the self and the cross module of
    every decoder block after the first (block 0 attends to fixed anchors)."""
    head = cell.config["MODEL"]["HEAD"]
    tr = head["TRANSFORMER"]
    B, M, N, D = cell.traffic["batch"], head["NUM_QUERY"], head["N_SAMPLE"], head["EMBED_DIMS"]
    total = 0.0
    for _ in range(tr["N_BLOCKS"] - 1):
        for n_cloud, k in ((M, tr["N_NEIGHBOR_QUERY"]), (N, tr["N_NEIGHBOR"])):
            total += bound_ms(knn_bwd_bytes(B, M, n_cloud, D, 2), knn_bwd_flops(B, M, k, D))[0]
    return total
