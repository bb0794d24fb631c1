"""The algebra of the port's vector-attention core and of K7's sort, against the JAX package.

On the CPU (no card here): the bfloat16 chain's projection-first algebra
(project the cloud once, gather float32 k / v, three products a row) written
with tensors against the JAX ``fused_knn_vector_attention`` in interpret
mode; K1 fed with ``neighbor_idx``; K1, K2 and K8 at neighbour counts that do
not divide 32; and K7's parallel placement (segment histograms, one scan,
per-segment cursors) as tensors against a stable sort. Float32 throughout,
JAX under ``default_matmul_precision("highest")``; every comparison holds
the port to 1e-5 of the largest value (sums over <= 64 terms in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.ops import knn_attn, scatter, vector_attn

REL = 1e-5


def _mk(rs):
    return lambda *s: rs.randn(*s).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


def _inputs(seed, B=2, M=67, N=200, D=64):
    mk = _mk(np.random.RandomState(seed))
    args = (mk(B, M, D), mk(B, M, 3), mk(B, N, 3), mk(B, N, D), mk(D, D) / 8, mk(D, D) / 8)
    fcd = (mk(3, D), mk(D), mk(D, D) / 8, mk(D))
    fcg = (mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D))
    return args, fcd, fcg


def _jax_k1(args, fcd, fcg, K, **kw):
    from poem_v2_tpu.ops.pallas_knn_attn import fused_knn_vector_attention

    with jax.default_matmul_precision("highest"):
        return fused_knn_vector_attention(
            *map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)), tuple(map(jnp.asarray, fcg)),
            n_neighbor=K, block_q=16, chunk_j=8 if K % 8 == 0 else 4, interpret=True, **kw)


def projection_first(q, qxyz, pxyz, x_full, wk, wv, fcd, fcg, idx):
    """The bfloat16 chain's algebra (csrc/knn_attn.cu): kv = x_full [Wk | Wv]
    once per cloud point, k / v rows gathered from it, then pos, x, h, g and
    the per-channel softmax with three products a row."""
    B, M, K = idx.shape
    D = q.shape[-1]
    kv = x_full @ torch.cat([wk, wv], 1)                       # (B, N, 2D), every point once
    rows = torch.gather(kv, 1, idx.reshape(B, M * K, 1).long().expand(-1, -1, 2 * D))
    k, v = rows.reshape(B, M, K, 2 * D).split(D, -1)
    nn_xyz = torch.gather(pxyz, 1, idx.reshape(B, M * K, 1).long().expand(-1, -1, 3))
    delta = qxyz[:, :, None] - nn_xyz.reshape(B, M, K, 3)
    w1, b1, w2, b2 = fcd
    g0, c0, g1, c1 = fcg
    pos = torch.relu(delta @ w1 + b1) @ w2 + b2
    x = q[:, :, None] - k + pos
    g = (torch.relu(x @ g0 + c0) @ g1 + c1) / D ** 0.5
    return (torch.softmax(g, dim=-2) * (v + pos)).sum(-2)


@pytest.mark.parametrize("K", [8, 24])
def test_projection_first_algebra_matches_pallas(K):
    args, fcd, fcg = _inputs(1)
    want, idx = _jax_k1(args, fcd, fcg, K, return_idx=True, packed_keys=False)
    got = projection_first(*_t(*args), _t(*fcd), _t(*fcg), torch.from_numpy(np.array(idx)))
    _close(got.numpy(), want)


def test_neighbor_idx_matches_pallas_and_refuses_return_idx():
    """As tests/test_pallas_kernels.py::test_fused_knn_idx_fed_matches_argmin:
    the attention at the exact K-NN indices of ``knn_points``."""
    from poem_v2_tpu.ops.points import knn_points

    args, fcd, fcg = _inputs(6, N=200, D=64)
    K = 8
    _, idx, _ = knn_points(jnp.asarray(args[1]), jnp.asarray(args[2]), K, approx=False)
    want = _jax_k1(args, fcd, fcg, K, neighbor_idx=idx)
    t_args, t_fcd, t_fcg = _t(*args), _t(*fcd), _t(*fcg)
    t_idx = torch.from_numpy(np.array(idx))
    got = knn_attn.fused_knn_vector_attention(*t_args, t_fcd, t_fcg, n_neighbor=K,
                                              neighbor_idx=t_idx)
    _close(got.numpy(), want)
    with pytest.raises(ValueError, match="exclude"):
        knn_attn.fused_knn_vector_attention(*t_args, t_fcd, t_fcg, n_neighbor=K,
                                            neighbor_idx=t_idx, return_idx=True)
    with pytest.raises(ValueError, match="outside"):
        knn_attn.fused_knn_vector_attention(*t_args, t_fcd, t_fcg, n_neighbor=K,
                                            neighbor_idx=t_idx + 200)
    with pytest.raises(ValueError, match="neighbor_idx must be"):
        knn_attn.fused_knn_vector_attention(*t_args, t_fcd, t_fcg, n_neighbor=K,
                                            neighbor_idx=t_idx[..., :4])


@pytest.mark.parametrize("K", [24, 48])
def test_knn_attention_any_neighbour_count(K):
    """K1 at K = 24 and 48 (chunk_j 4 / 8): indices identical, output within REL."""
    args, fcd, fcg = _inputs(2)
    want, want_idx = _jax_k1(args, fcd, fcg, K, return_idx=True)
    got, idx = knn_attn.fused_knn_vector_attention(*_t(*args), _t(*fcd), _t(*fcg),
                                                   n_neighbor=K, return_idx=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close(got.numpy(), want)


def test_anchor_attention_24_anchors():
    from poem_v2_tpu.ops.pallas_knn_attn import fused_anchor_vector_attention as jax_anchor

    mk = _mk(np.random.RandomState(3))
    B, M, A, D = 2, 67, 24, 64
    args = (mk(B, M, D), mk(B, M, 3), mk(B, A, D), mk(B, A, D), mk(A, 3))
    fcd = (mk(3, D), mk(D), mk(D, D) / 8, mk(D))
    fcg = (mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D))
    with jax.default_matmul_precision("highest"):
        want = jax_anchor(*map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)),
                          tuple(map(jnp.asarray, fcg)), block_q=16, interpret=True)
    got = knn_attn.fused_anchor_vector_attention(*_t(*args), _t(*fcd), _t(*fcg))
    _close(got.numpy(), want)


def test_gathered_attention_24_neighbours():
    from poem_v2_tpu.ops.pallas_vector_attn import fused_vector_attention as jax_k8

    mk = _mk(np.random.RandomState(4))
    B, M, K, D = 2, 67, 24, 64
    args = (mk(B, M, D), mk(B, M, K, D), mk(B, M, K, D), mk(B, M, K, 3))
    fcd = (mk(3, D), mk(D), mk(D, D) / 8, mk(D))
    fcg = (mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D))
    with jax.default_matmul_precision("highest"):
        want = jax_k8(*map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)),
                      tuple(map(jnp.asarray, fcg)), block_q=16, interpret=True)
    got = vector_attn.fused_vector_attention(*_t(*args), _t(*fcd), _t(*fcg))
    _close(got.numpy(), want)


def segmented_placement(idx: torch.Tensor, n_rows: int, segment: int):
    """K7's sort (csrc/scatter.cu) as tensors: per-segment row histograms, one
    exclusive scan in (row, segment) order, and each entry's slot = its
    (row, segment)'s first slot + the entries of its row before it in its
    segment. Returns (row offsets (B, n_rows + 1), perm (B, valid entries))."""
    B, E = idx.shape
    S = -(-E // segment)
    valid = (idx >= 0) & (idx < n_rows)
    r = torch.where(valid, idx, 0).long()
    onehot = torch.nn.functional.one_hot(r, n_rows) * valid[..., None]       # (B, E, n_rows)
    pad = S * segment - E
    seg = torch.nn.functional.pad(onehot, (0, 0, 0, pad)).reshape(B, S, segment, n_rows)
    counts = seg.sum(2)                                                      # (B, S, n_rows)
    flat = counts.transpose(1, 2).reshape(B, n_rows * S)                     # (row, segment) order
    first = (torch.cumsum(flat, 1) - flat).reshape(B, n_rows, S).transpose(1, 2)  # (B, S, n_rows)
    before = (torch.cumsum(seg, 2) - seg).reshape(B, S * segment, n_rows)[:, :E]
    s_of = torch.arange(E) // segment
    slot = torch.gather(first[:, s_of], 2, r[..., None])[..., 0] \
        + torch.gather(before, 2, r[..., None])[..., 0]
    total = counts.sum((1, 2))
    perm = torch.full((B, E), -1, dtype=torch.long)
    for b in range(B):
        perm[b, slot[b][valid[b]]] = torch.arange(E)[valid[b]]
    row_counts = counts.sum(1)
    offsets = torch.cat([torch.zeros(B, 1, dtype=torch.long), torch.cumsum(row_counts, 1)], 1)
    return offsets, [perm[b, :int(total[b])] for b in range(B)]


@pytest.mark.parametrize("pattern", ["spread", "all_equal", "out_of_range"])
@pytest.mark.parametrize("segment", [16, scatter.SEGMENT])
def test_scatter_placement_is_a_stable_sort(pattern, segment):
    rs = np.random.RandomState(9)
    B, E, n_rows = 2, 300, 37
    idx = {"spread": rs.randint(0, n_rows, (B, E)),
           "all_equal": np.full((B, E), 5),
           "out_of_range": rs.randint(-4, n_rows + 4, (B, E))}[pattern]
    idx = torch.from_numpy(idx.astype(np.int32))
    offsets, perms = segmented_placement(idx, n_rows, segment)
    for b in range(B):
        valid = (idx[b] >= 0) & (idx[b] < n_rows)
        keys = torch.where(valid, idx[b], n_rows).long()
        order = torch.sort(keys, stable=True).indices[:int(valid.sum())]
        assert torch.equal(perms[b], order)
        counts = torch.bincount(keys[valid], minlength=n_rows)
        assert torch.equal(offsets[b], torch.cat([torch.zeros(1, dtype=torch.long),
                                                  torch.cumsum(counts, 0)]))
