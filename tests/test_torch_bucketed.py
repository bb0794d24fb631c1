"""The bucketed exact-KNN attention (K9) and its host code vs the JAX package on the CPU.

The port's plain version against ``fused_knn_vector_attention_bucketed`` in
interpret mode, on the inputs of
tests/test_pallas_kernels.py::test_bucketed_knn_attention_exact_and_certified
made from a numpy seed, under ``default_matmul_precision("highest")``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.ops import knn_attn, points

BPS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "bps.npy")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("cloud, bucket_size", [
    ("bps", 128), ("bps", 32), ("random", 32), ("random_768", 64)])
def test_build_balanced_buckets_matches_jax(cloud, bucket_size):
    from poem_v2_tpu.ops.points import build_balanced_buckets as jax_buckets

    if cloud == "bps":
        pts = np.load(BPS).astype(np.float32).reshape(-1, 3)
    else:  # 768 = 3 * 256: halves that are not powers of two
        pts = np.random.RandomState(1).randn(768 if cloud == "random_768" else 512, 3)
    want = jax_buckets(pts, bucket_size)
    got = points.build_balanced_buckets(pts, bucket_size)
    for g, w, name in zip(got, want, ("perm", "lo", "hi")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    perm, lo, hi = got
    assert sorted(perm.tolist()) == list(range(len(pts)))
    boxes = pts.astype(np.float32)[perm].reshape(-1, bucket_size, 3)
    np.testing.assert_array_equal(boxes.min(1), lo)
    np.testing.assert_array_equal(boxes.max(1), hi)
    with pytest.raises(ValueError):
        points.build_balanced_buckets(pts[:-1], bucket_size)


def test_select_candidate_buckets_matches_jax_on_tied_scores():
    """Queries drawn inside the boxes: each block scores 0 for several buckets
    and the ties must go to the lowest bucket ids, in order."""
    from poem_v2_tpu.ops.pallas_knn_attn import select_candidate_buckets as jax_select

    rs = np.random.RandomState(2)
    cloud = rs.randn(512, 3).astype(np.float32)
    perm, lo, hi = points.build_balanced_buckets(cloud, 32)
    B, Mp, BQ = 2, 64, 16
    # queries are cloud points (inside a box each), scattered over the cloud
    qxyz = cloud[rs.randint(0, 512, (B, Mp))]
    qxyz[1, 32:] += rs.randn(32, 3).astype(np.float32) * 3.0   # and some far outside
    for n_cand in (4, 8, 16):
        want = np.asarray(jax_select(jnp.asarray(qxyz), jnp.asarray(lo), jnp.asarray(hi), BQ, n_cand))
        got = knn_attn.select_candidate_buckets(*_t(qxyz, lo, hi), BQ, n_cand)
        assert got.dtype == torch.int32 and got.shape == (B * (Mp // BQ) * n_cand,)
        np.testing.assert_array_equal(got.numpy(), want)
    score = knn_attn.box_lower_bound(torch.from_numpy(qxyz).reshape(B, Mp // BQ, BQ, 3),
                                     *_t(lo, hi)).min(2).values
    assert int((score == 0).sum(-1).min()) >= 2, "the inputs must tie several buckets at 0"
    with pytest.raises(ValueError):
        knn_attn.select_candidate_buckets(*_t(qxyz[:, :60], lo, hi), BQ, 4)


@pytest.fixture(scope="module")
def bucketed_inputs():
    rs = np.random.RandomState(0)
    B, M, N, D, K, SB = 2, 64, 512, 64, 8, 32
    cloud = rs.randn(N, 3).astype(np.float32)
    perm, lo, hi = points.build_balanced_buckets(cloud, SB)
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    q, qxyz = mk(B, M, D), mk(B, M, 3)
    ptxyz = np.broadcast_to(cloud[perm], (B, N, 3)).copy()
    x_full = mk(B, N, D)
    wk, wv = mk(D, D) / 8, mk(D, D) / 8
    fcd = (mk(3, D), mk(D), mk(D, D) / 8, mk(D))
    fcg = (mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D))
    qxyz_tight = cloud[7][None, None] + rs.randn(B, M, 3).astype(np.float32) * 0.05
    return dict(q=q, qxyz=qxyz, qxyz_tight=qxyz_tight, ptxyz=ptxyz, x_full=x_full, lo=lo, hi=hi,
                wk=wk, wv=wv, fcd=fcd, fcg=fcg, K=K, SB=SB, NB=N // SB)


def _jax_bucketed(d, qxyz, q=None, **kw):
    from poem_v2_tpu.ops.pallas_knn_attn import fused_knn_vector_attention_bucketed as jax_fn

    q = d["q"] if q is None else q
    with jax.default_matmul_precision("highest"):
        out, margins = jax_fn(
            *map(jnp.asarray, (q, qxyz, d["ptxyz"], d["x_full"], d["lo"], d["hi"], d["wk"],
                               d["wv"])),
            tuple(map(jnp.asarray, d["fcd"])), tuple(map(jnp.asarray, d["fcg"])),
            n_neighbor=d["K"], chunk_j=4, bucket_size=d["SB"], interpret=True, **kw)
    return np.asarray(out), np.asarray(margins)


def _port_bucketed(d, qxyz, q=None, **kw):
    q = d["q"] if q is None else q
    return knn_attn.fused_knn_vector_attention_bucketed(
        *_t(q, qxyz, d["ptxyz"], d["x_full"], d["lo"], d["hi"], d["wk"], d["wv"]),
        _t(*d["fcd"]), _t(*d["fcg"]), n_neighbor=d["K"], bucket_size=d["SB"], **kw)


def _port_full(d, qxyz, q=None):
    q = d["q"] if q is None else q
    return knn_attn.fused_knn_vector_attention(
        *_t(q, qxyz, d["ptxyz"], d["x_full"], d["wk"], d["wv"]), _t(*d["fcd"]), _t(*d["fcg"]),
        n_neighbor=d["K"], return_idx=True)


def test_bucketed_all_candidates_matches_pallas_and_full_search(bucketed_inputs):
    d = bucketed_inputs
    want, want_m = _jax_bucketed(d, d["qxyz"], block_q=16, n_cand=d["NB"])
    got, margins, idx = _port_bucketed(d, d["qxyz"], block_q=16, n_cand=d["NB"], return_idx=True)
    assert got.shape == (2, 64, 64) and margins.shape == (2, 4) and idx.shape == (2, 64, 8)
    assert margins.dtype == torch.float32 and idx.dtype == torch.int32
    # float32 on both sides, sums over 64 terms in other orders
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert want_m.min() > 1e30 and float(margins.min()) > 1e30
    assert float(margins.max()) == pytest.approx(knn_attn.MARGIN_SENTINEL, rel=1e-6)
    # every bucket a candidate: the neighbours of the port's search over the whole cloud
    full, full_idx = _port_full(d, d["qxyz"])
    assert torch.equal(idx.sort(-1).values, full_idx.sort(-1).values)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5)


def test_bucketed_tight_cluster_margins_and_certified_blocks(bucketed_inputs):
    d = bucketed_inputs
    want, want_m = _jax_bucketed(d, d["qxyz_tight"], block_q=16, n_cand=8)
    got, margins = _port_bucketed(d, d["qxyz_tight"], block_q=16, n_cand=8)
    # margins are differences of squared distances of order 1, float32 on both sides
    np.testing.assert_allclose(margins.numpy(), want_m, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    m = margins.numpy()
    assert (m >= 0).any(), "no block certified on easy geometry"
    assert ((m >= 0) == (want_m >= 0)).all()
    full, _ = _port_full(d, d["qxyz_tight"])
    err = (got - full).abs().reshape(2, 4, 16, 64).amax(dim=(2, 3)).numpy()
    assert err[m >= 0].max() < 1e-5


def test_bucketed_ragged_queries_edge_padding():
    """M = 799 at block_q = 32: the last block holds 31 queries; the pad row
    repeats the last query and changes neither the buckets nor the margin."""
    rs = np.random.RandomState(4)
    B, M, N, D, K, SB = 1, 799, 512, 64, 8, 32
    cloud = rs.randn(N, 3).astype(np.float32)
    perm, lo, hi = points.build_balanced_buckets(cloud, SB)
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    d = dict(q=mk(B, M, D), ptxyz=cloud[perm][None].copy(), x_full=mk(B, N, D), lo=lo, hi=hi,
             wk=mk(D, D) / 8, wv=mk(D, D) / 8, fcd=(mk(3, D), mk(D), mk(D, D) / 8, mk(D)),
             fcg=(mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D)), K=K, SB=SB)
    # sorted along x, so that a block's queries are near each other
    qxyz = mk(B, M, 3)
    qxyz = np.take_along_axis(qxyz, np.argsort(qxyz[..., :1], axis=1), axis=1)
    want, want_m = _jax_bucketed(d, qxyz, block_q=32, n_cand=8)
    got, margins = _port_bucketed(d, qxyz, block_q=32, n_cand=8)
    assert got.shape == (B, M, D) and margins.shape == (B, 25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(margins.numpy(), want_m, atol=1e-5)
    # the last block alone: its margin is that of its 31 real queries
    tail, tail_m = _port_bucketed(d, qxyz[:, 768:], q=d["q"][:, 768:], block_q=31, n_cand=8)
    assert float(tail_m[0, 0]) == float(margins[0, 24])
    # the same neighbours; the products run at another batch size, so not the same bits
    np.testing.assert_allclose(tail.numpy(), got[:, 768:].numpy(), atol=1e-6)


@pytest.mark.parametrize("kw, match", [
    (dict(bucket_size=48), "buckets of"),
    (dict(n_cand=17), "exceeds the 16 buckets"),
    (dict(n_cand=1, n_neighbor=64), "candidate points"),
])
def test_bucketed_refuses_bad_shapes(bucketed_inputs, kw, match):
    d = bucketed_inputs
    args = dict(n_neighbor=d["K"], bucket_size=d["SB"], n_cand=8, block_q=16)
    args.update(kw)
    for fn in (knn_attn.fused_knn_vector_attention_bucketed,
               knn_attn.plain_fused_knn_vector_attention_bucketed):
        with pytest.raises(ValueError, match=match):
            fn(*_t(d["q"], d["qxyz"], d["ptxyz"], d["x_full"], d["lo"], d["hi"], d["wk"],
                   d["wv"]), _t(*d["fcd"]), _t(*d["fcg"]), **args)
