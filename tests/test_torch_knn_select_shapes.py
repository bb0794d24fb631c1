"""K1's and K9's neighbour selections at the shapes their kernels treat
differently, held against the JAX package on the CPU.

The plain versions are what the CUDA selections (``csrc/select_core.cuh``)
are held to with ``torch.equal`` on the card. Here ``knn_select_plain`` is
held against the indices of the JAX K1 (``fused_knn_vector_attention(...,
return_idx=True)`` in interpret mode) at N 1, 33, 799, 4095, 4096 (packed
keys) and 4097 (exact keys), K 1, 8, 32, 48, and the plain K9 against the JAX
K9 in interpret mode at ``n_cand`` 1, 8 and NB with a ragged last block. The
coordinates lie on a grid of eighths, so every squared distance is exact in
any order of operations and both packings see the same bits; clouds hold
every point twice and many equal distances, so ties decide. The ctypes
signatures of the two selection entry points are held against their C
declarations and against the arguments the wrappers pass.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.ops import _lib, knn_attn, points

D = 8  # the attention's width: only the indices matter here


def _grid_points(rs, n, dup=True):
    """n points on a grid of eighths in [-1, 1]^3; ``dup``: each one twice."""
    pts = rs.randint(-8, 9, (n, 3)).astype(np.float32) / 8
    if dup and n > 1:
        pts = np.concatenate([pts[: (n + 1) // 2]] * 2)[:n]
    return pts


def _jax_k1_idx(qxyz, ptxyz, K):
    from poem_v2_tpu.ops.pallas_knn_attn import fused_knn_vector_attention as jax_knn

    B, M, _ = qxyz.shape
    N = ptxyz.shape[1]
    rs = np.random.RandomState(0)
    mk = lambda *s: jnp.asarray(rs.randn(*s).astype(np.float32))
    fcd = (mk(3, D), mk(D), mk(D, D), mk(D))
    fcg = (mk(D, D), mk(D), mk(D, D), mk(D))
    with jax.default_matmul_precision("highest"):
        _, idx = jax_knn(mk(B, M, D), jnp.asarray(qxyz), jnp.asarray(ptxyz), mk(B, N, D),
                         mk(D, D), mk(D, D), fcd, fcg, n_neighbor=K, block_q=8,
                         chunk_j=8 if K % 8 == 0 else 1, return_idx=True, interpret=True)
    return np.asarray(idx)


def _k1_cases():
    for N in (1, 33, 799, 4095, 4096, 4097):
        for K in (1, 8, 32, 48):
            if K <= N:
                yield N, K


@pytest.mark.parametrize("N,K", list(_k1_cases()))
def test_knn_select_plain_matches_pallas_k1(N, K):
    rs = np.random.RandomState(N + K)
    B, M = 1, 8
    ptxyz = _grid_points(rs, N)[None].repeat(B, 0)
    qxyz = rs.randint(-8, 9, (B, M, 3)).astype(np.float32) / 8
    qxyz[0, 0] = ptxyz[0, 0]  # a query on a (duplicated) point: d2 0, twice
    want = _jax_k1_idx(qxyz, ptxyz, K)
    got = knn_attn.knn_select_plain(torch.from_numpy(qxyz), torch.from_numpy(ptxyz), K)
    assert got.dtype == torch.int32 and got.shape == (B, M, K)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same ties as the keys' order: distance, then the lower index
    d2 = ((qxyz[:, :, None] - ptxyz[:, None]) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(N), d2.shape), d2), axis=-1)[..., :K]
    np.testing.assert_array_equal(got.numpy(), order)
    if K > 1:  # ties occur: query 0 sits on a point that the cloud holds twice
        sel = np.take_along_axis(d2, got.numpy().astype(np.int64), -1)
        assert (np.diff(sel, axis=-1) == 0).any()


def _bucketed_case(seed, B, M, N, SB):
    rs = np.random.RandomState(seed)
    cloud = _grid_points(rs, N)
    perm, lo, hi = points.build_balanced_buckets(cloud, SB)
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    qxyz = rs.randint(-8, 9, (B, M, 3)).astype(np.float32) / 8
    args = (mk(B, M, D), qxyz, np.broadcast_to(cloud[perm], (B, N, 3)).copy(), mk(B, N, D), lo,
            hi, mk(D, D) / 4, mk(D, D) / 4)
    fcd = (mk(3, D), mk(D), mk(D, D) / 4, mk(D))
    fcg = (mk(D, D) / 4, mk(D), mk(D, D) / 4, mk(D))
    return args, fcd, fcg


@pytest.mark.parametrize("n_cand", [1, 8, 16])
def test_plain_bucketed_selection_matches_pallas_k9(n_cand):
    """The plain K9 at n_cand 1, 8 and NB (16 buckets of 32), 45 queries in
    blocks of 16 (the last ragged), K 16, against the JAX K9: the output (which
    attends the selected points, so a different tie changes it) and the
    margins; and its indices against a stable sort over the candidates."""
    from poem_v2_tpu.ops.pallas_knn_attn import fused_knn_vector_attention_bucketed as jax_fn

    B, M, N, SB, BQ, K = 2, 45, 512, 32, 16, 16
    args, fcd, fcg = _bucketed_case(n_cand, B, M, N, SB)
    kw = dict(n_neighbor=K, block_q=BQ, n_cand=n_cand, bucket_size=SB)
    with jax.default_matmul_precision("highest"):
        want, want_m = jax_fn(*map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)),
                              tuple(map(jnp.asarray, fcg)), chunk_j=4, interpret=True, **kw)
    t = [torch.from_numpy(np.array(a)) for a in args]
    got, margins, idx = knn_attn.fused_knn_vector_attention_bucketed(
        *t, [torch.from_numpy(a) for a in fcd], [torch.from_numpy(a) for a in fcg],
        return_idx=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(margins.numpy(), np.asarray(want_m), atol=1e-6)
    # the selection alone: candidate columns in bucket order, ties to the lower column
    qxyz, ptxyz = args[1], args[2]
    cand = knn_attn.select_candidate_buckets(
        knn_attn._pad_queries_edge(torch.from_numpy(qxyz), BQ), *t[4:6], BQ, n_cand)
    sel_idx, sel_m = knn_attn.knn_select_bucketed(t[1], t[2], t[4], t[5], cand, K, BQ, n_cand,
                                                  SB)
    assert torch.equal(sel_idx, idx) and torch.equal(sel_m, margins)
    cand = cand.reshape(B, -1, n_cand).numpy()
    for b in range(B):
        for m in range(M):
            cols = (cand[b, m // BQ][:, None] * SB + np.arange(SB)).reshape(-1)
            d2 = ((qxyz[b, m] - ptxyz[b, cols]) ** 2).sum(-1)
            np.testing.assert_array_equal(idx[b, m].numpy(),
                                          cols[np.argsort(d2, kind="stable")[:K]])
    if n_cand == N // SB:
        assert float(margins.min()) == pytest.approx(knn_attn.MARGIN_SENTINEL, rel=1e-6)


def test_selection_ties_across_buckets_go_to_the_lower_candidate_column():
    """Buckets 0 and 2 hold the same four points; a query at the origin ties
    them at box distance 0 (the lower bucket id first) and then at d2 0 and d2
    1 between their points: the lower candidate column wins every tie."""
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    cloud = np.concatenate([base, base + 4, base, base + 8])  # 4 buckets of 4, contiguous
    boxes = cloud.reshape(4, 4, 3)
    lo, hi = torch.from_numpy(boxes.min(1)), torch.from_numpy(boxes.max(1))
    ptxyz = torch.from_numpy(cloud)[None]
    qxyz = torch.zeros(1, 1, 3)
    cand = knn_attn.select_candidate_buckets(qxyz, lo, hi, 1, 2)
    assert cand.tolist() == [0, 2]
    idx, margins = knn_attn.knn_select_bucketed(qxyz, ptxyz, lo, hi, cand, 4, 1, 2, 4)
    # d2 0: point 0 (column 0), then point 8 (column 4); d2 1: points 1 and 2
    # (columns 1, 2) before their copies 9, 10 (columns 5, 6)
    assert idx.tolist() == [[[0, 8, 1, 2]]]
    assert float(margins) == pytest.approx(48.0 - 1.0)  # bucket 1's box at (4, 4, 4)


def _c_decl(name):
    for f in os.listdir(_lib.CSRC):
        if f.endswith(".cu"):
            m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                          open(os.path.join(_lib.CSRC, f)).read())
            if m:
                return [a.strip() for a in m.group(1).split(",")]
    raise AssertionError(f"no C entry point {name}")


@pytest.mark.parametrize("name", ["poem_knn_select", "poem_knn_select_bucketed"])
def test_selection_signatures_match_the_c_entry_points(name):
    args = _c_decl(name)
    types = _lib._SIGNATURES[name]
    assert len(types) == len(args)
    for a, t in zip(args, types):
        assert ("*" in a) == (t is _lib._P), (name, a)


def test_selection_wrappers_pass_what_the_signatures_take(monkeypatch):
    """The wrappers' calls, up to the library, on meta tensors (neither the CPU
    path nor a card): as many arguments as the ctypes signature, ints where it
    takes ints."""
    calls = []

    class FakeLib:
        def call(self, name, *args):
            calls.append((name, args))

    monkeypatch.setattr(_lib, "lib", lambda: FakeLib())
    monkeypatch.setattr(_lib, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(knn_attn, "check_one_device", lambda *ts: None)
    meta = dict(device="meta")
    knn_attn.knn_select(torch.empty(2, 5, 3, **meta), torch.empty(2, 40, 3, **meta), 4)
    qxyz, pxyz = torch.empty(2, 5, 3, **meta), torch.empty(2, 64, 3, **meta)
    lo, hi = torch.empty(4, 3, **meta), torch.empty(4, 3, **meta)
    cand = torch.empty(2 * 2 * 3, dtype=torch.int32, **meta)
    idx, margins = knn_attn.knn_select_bucketed(qxyz, pxyz, lo, hi, cand, 4, 4, 3, 16)
    assert idx.shape == (2, 5, 4) and margins.shape == (2, 2)
    assert [c[0] for c in calls] == ["poem_knn_select", "poem_knn_select_bucketed"]
    for name, args in calls:
        types = _lib._SIGNATURES[name]
        assert len(args) == len(types), name
        for a, t in zip(args, types):
            if t is _lib._I:
                assert isinstance(a, int), (name, a)
    assert calls[0][1][3:8] == (2, 5, 40, 4, 1)  # B, M, N, K, packed
    assert calls[1][1][8:16] == (2, 5, 64, 4, 4, 4, 3, 16)  # B, M, N, NB, K, BQ, C, SB
