"""K6b's algebra against the JAX package's K6 backward, on the CPU.

``csrc/knn_attn_bwd.cu`` computes the backward of the trainable KNN vector
attention written out, not by autograd: the forward's products rerun over
the (query, neighbour) rows in the forward chain's row layout (tiles of
128 rows holding floor(128 / K) whole queries, K > 128 over several tiles,
spare rows zeroed), o recomputed, the softmax backward in closed form
(ds = a dout (vp - o)), dq and dquery_xyz as per-query sums, and the rows'
[dk | dv | -ddelta] scattered to the cloud by K7 before the products per
cloud point (dx_full, dWk, dWv). :func:`k6b_rows` below is that algebra in
tensors, pass for pass; it is held against ``jax.vjp`` of
``pallas_knn_attn.knn_vector_attention_trainable`` (the Pallas forward in
interpret mode) for all 14 input gradients. Float32, highest matmul
precision on the JAX side; limit 1e-5 of each gradient's peak (both sides
sum in float32, in other orders). fc_gamma's output bias shifts every
neighbour of a channel alike, so its exact gradient is 0 and both sides hold
float32 noise: it is held to the scale of G1's gradient.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.ops import knn_attn, scatter, vector_attn

REL = 1e-5
CR = vector_attn.CORE_TILE


def row_map(B: int, M: int, K: int):
    """Sample, query, neighbour (clamped into range) and validity of every row
    of the chain's layout, as ``RowMap::at`` (csrc/knn_core.cuh) gives them."""
    if K <= CR:
        QB, T = CR // K, 1
        tiles = -(-M // QB)
    else:
        QB, T = 1, -(-K // CR)
        tiles = M * T
    r = torch.arange(vector_attn.core_rows(B, M, K))
    tile_all, i = r // CR, r % CR
    b, tile = tile_all // tiles, tile_all % tiles
    if K <= CR:
        qi = i // K
        m, j = tile * QB + qi, i % K
        valid = (qi < QB) & (m < M)
    else:
        m, j = tile // T, (tile % T) * CR + i
        valid = j < K
    return b, m.clamp(max=M - 1), j.clamp(max=K - 1), valid


def k6b_rows(q, qxyz, pxyz, xf, wk, wv, fc_delta, fc_gamma, idx, dout, dt=None):
    """The 14 input gradients as the passes of csrc/knn_attn_bwd.cu form them,
    in float32; with ``dt`` (bfloat16) rounded where the kernel rounds: the
    inputs, the forward's delta, t1, x and h, the row buffers dg, da, dpos,
    dt1 and the scattered rows before the products per cloud point."""
    r = (lambda t: t) if dt is None else (lambda t: t.to(dt).float())
    q, xf, dout = r(q), r(xf), r(dout)
    wk, wv, fc_delta, fc_gamma = r(wk), r(wv), [r(t) for t in fc_delta], [r(t) for t in fc_gamma]
    B, M, D = q.shape
    N, K = pxyz.shape[1], idx.shape[-1]
    w1, b1, w2, b2 = fc_delta
    g0, c0, g1, c1 = fc_gamma
    s = 1.0 / math.sqrt(D)
    b, m, j, valid = row_map(B, M, K)
    keep = valid.float()[:, None]  # spare rows: exact zeros in every gradient row
    grp = b * M + m                # the query of each row
    relu = torch.relu

    # the forward, rerun: kv projected once a cloud point (KB_KV), t1 and
    # delta (knn_bwd_t1_kernel), x and v + pos (KB_POS), h (KB_H)
    wkv = torch.cat([wk, wv], 1)
    kv = xf @ wkv
    src = idx[b, m, j].long()
    delta = r(qxyz[b, m] - pxyz[b, src])
    t1 = r(relu(delta @ w1 + b1))
    pos = t1 @ w2 + b2
    x = r(q[b, m] - kv[b, src, :D] + pos)
    vp = kv[b, src, D:] + pos
    h = r(relu(x @ g0 + c0))

    # KB_SMB: g, the per-column softmax over each query's real rows, o
    # recomputed, and the closed form dg = a dout (vp - o) s
    g = (h @ g1 + c1) * s
    mx = torch.full((B * M, D), -math.inf).scatter_reduce(
        0, grp[valid, None].expand(-1, D), g[valid], "amax")
    e = torch.exp(g - mx[grp]) * keep
    ssum = torch.zeros(B * M, D).index_add(0, grp, e)
    o = torch.zeros(B * M, D).index_add(0, grp, e * vp) / ssum
    a = e / ssum[grp]
    dvp = a * dout[b, m] * keep
    dg = r(dvp * (vp - o[grp]) * s)
    # KB_DA, KB_DX (dq a per-query sum), KB_DT1 (ddelta), knn_bwd_delta_kernel
    da = r((dg @ g1.t()) * (h > 0))
    dx = da @ g0.t()
    dq = torch.zeros(B * M, D).index_add(0, grp, dx).reshape(B, M, D)
    dpos = r(dx + dvp)
    dt1_f = (dpos @ w2.t()) * (t1 > 0)
    dt1 = r(dt1_f)
    ddelta = dt1_f @ w1.t()
    dqxyz = torch.zeros(B * M, 3).index_add(0, grp, ddelta).reshape(B, M, 3)

    # K7 over the rows [-dx | dvp | -ddelta], spare rows at index -1 (dropped),
    # then the products once a cloud point
    rows = torch.cat([-dx, dvp, -ddelta], 1)
    ridx = torch.where(valid, src, -1).to(torch.int32)
    E = rows.shape[0] // B
    sc = scatter.scatter_add_rows(rows.reshape(B, 1, E, -1), ridx.reshape(B, 1, E), N)
    skv = r(sc[..., :2 * D].reshape(B * N, 2 * D))
    dxf = (skv @ wkv.t()).reshape(B, N, D)
    dwkv = xf.reshape(B * N, D).t() @ skv
    return [dq, dqxyz, sc[..., 2 * D:], dxf, dwkv[:, :D], dwkv[:, D:],
            (delta * keep).t() @ dt1, dt1.sum(0), t1.t() @ dpos, dpos.sum(0),
            x.t() @ da, da.sum(0), h.t() @ dg, dg.sum(0)]


def _inputs(rs, B, M, N, D, self_attn):
    mk = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    a = [mk(B, M, D), mk(B, M, 3), mk(B, N, 3), mk(B, N, D), mk(D, D) / 8, mk(D, D) / 8,
         mk(3, D), mk(D), mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D)]
    if self_attn:  # one cloud: the queries' own points and fc1 features
        a[2], a[3] = a[1], mk(B, M, D)
    return a


@pytest.mark.parametrize("self_attn,K,M", [
    (False, 8, 1), (False, 8, 35), (False, 24, 1), (False, 24, 35),
    # one cloud: M = K is the fewest queries that have K neighbours
    (True, 8, 8), (True, 8, 35), (True, 24, 24), (True, 24, 35)])
def test_k6b_algebra_matches_jax_vjp(self_attn, K, M):
    """All 14 gradients of the row algebra against jax.vjp of the JAX K6, self
    and cross, K = 8 and 24 (24 leaves 8 spare rows a tile and does not divide
    32), one query (cross) and 35 (a part-filled last tile)."""
    import poem_v2_tpu.ops.pallas_knn_attn as pk

    rs = np.random.RandomState(100 * K + M + self_attn)
    B, N, D = 2, 96, 32
    a = _inputs(rs, B, M, M if self_attn else N, D, self_attn)
    ct = rs.randn(B, M, D).astype(np.float32)
    ja = [jnp.asarray(x) for x in a]
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(
            lambda q, qx, px, xf, wk, wv, fcd, fcg: pk.knn_vector_attention_trainable(
                q, qx, px, xf, wk, wv, fcd, fcg, K, 16, 4, True),
            *ja[:6], tuple(ja[6:10]), tuple(ja[10:]))
        g_j = jax.tree_util.tree_leaves(vjp(jnp.asarray(ct)))

    ts = [torch.from_numpy(x) for x in a]
    with torch.no_grad():
        _, idx = knn_attn.fused_knn_vector_attention(*ts[:6], ts[6:10], ts[10:], n_neighbor=K,
                                                     return_idx=True)
        grads = k6b_rows(*ts[:6], ts[6:10], ts[10:], idx, torch.from_numpy(ct))
    assert len(grads) == len(g_j) == 14
    for i, (g, gj) in enumerate(zip(grads, g_j)):
        gj = np.asarray(gj)
        assert g.shape == gj.shape, i
        scale = float(np.abs(np.asarray(g_j[12 if i == 13 else i])).max())
        err = float(np.abs(g.numpy() - gj).max())
        assert err <= REL * scale, f"gradient {i}: max abs err {err:.3e} > {REL * scale:.3e}"


@pytest.mark.parametrize("self_attn", [False, True])
def test_k6b_bf16_roundings_within_the_card_limit(self_attn):
    """With the kernel's bf16 rounding points the row algebra stays within 2e-2
    of each gradient's peak (the limit chip_smoke.py holds K6b to) of a float32
    autograd of K6's plain forward on the same bf16 inputs, which rounds at
    the same forward points and passes the roundings straight through: the
    backward's own roundings (dg, da, dpos, dt1, the scattered rows) cost
    little, and the forward's are the reference's too."""
    rs = np.random.RandomState(7 + self_attn)
    B, M, N, D, K = 2, 35, 96, 64, 24
    bf = torch.bfloat16
    ts = [torch.from_numpy(x) for x in _inputs(rs, B, M, M if self_attn else N, D, self_attn)]
    ts = [t.to(bf) if i in (0, 3) else t for i, t in enumerate(ts)]  # bf16 features, as the model
    dout = torch.from_numpy(rs.randn(B, M, D).astype(np.float32)).to(bf)
    with torch.no_grad():
        idx = knn_attn.fused_knn_vector_attention(*ts[:6], ts[6:10], ts[10:], n_neighbor=K,
                                                  return_idx=True)[1]
    leaves = [t.detach().requires_grad_() for t in ts]
    out = knn_attn.plain_fused_knn_vector_attention(*leaves[:6], leaves[6:10], leaves[10:],
                                                    n_neighbor=K, neighbor_idx=idx)
    ref = torch.autograd.grad(out, leaves, dout)
    f32 = [t.float() for t in ts]
    with torch.no_grad():
        got = k6b_rows(*f32[:6], f32[6:10], f32[10:], idx, dout.float(), dt=bf)
    for i, (g, w) in enumerate(zip(got, ref)):
        peak = float(ref[12 if i == 13 else i].float().abs().max())
        err = float((g - w.float()).abs().max())
        assert err <= 2e-2 * peak, f"gradient {i}: {err:.3e} > {2e-2 * peak:.3e}"


@pytest.mark.parametrize("M,K", [(1, 8), (35, 24), (3, 130)])
def test_row_map_covers_every_neighbour_once(M, K):
    """The layout: every (sample, query, neighbour) on exactly one real row, in
    core_rows(B, M, K) rows; K = 130 spans two tiles a query."""
    B = 2
    b, m, j, valid = row_map(B, M, K)
    assert len(b) == vector_attn.core_rows(B, M, K) and len(b) % CR == 0
    key = (b * M + m) * K + j
    assert torch.equal(torch.sort(key[valid]).values, torch.arange(B * M * K))


def test_wrapper_on_cpu_is_autograd_through_the_recompute():
    """On CPU tensors the wrapper is the plain version (autograd through
    attention_from_idx), honours ``needs`` and agrees with the row algebra."""
    rs = np.random.RandomState(5)
    B, M, N, D, K = 2, 9, 40, 32, 8
    ts = [torch.from_numpy(x) for x in _inputs(rs, B, M, N, D, False)]
    dout = torch.from_numpy(rs.randn(B, M, D).astype(np.float32))
    with torch.no_grad():
        _, idx = knn_attn.fused_knn_vector_attention(*ts[:6], ts[6:10], ts[10:], n_neighbor=K,
                                                     return_idx=True)
    needs = [True] * 14
    needs[2] = False  # a static cloud
    got = knn_attn.knn_vector_attention_trainable_bwd(*ts[:6], ts[6:10], ts[10:], idx, dout,
                                                      needs=needs)
    want = k6b_rows(*ts[:6], ts[6:10], ts[10:], idx, dout)
    assert got[2] is None
    for i, (g, w) in enumerate(zip(got, want)):
        if g is not None:
            scale = float(want[12 if i == 13 else i].abs().max())
            assert float((g - w).abs().max()) <= REL * scale, i
