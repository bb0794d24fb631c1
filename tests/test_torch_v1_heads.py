"""The POEM v1 heads, ``ball_query`` and the 4-tap ``grid_sample_points`` of the port
against the JAX package, on the CPU.

Heads at ``tests/test_baselines.py``'s sizes (B2 of 3 views, 8 x 8 maps of 32
channels, embed 64, 128 ball points, depth 8, 2 blocks, K 8, radius 1 m; one
view masked in sample 1), converted weights at gain 0.5, JAX at "highest"
matmul precision. The decoder blocks take the gathered path
(``use_fused_knn=False``), which selects by full float32 distances as the JAX
v2 blocks do (``test_torch_decoder_v3.py`` says why). The ball-query points
lie on the frustum lattice, where neighbours tie exactly in real arithmetic
and the two packages' float32 distances (1 ulp apart in 13% of pairs) break
the ties differently, 9% of the neighbourhoods here; so both sides' blocks
select by :func:`_knn_float64` (float64 distances of the same float32
coordinates, lowest index first) in the head tests.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted

from poem_v2_tpu_torch.models.heads import v1_heads
from poem_v2_tpu_torch.ops.points import ball_query
from poem_v2_tpu_torch.ops.sampling import grid_sample_points

# metres, float32 through the frustum encoder, the sampler and 2 blocks
ATOL_M = 2e-5


def _ball_inputs(seed=0, B=2, M=4, N=300):
    rs = np.random.RandomState(seed)
    points = rs.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    centre = rs.uniform(-0.9, 0.9, (B, M, 3)).astype(np.float32)
    centre[0, 0] = [5.0, 5.0, 5.0]  # an empty ball
    return centre, points


@pytest.mark.parametrize("k,radius", [(16, 0.35), (40, 0.35), (8, 0.8)])
def test_ball_query_matches_jax(k, radius):
    """Nearest k in the ball, lowest index first on ties, -1 and zero xyz past the
    hits: the same indices and points as the JAX function, balls with fewer than
    k points (one empty) among them."""
    from poem_v2_tpu.ops.points import ball_query as jax_bq

    centre, points = _ball_inputs()
    with jax.default_matmul_precision("highest"):
        want_idx, want_xyz = (np.asarray(a) for a in jax_bq(jnp.asarray(centre),
                                                            jnp.asarray(points), k, radius))
    idx, xyz = ball_query(torch.from_numpy(centre), torch.from_numpy(points), k, radius)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(xyz.numpy(), want_xyz)
    hits = (want_idx >= 0).sum(-1)
    assert hits[0, 0] == 0 and hits.max() > 0
    if k == 40:
        assert (hits < k).any()


def test_ball_query_with_a_generator_draws_points_of_the_ball():
    """Random hits: inside the radius, distinct, as many as min(k, points in the
    ball), -1 only past them; the same generator state gives the same draw."""
    centre, points = _ball_inputs(seed=1)
    k, radius = 24, 0.4
    c, p = torch.from_numpy(centre), torch.from_numpy(points)
    idx, xyz = ball_query(c, p, k, radius, generator=torch.Generator().manual_seed(5))
    idx2, _ = ball_query(c, p, k, radius, generator=torch.Generator().manual_seed(5))
    near, _ = ball_query(c, p, k, radius)
    assert torch.equal(idx, idx2) and not torch.equal(idx, near)
    d2 = ((centre[:, :, None] - points[:, None]) ** 2).sum(-1)
    for b in range(idx.shape[0]):
        for m in range(idx.shape[1]):
            row = idx[b, m].numpy()
            n_in = int((d2[b, m] <= radius * radius).sum())
            n_hit = min(k, n_in)
            assert (row[:n_hit] >= 0).all() and (row[n_hit:] == -1).all()
            assert len(set(row[:n_hit].tolist())) == n_hit
            assert (d2[b, m, row[:n_hit]] <= radius * radius * (1 + 1e-6)).all()
            np.testing.assert_array_equal(xyz[b, m, :n_hit].numpy(), points[b, row[:n_hit]])
            assert (xyz[b, m, n_hit:] == 0).all()


def test_grid_sample_points_matches_jax():
    from poem_v2_tpu.ops.sampling import grid_sample_points as jax_gs

    rs = np.random.RandomState(2)
    feat = rs.randn(3, 7, 9, 5).astype(np.float32)
    coords = rs.uniform(-1.2, 1.2, (3, 50, 2)).astype(np.float32)
    coords[0, :4] = [[-1, -1], [1, 1], [0, 0], [-1.0 + 1.0 / 9, -1.0 + 1.0 / 7]]
    want = np.asarray(jax_gs(jnp.asarray(feat), jnp.asarray(coords)))
    got = grid_sample_points(torch.from_numpy(feat), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ref = torch.nn.functional.grid_sample(
        torch.from_numpy(feat).permute(0, 3, 1, 2), torch.from_numpy(coords)[:, :, None],
        align_corners=False)[..., 0].permute(0, 2, 1)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, rtol=0)


def _knn_float64(query, points, k):
    """(d2, idx, nn_xyz) of the K nearest by float64 distances, ties to the lowest index."""
    q, p = np.asarray(query, np.float64), np.asarray(points, np.float64)
    d2 = ((q[:, :, None] - p[:, None]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(d2, idx, -1).astype(np.float32), idx


@contextlib.contextmanager
def common_selection():
    """Both packages' v2 blocks select neighbours by :func:`_knn_float64`."""
    import poem_v2_tpu.models.bricks.point_transformer as jpt
    import poem_v2_tpu_torch.models.bricks.point_transformer as tpt
    from poem_v2_tpu.ops.points import index_points as jax_index
    from poem_v2_tpu_torch.ops.points import index_points as torch_index

    def jax_knn(query, points, k, approx=False):
        d2, idx = _knn_float64(query, points, k)
        idx = jnp.asarray(idx, jnp.int32)
        return jnp.asarray(d2), idx, jax_index(points, idx)

    def torch_knn(query, points, k):
        d2, idx = _knn_float64(query.detach(), points.detach(), k)
        idx = torch.from_numpy(idx)
        return torch.from_numpy(d2), idx, torch_index(points, idx)

    saved = jpt.knn_points, tpt.knn_points
    jpt.knn_points, tpt.knn_points = jax_knn, torch_knn
    try:
        yield
    finally:
        jpt.knn_points, tpt.knn_points = saved


def _head_inputs():
    rs = np.random.RandomState(3)
    B, V, H, W = 2, 3, 8, 8
    feat = rs.randn(B, V, H, W, 32).astype(np.float32)
    vm = np.array([[True, True, True], [True, True, False]])
    intr = np.broadcast_to(np.array([[200.0, 0, 32], [0, 200.0, 32], [0, 0, 1]], np.float32),
                           (B, V, 3, 3)).copy()
    extr = np.broadcast_to(np.eye(4, dtype=np.float32), (B, V, 4, 4)).copy()
    extr[:, 1, :3, 3] = [0.05, 0.0, 0.0]
    extr[:, 2, :3, 3] = [0.0, -0.04, 0.02]
    ref = (rs.randn(B, 799, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    template = (rs.randn(799, 3) * 0.05).astype(np.float32)
    return feat, vm, intr, extr, ref, template


KW = dict(embed_dims=64, pt_feat_dim=64, in_channels=32, nsample=128, depth_num=8,
          pe_num_feats=16, n_blocks=2, n_neighbor=8, n_neighbor_query=8, radius=1.0)


def _run_pair(jhead, thead, args, extra=()):
    rng = jax.random.PRNGKey(0)
    jargs = [jnp.asarray(a) for a in args] + [(64, 64)] + [jnp.asarray(e) for e in extra]
    shapes = jax.eval_shape(lambda: jhead.init(rng, *jargs))
    variables = fill_params(shapes, gain=0.5)
    with jax.default_matmul_precision("highest"), common_selection():
        want = np.asarray(jhead.apply(variables, *jargs)["all_coords_preds"])
    load_converted(thead, variables)
    with torch.no_grad(), common_selection():
        got = thead(*(torch.from_numpy(a) for a in args), (64, 64),
                    *(torch.from_numpy(e) for e in extra))["all_coords_preds"].numpy()
    assert got.shape == want.shape == (2, 2, 799, 3)
    np.testing.assert_allclose(got, want, atol=ATOL_M, rtol=0)


@pytest.mark.parametrize("center_shift", [False, True])
def test_position_embedded_aggregation_head_matches_jax(center_shift):
    from poem_v2_tpu.models.heads.v1_heads import POEMPositionEmbeddedAggregationHead as J

    kw = dict(KW, center_shift=center_shift)
    thead = v1_heads.POEMPositionEmbeddedAggregationHead(**kw, use_fused_knn=False).eval()
    _run_pair(J(**kw), thead, _head_inputs())


@pytest.mark.parametrize("merge_mode", ["attn", "sum"])
@pytest.mark.parametrize("query_type", ["POEM", "KPT", "MVP", "METRO"])
def test_projective_self_aggregation_head_matches_jax(merge_mode, query_type):
    """Both merge modes and the four query types (MVP and METRO with per-view
    global features of width 16)."""
    from poem_v2_tpu.models.heads.v1_heads import POEMProjectiveSelfAggregationHead as J

    kw = dict(KW, merge_mode=merge_mode, query_type=query_type)
    needs_g = query_type in ("MVP", "METRO")
    extra = (np.random.RandomState(4).randn(2, 3, 16).astype(np.float32),) if needs_g else ()
    thead = v1_heads.POEMProjectiveSelfAggregationHead(
        **kw, global_feat_dim=16 if needs_g else None, use_fused_knn=False).eval()
    _run_pair(J(**kw), thead, _head_inputs(), extra)
    assert hasattr(thead, "layer_global_feat") == needs_g
