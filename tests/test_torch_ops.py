"""Plain versions of the port's kernels and point / geometry ops vs the JAX package on the CPU.

The JAX side runs the Pallas kernels in interpret mode at the shapes of
tests/test_pallas_kernels.py, under ``default_matmul_precision("highest")``
(the CPU backend's default f32 matmul would round operands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.geometry.camera import invert_rigid, project_world_to_pixel
from poem_v2_tpu_torch.geometry.triangulation import jacobi_eigh_4x4, triangulate_dlt
from poem_v2_tpu_torch.ops import bilinear, cross_attn, knn_attn, points
from poem_v2_tpu_torch.ops.sampling import pixel_to_grid

from torch_port_helpers import look_at_cameras

# float32 on both sides; sums over <= 256 terms in other orders
ATOL = 1e-4


def _mk(rs):
    return lambda *s: rs.randn(*s).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _knn_inputs(seed, B, M, N, D, duplicate=False):
    rs = np.random.RandomState(seed)
    mk = _mk(rs)
    ptxyz = mk(B, N, 3)
    if duplicate:
        ptxyz = np.concatenate([ptxyz[:, : N // 2]] * 2, axis=1)  # every point twice: hard ties
    args = (mk(B, M, D), mk(B, M, 3), ptxyz, mk(B, N, D), mk(D, D) / 8, mk(D, D) / 8)
    fcd = (mk(3, D), mk(D), mk(D, D) / 8, mk(D))
    fcg = (mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D))
    return args, fcd, fcg


@pytest.mark.parametrize("case", [
    dict(seed=0, B=2, M=67, N=200, D=64, K=8),                  # packed keys
    dict(seed=3, B=1, M=16, N=64, D=32, K=8, duplicate=True),   # duplicate points: ties
    dict(seed=5, B=1, M=16, N=4200, D=32, K=8),                 # > 4096 points: argmin rounds
])
def test_fused_knn_vector_attention_matches_pallas(case):
    from poem_v2_tpu.ops.pallas_knn_attn import fused_knn_vector_attention as jax_knn

    K = case.pop("K")
    args, fcd, fcg = _knn_inputs(**case)
    with jax.default_matmul_precision("highest"):
        want, want_idx = jax_knn(*map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)),
                                 tuple(map(jnp.asarray, fcg)), n_neighbor=K, block_q=16,
                                 chunk_j=4, return_idx=True, interpret=True)
    got, idx = knn_attn.fused_knn_vector_attention(
        *_t(*args), _t(*fcd), _t(*fcg), n_neighbor=K, return_idx=True)
    assert idx.dtype == torch.int32 and idx.shape == want_idx.shape
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_fused_anchor_vector_attention_matches_pallas():
    from poem_v2_tpu.ops.pallas_knn_attn import fused_anchor_vector_attention as jax_anchor

    rs = np.random.RandomState(2)
    mk = _mk(rs)
    B, M, A, D = 2, 67, 8, 64
    args = (mk(B, M, D), mk(B, M, 3), mk(B, A, D), mk(B, A, D), mk(A, 3))
    fcd = (mk(3, D), mk(D), mk(D, D) / 8, mk(D))
    fcg = (mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D))
    with jax.default_matmul_precision("highest"):
        want = jax_anchor(*map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)),
                          tuple(map(jnp.asarray, fcg)), block_q=16, interpret=True)
    got = knn_attn.fused_anchor_vector_attention(*_t(*args), _t(*fcd), _t(*fcg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_dense_cross_attention_matches_pallas():
    from poem_v2_tpu.ops.pallas_cross_attn import dense_cross_attention as jax_dense

    rs = np.random.RandomState(4)
    B, M, N, H, nh = 2, 67, 130, 64, 4
    q, k, v = rs.randn(B, M, H), rs.randn(B, N, H), rs.randn(B, N, H)
    q, k, v = (a.astype(np.float32) for a in (q, k, v))
    with jax.default_matmul_precision("highest"):
        want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=nh,
                         sm_scale=0.25, interpret=True)
    got = cross_attn.dense_cross_attention(*_t(q, k, v), num_heads=nh, sm_scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def _sampler_inputs():
    rs = np.random.RandomState(5)
    B, H, W, C, N = 2, 8, 8, 32, 100
    feat = rs.randn(B, H, W, C).astype(np.float32)
    # far out-of-image points and exact cell borders included
    coords = np.concatenate([
        rs.uniform(-1.4, 1.4, (B, N - 4, 2)),
        np.array([[[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0], [-2.0, 0.5]]]).repeat(B, 0),
    ], axis=1).astype(np.float32)
    return feat, coords


def test_grid_sample_points_matches_f32_matmul_sampler():
    from poem_v2_tpu.ops.sampling import grid_sample_points_matmul

    feat, coords = _sampler_inputs()
    with jax.default_matmul_precision("highest"):
        want = grid_sample_points_matmul(jnp.asarray(feat), jnp.asarray(coords))
    got = bilinear.grid_sample_points(*_t(feat, coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_grid_sample_points_matches_pallas_within_its_bf16_taps():
    from poem_v2_tpu.ops.pallas_bilinear import grid_sample_points_fused

    feat, coords = _sampler_inputs()
    with jax.default_matmul_precision("highest"):
        want = grid_sample_points_fused(jnp.asarray(feat), jnp.asarray(coords), block_n=64,
                                        interpret=True)
    got = bilinear.grid_sample_points(*_t(feat, coords))
    # the TPU kernel rounds its tap weights to bf16 (8 mantissa bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3 * np.abs(feat).max())


def test_knn_points_and_fps_match_jax():
    from poem_v2_tpu.ops.points import farthest_point_sampling, knn_points

    rs = np.random.RandomState(7)
    q, p = rs.randn(2, 50, 3).astype(np.float32), rs.randn(2, 300, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        wd, wi, wn = knn_points(jnp.asarray(q), jnp.asarray(p), 16, approx=False)
        _, wf = farthest_point_sampling(jnp.asarray(p), 32)
    gd, gi, gn = points.knn_points(*_t(q, p), 16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    _, gf = points.farthest_point_sampling(torch.from_numpy(p), 32)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))


def test_camera_helpers_match_jax():
    from poem_v2_tpu.geometry import camera as jcam
    from poem_v2_tpu.ops.sampling import pixel_to_grid as jax_p2g

    rs = np.random.RandomState(8)
    intr, extr = look_at_cameras(rs, 2, 4, 256)
    pts = (rs.randn(2, 100, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    np.testing.assert_allclose(invert_rigid(torch.from_numpy(extr)).numpy(),
                               np.asarray(jcam.invert_rigid(jnp.asarray(extr))), atol=1e-6)
    want = jcam.project_world_to_pixel(jnp.asarray(pts), jnp.asarray(extr), jnp.asarray(intr))
    got = project_world_to_pixel(*_t(pts, extr, intr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)  # pixels, |uv| ~ 300
    np.testing.assert_allclose(pixel_to_grid(got, (256, 256)).numpy(),
                               np.asarray(jax_p2g(want, (256, 256))), atol=1e-5)


def test_triangulate_dlt_matches_jax():
    from poem_v2_tpu.geometry.camera import invert_rigid as j_inv, project_world_to_pixel as j_proj
    from poem_v2_tpu.geometry.triangulation import jacobi_eigh_4x4 as j_eigh
    from poem_v2_tpu.geometry.triangulation import triangulate_dlt as j_tri

    rs = np.random.RandomState(9)
    B, V, J = 3, 4, 21
    intr, extr = look_at_cameras(rs, B, V, 256)
    joints = (rs.randn(B, J, 3) * 0.04 + [0, 0, 0.5]).astype(np.float32)
    kp = np.asarray(j_proj(jnp.asarray(joints), jnp.asarray(extr), jnp.asarray(intr)))
    kp = kp + rs.randn(B, V, J, 2).astype(np.float32)  # 1 px noise
    mask = np.ones((B, V), bool)
    mask[1, 3] = mask[2, 2:] = False
    m2c = np.asarray(j_inv(jnp.asarray(extr)))
    want = j_tri(jnp.asarray(kp), jnp.asarray(intr), jnp.asarray(m2c), jnp.asarray(mask))
    got = triangulate_dlt(*_t(kp, intr, m2c, mask))
    # metres: float32 normal equations, the same Jacobi rotations in the same order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    a = rs.randn(5, 4, 4).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    wv, wvec = j_eigh(jnp.asarray(a))
    gv, gvec = jacobi_eigh_4x4(torch.from_numpy(a))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)
    np.testing.assert_allclose(gvec.numpy(), np.asarray(wvec), atol=1e-5)


def test_wrappers_refuse_unsupported_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused, never sampled on the CPU."""
    feat = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError):
        bilinear.grid_sample_points(feat, torch.zeros(1, 3, 2, device="meta"))
    with pytest.raises(ValueError):
        cross_attn.dense_cross_attention(*(torch.zeros(1, 5, 64, device="meta"),) * 3)
