"""The port's voxel-bucket KNN (``ops/points.py:VoxelBucketTable``,
``knn_points_bucketed``) against the JAX package, on the CPU.

Tolerances: the host table equal array for array; the ranking the same indices
(ties to the lowest position in the cell's candidate list, as ``lax.top_k``) and
the same distances to float32 rounding (5e-7 relative: XLA sums the three squares
in another order), in the exact mode and with ``approx=True``
(which the JAX package's ``approx_max_k`` ranks exactly on the CPU and the port
always does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu.ops import points as jpoints
from poem_v2_tpu_torch.models.heads.ptemb_head import generate_bps_basis
from poem_v2_tpu_torch.ops import points as tpoints


def _bps():
    return generate_bps_basis(4096, 0.1) / 0.1  # the normalised ball of radius 1


def _duplicated():
    """512 BPS points, each twice, 40 of them a third time: exact distance ties."""
    base = _bps()[:512]
    return np.concatenate([base, base, base[:40]]).astype(np.float32)


def _queries(seed, B=2, Q=799):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Q, 3).astype(np.float32) * 0.5
    q[0, :10] *= 3.0  # some outside the table's margin: clamped to the border cells
    return q


def _tables(cloud, **kw):
    return jpoints.VoxelBucketTable(cloud, **kw), tpoints.VoxelBucketTable(cloud, **kw)


@pytest.mark.parametrize("cloud,kw", [(_bps, {}), (_bps, dict(cell_size=0.25)),
                                      (_duplicated, dict(cell_size=0.3, width=200))])
def test_table_equals_jax(cloud, kw):
    jt, tt = _tables(cloud(), **kw)
    for name in ("cloud", "origin", "dims", "table"):
        a, b = getattr(tt, name), getattr(jt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tt.width == jt.width and tt.cell_size == jt.cell_size


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("cloud,kw,k", [(_bps, dict(cell_size=0.25), 32),
                                        (_duplicated, dict(cell_size=0.3, width=200), 16)])
def test_ranking_equals_jax(cloud, kw, k, approx):
    pts = cloud()
    jt, tt = _tables(pts, **kw)
    q = _queries(1)
    fn = jax.jit(lambda x: jpoints.knn_points_bucketed(x, jt, k, approx=approx))
    d_want, i_want, nn_want = (np.asarray(a) for a in fn(jnp.asarray(q)))
    d_got, i_got, nn_got = tpoints.knn_points_bucketed(torch.from_numpy(q), tt, k, approx=approx)
    assert i_got.dtype == torch.int64
    np.testing.assert_array_equal(i_got.numpy(), i_want)
    np.testing.assert_allclose(d_got.numpy(), d_want, rtol=5e-7, atol=0)
    np.testing.assert_array_equal(nn_got.numpy(), nn_want)
    if cloud is _duplicated:  # ties exist, and the same index broke them
        tied = (np.diff(d_want, axis=-1) == 0).any(-1)
        assert tied.mean() > 0.5


def test_matches_brute_force_inside_the_margin():
    """Queries well inside the cloud: the bucketed neighbours' distances are the
    brute-force KNN's (the table's coverage contract)."""
    pts = _bps()
    _, tt = _tables(pts, cell_size=0.25)
    q = torch.from_numpy(np.random.RandomState(2).randn(2, 300, 3).astype(np.float32) * 0.3)
    d_b, _, _ = tpoints.knn_points_bucketed(q, tt, 32)
    d_ref, _, _ = tpoints.knn_points(q, torch.from_numpy(pts)[None].expand(2, -1, -1), 32)
    np.testing.assert_allclose(d_b.numpy(), d_ref.numpy(), rtol=1e-5, atol=1e-6)
