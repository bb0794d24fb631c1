"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. Run on
the card with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the repo's conftest imports JAX, which the card's
machine does not have). Imports nothing of JAX.
"""

import math

import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.ops import bilinear, cross_attn, knn_attn

pytestmark = pytest.mark.cuda

# kernel vs plain version, relative to max|plain|: float32 differs by
# summation order only; bfloat16 also by which intermediates round where
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    tol = TOL[dtype] * max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol


def _mk(rs, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,N,D,K,dup", [(67, 200, 64, 8, False), (40, 64, 32, 16, True),
                                         (30, 4200, 128, 32, False), (799, 4096, 256, 32, False)])
def test_knn_vector_attention(cuda, dtype, M, N, D, K, dup):
    rs = np.random.RandomState(M + N)
    pt = _mk(rs, 2, N, 3)
    if dup:
        pt = torch.cat([pt[:, : N // 2]] * 2, 1)  # duplicate points: ties break to the lowest index
    args = [_mk(rs, 2, M, D).to(dtype), _mk(rs, 2, M, 3), pt, _mk(rs, 2, N, D).to(dtype),
            _mk(rs, D, D, scale=1 / math.sqrt(D)), _mk(rs, D, D, scale=1 / math.sqrt(D))]
    fcd = [_mk(rs, 3, D), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=1 / math.sqrt(D)),
           _mk(rs, D, scale=0.1)]
    fcg = [_mk(rs, D, D, scale=1 / math.sqrt(D)), _mk(rs, D, scale=0.1),
           _mk(rs, D, D, scale=1 / math.sqrt(D)), _mk(rs, D, scale=0.1)]
    want, widx = knn_attn.fused_knn_vector_attention(*args, fcd, fcg, n_neighbor=K,
                                                     return_idx=True)
    dev = lambda ts: [t.to(cuda) for t in ts]
    got, idx = knn_attn.fused_knn_vector_attention(*dev(args), dev(fcd), dev(fcg),
                                                   n_neighbor=K, return_idx=True)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu(), widx)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_anchor_vector_attention(cuda, dtype):
    rs = np.random.RandomState(1)
    B, M, A, D = 2, 799, 32, 256
    args = [_mk(rs, B, M, D).to(dtype), _mk(rs, B, M, 3), _mk(rs, B, A, D).to(dtype),
            _mk(rs, B, A, D).to(dtype), _mk(rs, A, 3)]
    fcd = [_mk(rs, 3, D), _mk(rs, D), _mk(rs, D, D, scale=1 / 16), _mk(rs, D)]
    fcg = [_mk(rs, D, D, scale=1 / 16), _mk(rs, D), _mk(rs, D, D, scale=1 / 16), _mk(rs, D)]
    want = knn_attn.fused_anchor_vector_attention(*args, fcd, fcg)
    dev = lambda ts: [t.to(cuda) for t in ts]
    got = knn_attn.fused_anchor_vector_attention(*dev(args), dev(fcd), dev(fcg))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_dense_cross_attention_head_dims(cuda, dtype, hd):
    rs = np.random.RandomState(hd)
    B, M, N, nh = 2, 133, 517, 4
    q, k, v = (_mk(rs, B, n, nh * hd).to(dtype) for n in (M, N, N))
    want = cross_attn.dense_cross_attention(q, k, v, num_heads=nh, sm_scale=hd ** -0.5)
    got = cross_attn.dense_cross_attention(q.to(cuda), k.to(cuda), v.to(cuda), num_heads=nh,
                                           sm_scale=hd ** -0.5)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_sample_points(cuda, dtype):
    rs = np.random.RandomState(5)
    feat = _mk(rs, 4, 16, 16, 256).to(dtype)
    coords = torch.from_numpy(rs.uniform(-1.3, 1.3, (4, 4096, 2)).astype(np.float32))
    coords[:, :4] = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0], [-2.0, 0.5]])
    want = bilinear.grid_sample_points(feat, coords)
    got = bilinear.grid_sample_points(feat.to(cuda), coords.to(cuda))
    _close(got, want, dtype)


def test_launch_counters_count_kernel_launches_only(cuda):
    rs = np.random.RandomState(6)
    feat, coords = _mk(rs, 1, 8, 8, 32), torch.zeros(1, 10, 2)
    before = bilinear.grid_sample_points.launches
    bilinear.grid_sample_points(feat, coords)                    # CPU: plain version
    assert bilinear.grid_sample_points.launches == before
    bilinear.grid_sample_points(feat.to(cuda), coords.to(cuda))  # CUDA: the kernel
    assert bilinear.grid_sample_points.launches == before + 1
