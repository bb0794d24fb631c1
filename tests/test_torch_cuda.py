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

from poem_v2_tpu_torch.ops import (bilinear, cross_attn, knn_attn, points, scatter, scramble, select,
                                   vector_attn)

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
                                         (30, 4200, 128, 32, False), (799, 4096, 256, 32, False),
                                         # wide tiers: 16 rows a block above D = 256, where
                                         # K = 32 is folded in two chunks, K = 16 in one, and
                                         # K = 8 puts two queries in a block
                                         (799, 4096, 512, 32, False), (203, 1000, 1024, 32, False),
                                         (65, 300, 1024, 16, False), (41, 100, 1024, 8, True),
                                         # any K: bf16 tiles of 128 rows hold floor(128 / K)
                                         # queries, K > 128 spans tiles; one query
                                         (67, 200, 64, 3, False), (65, 600, 256, 24, False),
                                         (65, 600, 256, 48, False), (65, 600, 256, 64, False),
                                         (1, 600, 256, 24, False), (65, 600, 1024, 48, False),
                                         (9, 400, 64, 200, False)])
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
@pytest.mark.parametrize("D,K", [(256, 32), (1024, 24)])
def test_knn_vector_attention_from_neighbor_idx(cuda, dtype, D, K):
    """K1 fed with its own returned indices gives the selecting call's bits,
    and counts one launch."""
    rs = np.random.RandomState(D + K)
    B, M, N = 2, 300, 2000
    s = 1 / math.sqrt(D)
    args = [_mk(rs, B, M, D).to(dtype), _mk(rs, B, M, 3), _mk(rs, B, N, 3),
            _mk(rs, B, N, D).to(dtype), _mk(rs, D, D, scale=s), _mk(rs, D, D, scale=s)]
    fcd, fcg = _attn_mlps(rs, D)
    dev = lambda ts: [t.to(cuda) for t in ts]
    args, fcd, fcg = dev(args), dev(fcd), dev(fcg)
    got, idx = knn_attn.fused_knn_vector_attention(*args, fcd, fcg, n_neighbor=K,
                                                   return_idx=True)
    before = knn_attn.fused_knn_vector_attention.launches
    again = knn_attn.fused_knn_vector_attention(*args, fcd, fcg, n_neighbor=K,
                                                neighbor_idx=idx.long())
    torch.cuda.synchronize()
    assert knn_attn.fused_knn_vector_attention.launches == before + 1
    assert torch.equal(again, got)
    with pytest.raises(ValueError, match="exclude"):
        knn_attn.fused_knn_vector_attention(*args, fcd, fcg, n_neighbor=K, neighbor_idx=idx,
                                            return_idx=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,A,M", [(128, 32, 799), (256, 32, 799), (512, 32, 799),
                                   (1024, 32, 799), (256, 3, 65), (256, 24, 65), (256, 48, 1),
                                   (256, 64, 65), (1024, 24, 65)])
def test_anchor_vector_attention(cuda, dtype, D, A, M):
    rs = np.random.RandomState(1)
    B = 2
    args = [_mk(rs, B, M, D).to(dtype), _mk(rs, B, M, 3), _mk(rs, B, A, D).to(dtype),
            _mk(rs, B, A, D).to(dtype), _mk(rs, A, 3)]
    s = 1 / math.sqrt(D)
    fcd = [_mk(rs, 3, D), _mk(rs, D), _mk(rs, D, D, scale=s), _mk(rs, D)]
    fcg = [_mk(rs, D, D, scale=s), _mk(rs, D), _mk(rs, D, D, scale=s), _mk(rs, D)]
    want = knn_attn.fused_anchor_vector_attention(*args, fcd, fcg)
    dev = lambda ts: [t.to(cuda) for t in ts]
    got = knn_attn.fused_anchor_vector_attention(*dev(args), dev(fcd), dev(fcg))
    _close(got, want, dtype)


# (B, M, N): rows and keys that no tile of 64 or 128 divides, one row, one sample
RAGGED = [(2, 133, 517), (1, 1, 64), (1, 63, 100), (2, 65, 4100), (1, 799, 4100)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,M,N", RAGGED)
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_dense_cross_attention_head_dims(cuda, dtype, hd, B, M, N):
    """K3's output and row logsumexp (1e-5 absolute) against the plain versions."""
    rs = np.random.RandomState(hd)
    nh, scale = 4, hd ** -0.5
    q, k, v = (_mk(rs, B, n, nh * hd).to(dtype) for n in (M, N, N))
    want = cross_attn.dense_cross_attention(q, k, v, num_heads=nh, sm_scale=scale)
    got = cross_attn.dense_cross_attention(q.to(cuda), k.to(cuda), v.to(cuda), num_heads=nh,
                                           sm_scale=scale)
    _close(got, want, dtype)
    with torch.no_grad():
        again, lse = cross_attn.dense_cross_attention_forward(q.to(cuda), k.to(cuda), v.to(cuda),
                                                              nh, scale, return_lse=True)
    assert torch.equal(again, got) and lse.dtype == torch.float32
    want_lse = cross_attn.plain_dense_cross_attention_lse(q, k, nh, scale)
    assert float((lse.cpu() - want_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_cross_attention_noncontiguous_inputs(cuda, dtype):
    """Strided views are copied by the wrappers: the same bits as from contiguous copies."""
    rs = np.random.RandomState(3)
    wide = [_mk(rs, 2, n, 512).to(dtype).to(cuda) for n in (70, 300, 300, 70)]
    q, k, v, do = (t[..., ::2] for t in wide)          # every other column
    assert not q.is_contiguous()
    cq, ck, cv, cdo = (t.contiguous() for t in (q, k, v, do))
    with torch.no_grad():
        out = cross_attn.dense_cross_attention(q, k, v, 4, 0.125)
        assert torch.equal(out, cross_attn.dense_cross_attention(cq, ck, cv, 4, 0.125))
    for a, b in zip(cross_attn.dense_cross_attention_bwd(q, k, v, do, 4, 0.125),
                    cross_attn.dense_cross_attention_bwd(cq, ck, cv, cdo, 4, 0.125)):
        assert torch.equal(a, b)


def test_dense_cross_attention_bf16_shapes_it_rejects(cuda):
    """float32 takes head dim 48; bfloat16 raises there and on unaligned tensors."""
    rs = np.random.RandomState(48)
    q, k, v = (_mk(rs, 2, n, 4 * 48).to(cuda) for n in (40, 300, 300))
    _close(cross_attn.dense_cross_attention(q, k, v, 4, 48 ** -0.5),
           cross_attn.plain_dense_cross_attention(q, k, v, 4, 48 ** -0.5), torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        cross_attn.dense_cross_attention(*(t.bfloat16() for t in (q, k, v)), 4, 48 ** -0.5)
    flat = _mk(rs, 2 * 40 * 256 + 1).to(cuda).bfloat16()
    q = flat[1:].view(2, 40, 256)  # 2-byte offset: contiguous but not 16-byte aligned
    k, v = (_mk(rs, 2, 300, 256).to(cuda).bfloat16() for _ in range(2))
    with pytest.raises(ValueError, match="aligned"):
        cross_attn.dense_cross_attention(q, k, v, 4, 0.125)
    # the backward's tensor maps need the same of the cotangent and the saved output
    q = _mk(rs, 2, 40, 256).to(cuda).bfloat16()
    out, lse = cross_attn.dense_cross_attention_forward(q, k, v, 4, 0.125, return_lse=True)
    odd = flat[1:].view(2, 40, 256)
    with pytest.raises(ValueError, match="aligned"):
        cross_attn.dense_cross_attention_bwd(q, k, v, odd, 4, 0.125, out=out, lse=lse)
    with pytest.raises(ValueError, match="aligned"):
        cross_attn.dense_cross_attention_bwd(q, k, v, out, 4, 0.125, out=odd, lse=lse)
    with pytest.raises(ValueError, match="lse"):
        cross_attn.dense_cross_attention_bwd(q, k, v, out, 4, 0.125, out=out, lse=lse[:, :2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_sample_points(cuda, dtype):
    rs = np.random.RandomState(5)
    feat = _mk(rs, 4, 16, 16, 256).to(dtype)
    coords = torch.from_numpy(rs.uniform(-1.3, 1.3, (4, 4096, 2)).astype(np.float32))
    coords[:, :4] = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0], [-2.0, 0.5]])
    want = bilinear.grid_sample_points(feat, coords)
    got = bilinear.grid_sample_points(feat.to(cuda), coords.to(cuda))
    _close(got, want, dtype)


def _sampler_case(rs, B, H, W, C, N, dtype, cuda):
    feat = _mk(rs, B, H, W, C).to(dtype).to(cuda)
    coords = torch.from_numpy(rs.uniform(-1.2, 1.2, (B, N, 2)).astype(np.float32))
    # cell corners and borders, the centre, far off the map
    fixed = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0], [-2.0, 0.5],
                          [1.0 - 1.0 / W, -1.0 + 3.0 / H], [0.5, 1.0]])
    coords[:, :len(fixed)] = fixed[:N]
    return feat, coords.to(cuda)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,C,N", [
    (32, 16, 16, 128, 4096), (32, 16, 16, 256, 4096), (32, 16, 16, 512, 4096),
    (32, 16, 16, 1024, 4096), (128, 16, 16, 256, 4096),   # the tiers' widths, medium's B16
    (3, 12, 20, 24, 4099), (2, 16, 16, 6, 1000), (1, 1, 1, 8, 1)])  # ragged, whole elements
def test_grid_sample_points_bit_identical(cuda, dtype, B, H, W, C, N):
    """K4 equals its plain version bit for bit (the same float32 operations in
    the same order), on the card."""
    feat, coords = _sampler_case(np.random.RandomState(C + N), B, H, W, C, N, dtype, cuda)
    got = bilinear.grid_sample_points(feat, coords)
    assert got.dtype == dtype and torch.equal(got, bilinear.plain_grid_sample_points(feat, coords))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_sample_points_direct_and_unaligned_maps(cuda, dtype):
    """A 128 x 128 map whose slice of one 16-byte unit a cell does not fit in
    shared memory reads its taps directly; a map 2 or 4 bytes off 16 takes
    one-element units. Both bit-identical to the plain version."""
    rs = np.random.RandomState(9)
    feat, coords = _sampler_case(rs, 2, 128, 128, 64, 2000, dtype, cuda)
    assert bilinear.sampler_geometry(2, 128, 128, 64, 2000, feat.element_size()).direct
    want = bilinear.plain_grid_sample_points(feat, coords)
    assert torch.equal(bilinear.grid_sample_points(feat, coords), want)
    flat = torch.empty(feat.numel() + 1, dtype=dtype, device=cuda)
    shifted = flat[1:].view(feat.shape)
    shifted.copy_(feat)
    assert shifted.data_ptr() % 16 and torch.equal(bilinear.grid_sample_points(shifted, coords),
                                                   want)


def test_launch_counters_count_kernel_launches_only(cuda):
    rs = np.random.RandomState(6)
    feat, coords = _mk(rs, 1, 8, 8, 32), torch.zeros(1, 10, 2)
    before = bilinear.grid_sample_points.launches
    bilinear.grid_sample_points(feat, coords)                    # CPU: plain version
    assert bilinear.grid_sample_points.launches == before
    bilinear.grid_sample_points(feat.to(cuda), coords.to(cuda))  # CUDA: the kernel
    assert bilinear.grid_sample_points.launches == before + 1


def _grads_close(got, want, dtype):
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,M,N", RAGGED)
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_dense_cross_attention_backward_head_dims(cuda, dtype, hd, B, M, N):
    """K3b against autograd through the plain version at shapes no tile divides:
    from the forward's saved (out, lse), a second launch and a call without
    the saved pair bit for bit the same."""
    rs = np.random.RandomState(hd + 1)
    nh, scale = 4, hd ** -0.5
    q, k, v, do = (_mk(rs, B, n, nh * hd).to(dtype) for n in (M, N, N, M))
    want = cross_attn.plain_dense_cross_attention_bwd(q, k, v, do, nh, scale)
    dev = [t.to(cuda) for t in (q, k, v, do)]
    out, lse = cross_attn.dense_cross_attention_forward(*dev[:3], nh, scale, return_lse=True)
    before = cross_attn.dense_cross_attention_bwd.launches
    got = cross_attn.dense_cross_attention_bwd(*dev, nh, scale, out=out, lse=lse)
    again = cross_attn.dense_cross_attention_bwd(*dev, nh, scale, out=out, lse=lse)
    alone = cross_attn.dense_cross_attention_bwd(*dev, nh, scale)
    torch.cuda.synchronize()
    # the stats, dq and dkv kernels of one call count as one launch of K3b
    assert cross_attn.dense_cross_attention_bwd.launches == before + 3
    _grads_close(got, want, dtype)
    for a, b, c in zip(got, again, alone):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_dense_cross_attention_head_dim_16_keeps_columns_in_place(cuda):
    """bf16 head dim 16 (the synthetic ResNet models' 4 heads of 16; 32-byte
    swizzled tiles): with q, k scaled column by column and each value column
    near its own index, a column that the tensor maps and the descriptors read
    swizzled differently would show as a wrong column's value; K3 and K3b
    against their plain versions, lse to 1e-5, one launch each, K3b twice alike."""
    rs = np.random.RandomState(16)
    nh, hd, scale = 4, 16, 0.25
    cols = torch.linspace(0.25, 2.0, nh * hd)
    q, k = ((_mk(rs, 4, n, nh * hd) * cols).bfloat16() for n in (799, 256))
    v = (torch.arange(nh * hd).float() + 0.01 * _mk(rs, 4, 256, nh * hd)).bfloat16()
    do = _mk(rs, 4, 799, nh * hd).bfloat16()
    dev = [t.to(cuda) for t in (q, k, v, do)]
    before = (cross_attn.dense_cross_attention.launches,
              cross_attn.dense_cross_attention_bwd.launches)
    out, lse = cross_attn.dense_cross_attention_forward(*dev[:3], nh, scale, return_lse=True)
    grads = cross_attn.dense_cross_attention_bwd(*dev, nh, scale, out=out, lse=lse)
    again = cross_attn.dense_cross_attention_bwd(*dev, nh, scale, out=out, lse=lse)
    torch.cuda.synchronize()
    assert (cross_attn.dense_cross_attention.launches,
            cross_attn.dense_cross_attention_bwd.launches) == (before[0] + 1, before[1] + 2)
    # every output column is a convex mix of its own value column: within 0.5 of its
    # index (bfloat16 rounds 63 by up to 0.125; a neighbouring column is 1 away)
    assert float((out.float().cpu() - torch.arange(nh * hd).float()).abs().max()) < 0.5
    _close(out, cross_attn.plain_dense_cross_attention(q, k, v, nh, scale), torch.bfloat16)
    want_lse = cross_attn.plain_dense_cross_attention_lse(q, k, nh, scale)
    assert float((lse.cpu() - want_lse).abs().max()) <= 1e-5
    _grads_close(grads, cross_attn.plain_dense_cross_attention_bwd(q, k, v, do, nh, scale),
                 torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_dense_cross_attention_function_grads(cuda):
    """Gradients through the autograd Function on the card reach q, k and v."""
    rs = np.random.RandomState(2)
    q, k, v = (_mk(rs, 2, n, 256).to(cuda).requires_grad_() for n in (40, 300, 300))
    out = cross_attn.dense_cross_attention(q, k, v, 4, 0.125)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad((cross_attn.plain_dense_cross_attention(qc, kc, vc, 4, 0.125) ** 2)
                               .sum(), (qc, kc, vc))
    _grads_close(grads, want, torch.float32)


def test_dense_cross_attention_grads_under_autocast_in_checkpointed_blocks(cuda, monkeypatch):
    """The training decoder under bfloat16 autocast, every block checkpointed:
    K3 runs 6 times and K3b 6 times a step, the recompute replays the saved
    (out, lse) pairs, and the gradients are finite and the same bits as
    without checkpointing."""
    from poem_v2_tpu_torch.models import decoder
    from poem_v2_tpu_torch.models.decoder import PtEmbedDecoder

    rs = np.random.RandomState(9)
    B, M, N, D = 2, 100, 300, 128
    args = [_mk(rs, B, M, 3, scale=0.3).to(cuda), _mk(rs, B, M, D).to(cuda),
            _mk(rs, B, N, 3, scale=0.3).to(cuda), _mk(rs, B, N, D).to(cuda)]
    aidx = torch.arange(8, device=cuda)
    results = {}
    for use_remat in (True, False):
        if not use_remat:
            monkeypatch.setattr(decoder, "checkpoint", lambda fn, *a, **kw: fn(*a))
        torch.manual_seed(0)
        dec = PtEmbedDecoder(n_blocks=3, hidden_size=D, num_heads=4, n_neighbor=8,
                             n_neighbor_query=8, dropout=0.0).to(cuda).train()
        k3, k3b = cross_attn.dense_cross_attention.launches, \
            cross_attn.dense_cross_attention_bwd.launches
        with torch.autocast("cuda", dtype=torch.bfloat16):
            coords, _, _ = dec(*args, aidx, aidx, None)
        grads = torch.autograd.grad((coords.float() ** 2).sum(), list(dec.parameters()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        assert cross_attn.dense_cross_attention.launches == k3 + 6
        assert cross_attn.dense_cross_attention_bwd.launches == k3b + 6
        results[use_remat] = grads
    for a, b in zip(results[True], results[False]):
        assert (a is None and b is None) or (torch.isfinite(a).all() and torch.equal(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_rows,lo,hi", [(4096, 0, 4096), (799, 0, 799), (799, 5, 6),
                                          (4096, 100, 116)])
def test_scatter_add_rows(cuda, dtype, n_rows, lo, hi):
    """K7 against index_add_ (float32 on the CPU), with spread, all-duplicate
    (one row takes every entry) and heavily duplicated indices; a repeat
    launch gives the same bits."""
    rs = np.random.RandomState(n_rows + lo)
    B, M, K, D = 2, 799, 32, 256
    g = _mk(rs, B, M, K, D).to(dtype)
    idx = torch.from_numpy(rs.randint(lo, hi, (B, M, K)).astype(np.int32))
    want = scatter.plain_scatter_add_rows(g, idx, n_rows)
    got = scatter.scatter_add_rows(g.to(cuda), idx.to(cuda), n_rows)
    again = scatter.scatter_add_rows(g.to(cuda), idx.to(cuda), n_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, want, torch.float32)


def _k6_args(rs, B, M, N, D, dtype, self_attn=False):
    """K6's 14 inputs (features in ``dtype``, xyz and weights float32) and a
    cotangent in ``dtype``; self attention: one cloud, the queries' points."""
    s = 1 / math.sqrt(D)
    qxyz = _mk(rs, B, M, 3)
    pxyz, n = (qxyz, M) if self_attn else (_mk(rs, B, N, 3), N)
    args = [_mk(rs, B, M, D).to(dtype), qxyz, pxyz, _mk(rs, B, n, D).to(dtype),
            _mk(rs, D, D, scale=s), _mk(rs, D, D, scale=s),
            _mk(rs, 3, D), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=s), _mk(rs, D, scale=0.1),
            _mk(rs, D, D, scale=s), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=s),
            _mk(rs, D, scale=0.1)]
    return args, _mk(rs, B, M, D).to(dtype)


def _peak(grads, i):
    # fc_gamma's output bias shifts every neighbour of a channel alike: its exact
    # gradient is 0, so it is held to the scale of g1's gradient instead
    return float(grads[12 if i == 13 else i].float().abs().max())


# K6b's bf16 gradients: against a float32 autograd of K6's plain forward (K1's
# plain version, its roundings to bf16 passed straight through) on the same
# inputs, within the larger of the bf16 recompute's error (the backward K6b
# replaced, every operation in bf16) and this share of the peak
K6B_BF16_REL = 2e-2


def _hold_bf16_grads(got, args, idx, dout, plain):
    """``got`` (bf16 run) against the float32 gradients of K6's plain forward
    at ``args``, each within the larger of the bf16 ``plain`` backward's error
    and K6B_BF16_REL of its peak."""
    leaves = [a.detach().requires_grad_() for a in args]
    out = knn_attn.plain_fused_knn_vector_attention(
        *leaves[:6], leaves[6:10], leaves[10:], n_neighbor=idx.shape[-1], neighbor_idx=idx)
    ref = torch.autograd.grad(out, leaves, dout.to(out.dtype))
    rec = plain(args, idx, dout)
    for i, (g, r, w) in enumerate(zip(got, rec, ref)):
        g, r, w = g.float().cpu(), r.float().cpu(), w.float().cpu()
        lim = max(float((r - w).abs().max()), K6B_BF16_REL * _peak(ref, i))
        assert torch.isfinite(g).all() and float((g - w).abs().max()) <= lim, i


@pytest.mark.parametrize("dtype", DTYPES)
def test_knn_vector_attention_trainable_grads(cuda, dtype):
    """K6: value and the gradients of all 14 inputs against the same Function
    on the CPU (the plain K1 forward, autograd through the plain recompute,
    the plain K7). On the card the backward is K6b: in float32 the two differ
    by summation order; in bf16 K6b computes in float32 from bf16 operands
    while the CPU's recompute runs in bf16, so the gradients are held against
    the float32 plain version at the same bf16-rounded inputs, as
    ``_hold_bf16_grads`` says."""
    rs = np.random.RandomState(9)
    B, M, N, D, K = 2, 150, 600, 64, 16
    args, _ = _k6_args(rs, B, M, N, D, dtype)
    ct = _mk(rs, B, M, D)

    def run(ts):
        ts = [t.clone().requires_grad_() for t in ts]
        out = knn_attn.knn_vector_attention_trainable(*ts[:6], ts[6:10], ts[10:], n_neighbor=K)
        return out, torch.autograd.grad((out.float() * ct.to(out.device)).sum(), ts)

    want, gw = run(args)
    got, gg = run([a.to(cuda) for a in args])
    torch.cuda.synchronize()
    _close(got, want, dtype)
    if dtype == torch.float32:
        for i, (g, w) in enumerate(zip(gg, gw)):
            assert float((g.cpu() - w).abs().max()) <= 1e-4 * _peak(gw, i), i
        return
    with torch.no_grad():
        idx = knn_attn.fused_knn_vector_attention(*args[:6], args[6:10], args[10:],
                                                  n_neighbor=K, return_idx=True)[1]
    plain = lambda ts, i, d: knn_attn.plain_knn_vector_attention_trainable_bwd(
        *ts[:6], ts[6:10], ts[10:], i, d)
    _hold_bf16_grads(gg, args, idx, ct.to(dtype), plain)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,D,self_attn", [
    (65, 8, 256, False), (65, 24, 256, False), (65, 48, 128, False), (1, 24, 256, False),
    (33, 32, 256, True), (20, 16, 512, True), (7, 130, 128, False), (9, 200, 256, False),
    (5, 24, 1024, False), (40, 12, 64, False), (40, 12, 96, False)])
def test_knn_attention_bwd_kernel(cuda, dtype, M, K, D, self_attn):
    """K6b alone against its plain version (autograd through the recompute) on
    the card, at the forward's indices: float32 within 1e-4 of each gradient's
    peak, bf16 as ``_hold_bf16_grads`` says; two launches bit-identical. Any K
    (130 and 200 span two tiles a query), spare rows (M no multiple of
    floor(128 / K)), one query, self attention, and widths no multiple of 128
    (64, 96: padded with zero channels)."""
    rs = np.random.RandomState(M * K + D + self_attn)
    args, dout = _k6_args(rs, 2, M, 600, D, dtype, self_attn)
    dev = [a.to(cuda) for a in args]
    dd = dout.to(cuda)
    with torch.no_grad():
        idx = knn_attn.fused_knn_vector_attention(*dev[:6], dev[6:10], dev[10:], n_neighbor=K,
                                                  return_idx=True)[1]
    bwd = lambda ts, i, d: knn_attn.knn_vector_attention_trainable_bwd(
        *ts[:6], ts[6:10], ts[10:], i, d)
    plain = lambda ts, i, d: knn_attn.plain_knn_vector_attention_trainable_bwd(
        *ts[:6], ts[6:10], ts[10:], i, d)
    before = knn_attn.knn_vector_attention_trainable_bwd.launches
    got, again = bwd(dev, idx, dd), bwd(dev, idx, dd)
    torch.cuda.synchronize()
    assert knn_attn.knn_vector_attention_trainable_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(g.dtype == a.dtype and g.shape == a.shape for g, a in zip(got, dev))
    if dtype == torch.float32:
        want = plain(dev, idx, dd)
        for i, (g, w) in enumerate(zip(got, want)):
            assert float((g - w).abs().max()) <= 1e-4 * _peak(want, i), i
    else:
        _hold_bf16_grads(got, dev, idx, dd, plain)


def test_knn_attention_bwd_runs_no_recompute_on_the_card(cuda, monkeypatch):
    """The Function's backward on CUDA tensors launches K6b once and never
    calls attention_from_idx; it returns no gradient the caller did not ask
    for (a static cloud's xyz)."""
    real = knn_attn.attention_from_idx

    def guard(q, *rest):
        assert not q.is_cuda, "attention_from_idx ran on CUDA tensors"
        return real(q, *rest)

    monkeypatch.setattr(knn_attn, "attention_from_idx", guard)
    rs = np.random.RandomState(12)
    args, dout = _k6_args(rs, 2, 65, 300, 128, torch.bfloat16)
    ts = [a.to(cuda) for a in args]
    leaves = [t if i == 2 else t.requires_grad_() for i, t in enumerate(ts)]
    before = knn_attn.knn_vector_attention_trainable_bwd.launches
    out = knn_attn.knn_vector_attention_trainable(*leaves[:6], leaves[6:10], leaves[10:],
                                                  n_neighbor=32)
    wanted = [t for t in leaves if t.requires_grad]
    grads = torch.autograd.grad(out, wanted, dout.to(cuda))
    torch.cuda.synchronize()
    assert knn_attn.knn_vector_attention_trainable_bwd.launches == before + 1
    assert len(grads) == 13 and all(bool(torch.isfinite(g).all()) for g in grads)


def test_kernels_without_backward_raise_under_grad(cuda):
    """K1 (eval form), K2 and K4 refuse to cut the graph."""
    rs = np.random.RandomState(4)
    D = 32
    mlp = lambda d_in: [_mk(rs, d_in, D).to(cuda), _mk(rs, D).to(cuda), _mk(rs, D, D).to(cuda),
                        _mk(rs, D).to(cuda)]
    q = _mk(rs, 1, 10, D).to(cuda).requires_grad_()
    xyz = _mk(rs, 1, 10, 3).to(cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        knn_attn.fused_knn_vector_attention(q, xyz, xyz, _mk(rs, 1, 10, D).to(cuda),
                                            _mk(rs, D, D).to(cuda), _mk(rs, D, D).to(cuda),
                                            mlp(3), mlp(D), n_neighbor=8)
    with pytest.raises(RuntimeError, match="no backward"):
        knn_attn.fused_anchor_vector_attention(q, xyz, _mk(rs, 1, 8, D).to(cuda),
                                               _mk(rs, 1, 8, D).to(cuda),
                                               _mk(rs, 8, 3).to(cuda), mlp(3), mlp(D))
    feat = _mk(rs, 1, 8, 8, D).to(cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        bilinear.grid_sample_points(feat, torch.zeros(1, 5, 2, device=cuda))
    with torch.no_grad():
        bilinear.grid_sample_points(feat, torch.zeros(1, 5, 2, device=cuda))


def test_hrnet_float32_backward_conditioning(cuda):
    """The float32 HRNet-W40 (GroupNorm) backward at 256 px against a float64
    one on the CPU: the CPU and the card stay within 3e-2 of the largest
    gradient. This bounds what chip_smoke's whole-step comparison of two
    float32 backbones can ask; it is a property of the network at random
    weights in float32, not of a kernel."""
    import copy

    from poem_v2_tpu_torch.models.backbones.hrnet import HRNet
    from poem_v2_tpu_torch.models.poem import init_parameters

    torch.backends.cudnn.allow_tf32 = False
    model = HRNet(width=40, norm="gn")
    init_parameters(model, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.uniform(-0.5, 0.5, (1, 3, 256, 256)).astype(np.float32))
    cts = [torch.from_numpy(rs.randn(*o.shape).astype(np.float32)) for o in model(img)]

    def grads(dev, dtype):
        m = copy.deepcopy(model).to(dev, dtype)
        loss = sum((o * c.to(dev, dtype)).sum() for o, c in zip(m(img.to(dev, dtype)), cts))
        return [g.detach().cpu().double() for g in torch.autograd.grad(loss, list(m.parameters()))]

    ref = grads("cpu", torch.float64)
    scale = max(float(g.abs().max()) for g in ref)
    for dev in ("cpu", cuda):
        got = grads(dev, torch.float32)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        assert err <= 3e-2 * scale, (dev, err / scale)


def _attn_mlps(rs, D):
    s = 1 / math.sqrt(D)
    return ([_mk(rs, 3, D), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=s), _mk(rs, D, scale=0.1)],
            [_mk(rs, D, D, scale=s), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=s),
             _mk(rs, D, scale=0.1)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,D,K", [(799, 128, 32), (799, 256, 32), (300, 512, 32),
                                   (65, 256, 3), (65, 256, 24), (1, 256, 48), (65, 256, 64),
                                   (65, 1024, 24),
                                   (150, 1024, 32), (77, 64, 8), (50, 1024, 16)])
def test_fused_vector_attention(cuda, dtype, M, D, K):
    """K8 against its plain version on gathered k / v / delta."""
    rs = np.random.RandomState(M + D)
    B = 2
    args = [_mk(rs, B, M, D).to(dtype), _mk(rs, B, M, K, D).to(dtype),
            _mk(rs, B, M, K, D).to(dtype), _mk(rs, B, M, K, 3, scale=0.4)]
    fcd, fcg = _attn_mlps(rs, D)
    want = vector_attn.fused_vector_attention(*args, fcd, fcg)
    dev = lambda ts: [t.to(cuda) for t in ts]
    before = vector_attn.fused_vector_attention.launches
    got = vector_attn.fused_vector_attention(*dev(args), dev(fcd), dev(fcg))
    torch.cuda.synchronize()
    assert vector_attn.fused_vector_attention.launches == before + 1
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [128, 256, 512, 1024])
@pytest.mark.parametrize("pattern", ["mixed", "all_1", "all_V"])
def test_scrambled_merge_gather(cuda, dtype, C, pattern):
    """K5 is a copy: bit-identical to the plain gather on every row, the aliased ones too."""
    rs = np.random.RandomState(C)
    B, V, NS = 4, 8, 512
    n_val = {"mixed": [3, 8, 1, 6], "all_1": [1] * B, "all_V": [V] * B}[pattern]
    n_val = torch.tensor(n_val, dtype=torch.int64)
    flat = _mk(rs, B, V * NS * C).to(dtype)
    want = scramble.scrambled_merge_gather(flat, n_val, V, C)
    before = scramble.scrambled_merge_gather.launches
    got = scramble.scrambled_merge_gather(flat.to(cuda), n_val.to(cuda), V, C)
    torch.cuda.synchronize()
    assert scramble.scrambled_merge_gather.launches == before + 1
    assert got.shape == (B, NS, V, C) and torch.equal(got.cpu(), want)


def test_shapes_the_new_wrappers_reject(cuda):
    """K5: rows that are no multiple of 16 bytes; K1 / K2 / K8: D above 1024 and
    D % 4 raise, while neighbour counts that do not divide 32 (3, 64) run and
    match the plain versions."""
    rs = np.random.RandomState(3)
    n_val = torch.tensor([1, 2], device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        scramble.scrambled_merge_gather(_mk(rs, 2, 2 * 16 * 4).to(cuda).bfloat16(), n_val, 2, 4)
    scramble.scrambled_merge_gather(_mk(rs, 2, 2 * 16 * 4).to(cuda), n_val, 2, 4)  # 16-byte rows
    with pytest.raises(ValueError, match="n_val"):
        scramble.scrambled_merge_gather(_mk(rs, 2, 2 * 16 * 4).to(cuda), n_val[:1], 2, 4)
    for D, K in ((1028, 8), (30, 8), (64, 3), (64, 64)):
        fcd, fcg = _attn_mlps(rs, D)
        args = [_mk(rs, 1, 5, D), _mk(rs, 1, 5, K, D), _mk(rs, 1, 5, K, D), _mk(rs, 1, 5, K, 3)]
        xyz = _mk(rs, 1, 80, 3)
        k1_args = [_mk(rs, 1, 80, D), xyz, xyz, _mk(rs, 1, 80, D), _mk(rs, D, D), _mk(rs, D, D)]
        dev = lambda ts: [t.to(cuda) for t in ts]
        k8 = lambda a, d, g: vector_attn.fused_vector_attention(*a, d, g)
        k1 = lambda a, d, g: knn_attn.fused_knn_vector_attention(*a, d, g, n_neighbor=K)
        for fn, a in ((k8, args), (k1, k1_args)):
            if D % 4 or D > 1024:
                with pytest.raises(ValueError, match="CUDA kernel takes"):
                    fn(dev(a), dev(fcd), dev(fcg))
            else:
                got = fn(dev(a), dev(fcd), dev(fcg))
                torch.cuda.synchronize()
                _close(got, fn(a, fcd, fcg), torch.float32)
    q = _mk(rs, 1, 5, 32).to(cuda).requires_grad_()
    fcd, fcg = _attn_mlps(rs, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        vector_attn.fused_vector_attention(q, _mk(rs, 1, 5, 8, 32).to(cuda),
                                           _mk(rs, 1, 5, 8, 32).to(cuda),
                                           _mk(rs, 1, 5, 8, 3).to(cuda),
                                           [t.to(cuda) for t in fcd], [t.to(cuda) for t in fcg])
    with pytest.raises(RuntimeError, match="no backward"):
        scramble.scrambled_merge_gather(_mk(rs, 2, 2 * 16 * 4).to(cuda).requires_grad_(),
                                        n_val, 2, 4)


@pytest.mark.parametrize("hidden", [128, 512, 1024])
def test_decoder_block_at_the_tiers_widths(cuda, hidden):
    """One KNN decoder block in float32, card against CPU: K3 at head dims 32,
    128 and 256 and K1 at D = 128, 512, 1024 inside the model. Float32 sums in
    other orders through two attentions, two vector attentions and the FFN."""
    from poem_v2_tpu_torch.models.decoder import PointMetroBlock
    from poem_v2_tpu_torch.models.poem import init_parameters

    rs = np.random.RandomState(hidden)
    block = PointMetroBlock(hidden, num_heads=4, n_neighbor=32, n_neighbor_query=32).eval()
    init_parameters(block, torch.Generator().manual_seed(hidden))
    args = [_mk(rs, 1, 200, 3, scale=0.4), _mk(rs, 1, 200, hidden), _mk(rs, 1, 1000, 3, scale=0.4),
            _mk(rs, 1, 1000, hidden)]
    with torch.no_grad():
        want_f, want_xyz = block(*args)
        k3, k1 = cross_attn.dense_cross_attention.launches, \
            knn_attn.fused_knn_vector_attention.launches
        got_f, got_xyz = block.to(cuda)(*[t.to(cuda) for t in args])
    torch.cuda.synchronize()
    assert cross_attn.dense_cross_attention.launches == k3 + 2
    assert knn_attn.fused_knn_vector_attention.launches == k1 + 2
    _close(got_f, want_f, torch.float32)
    _close(got_xyz, want_xyz, torch.float32)


@pytest.mark.parametrize("init_block", [False, True])
def test_pointer_layer_use_fused_runs_k8(cuda, init_block):
    """PointerLayer(use_fused=True, use_fused_knn=False): two K8 launches per
    forward, card (kernel) against CPU (plain version), float32."""
    from poem_v2_tpu_torch.models.decoder import PointerLayer
    from poem_v2_tpu_torch.models.poem import init_parameters

    rs = np.random.RandomState(11)
    D = 64
    layer = PointerLayer(D, 16, 16, init_block, use_fused=True, use_fused_knn=False).eval()
    init_parameters(layer, torch.Generator().manual_seed(2))
    args = [_mk(rs, 2, 300, 3, scale=0.4), _mk(rs, 2, 300, D), _mk(rs, 2, 90, 3, scale=0.4),
            _mk(rs, 2, 90, D)]
    anchors = (torch.arange(0, 64, 2), torch.arange(1, 65, 2), _mk(rs, 32, 3, scale=0.4))
    with torch.no_grad():
        want_f, want_xyz = layer(*args, *anchors)
        before = vector_attn.fused_vector_attention.launches
        got_f, got_xyz = layer.to(cuda)(*[t.to(cuda) for t in (*args, *anchors)])
    torch.cuda.synchronize()
    assert vector_attn.fused_vector_attention.launches == before + 2
    _close(got_f, want_f, torch.float32)
    _close(got_xyz, want_xyz, torch.float32)


def _bucketed_case(rs, B, M, N, D, SB, dtype, tight):
    cloud = rs.randn(N, 3).astype(np.float32)
    perm, lo, hi = points.build_balanced_buckets(cloud, SB)
    s = 1 / math.sqrt(D)
    qxyz = _mk(rs, B, M, 3)
    if tight:  # queries sorted along x around one cloud point: blocks near each other
        qxyz = torch.from_numpy(cloud[7]) + 0.3 * qxyz
        qxyz = torch.gather(qxyz, 1, qxyz[..., :1].argsort(1).expand(B, M, 3))
    args = [_mk(rs, B, M, D).to(dtype), qxyz,
            torch.from_numpy(cloud[perm])[None].expand(B, N, 3).contiguous(),
            _mk(rs, B, N, D).to(dtype), torch.from_numpy(lo), torch.from_numpy(hi),
            _mk(rs, D, D, scale=s), _mk(rs, D, D, scale=s)]
    fcd = [_mk(rs, 3, D), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=s), _mk(rs, D, scale=0.1)]
    fcg = [_mk(rs, D, D, scale=s), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=s),
           _mk(rs, D, scale=0.1)]
    return args, fcd, fcg


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,N,D,K,SB,BQ,C,tight", [
    (64, 512, 64, 8, 32, 16, 8, True),       # the CPU test's shape
    (799, 4096, 256, 32, 128, 32, 8, True),  # the defaults; a ragged last block
    (799, 4096, 256, 32, 128, 32, 32, False),  # every bucket a candidate
    (203, 1024, 1024, 32, 64, 7, 3, False),  # block_q no multiple of the warps, wide D
    (100, 768, 128, 16, 256, 50, 1, True),   # one candidate bucket
])
def test_knn_vector_attention_bucketed(cuda, dtype, M, N, D, K, SB, BQ, C, tight):
    """K9: indices and certified blocks identical to the plain version, margins
    to 1e-6, the output within TOL; the sentinel with every bucket a candidate."""
    rs = np.random.RandomState(M + N + C)
    args, fcd, fcg = _bucketed_case(rs, 2, M, N, D, SB, dtype, tight)
    kw = dict(n_neighbor=K, block_q=BQ, n_cand=C, bucket_size=SB, return_idx=True)
    want, wm, widx = knn_attn.fused_knn_vector_attention_bucketed(*args, fcd, fcg, **kw)
    dev = lambda ts: [t.to(cuda) for t in ts]
    before = knn_attn.fused_knn_vector_attention_bucketed.launches
    got, gm, gidx = knn_attn.fused_knn_vector_attention_bucketed(*dev(args), dev(fcd), dev(fcg),
                                                                 **kw)
    torch.cuda.synchronize()
    assert knn_attn.fused_knn_vector_attention_bucketed.launches == before + 1
    assert torch.equal(gidx.cpu(), widx)
    assert gm.shape == wm.shape == (2, -(-M // BQ))
    assert torch.equal(gm.cpu() >= 0, wm >= 0)
    finite = wm < 1e30
    assert torch.equal(gm.cpu() < 1e30, finite)
    assert float((gm.cpu() - wm)[finite].abs().max() if finite.any() else 0.0) <= 1e-6
    if C * SB == N:
        assert float(gm.min()) == pytest.approx(knn_attn.MARGIN_SENTINEL, rel=1e-6)
    _close(got, want, dtype)


def test_knn_vector_attention_bucketed_refuses(cuda):
    rs = np.random.RandomState(3)
    args, fcd, fcg = _bucketed_case(rs, 1, 40, 512, 32, 32, torch.float32, False)
    dev = lambda ts: [t.to(cuda) for t in ts]
    for kw, err in ((dict(bucket_size=48), ValueError), (dict(n_cand=17), ValueError),
                    (dict(n_neighbor=64, n_cand=1), ValueError)):
        with pytest.raises(err):
            knn_attn.fused_knn_vector_attention_bucketed(
                *dev(args), dev(fcd), dev(fcg), **{**dict(n_neighbor=8, bucket_size=32), **kw})
    # a neighbour count that does not divide 32 runs (the attention core takes any K)
    kw = dict(n_neighbor=12, bucket_size=32)
    got, margins = knn_attn.fused_knn_vector_attention_bucketed(*dev(args), dev(fcd), dev(fcg),
                                                                **kw)
    want, w_margins = knn_attn.fused_knn_vector_attention_bucketed(*args, fcd, fcg, **kw)
    torch.cuda.synchronize()
    _close(got, want, torch.float32)
    assert torch.equal(margins.cpu() >= 0, w_margins >= 0)
    q = args[0].to(cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        knn_attn.fused_knn_vector_attention_bucketed(q, *dev(args[1:]), dev(fcd), dev(fcg),
                                                     n_neighbor=8, bucket_size=32)


def _ball_cloud(rs, n, dup):
    """n points in the unit ball; ``dup``: every point twice (exact ties)."""
    x = rs.randn((n + 1) // 2 if dup else n, 3)
    x = x / np.linalg.norm(x, axis=1, keepdims=True) * rs.rand(len(x), 1) ** (1 / 3)
    if dup:
        x = np.concatenate([x, x])[:n]
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("M", [1, 65])
@pytest.mark.parametrize("N", [1, 33, 799, 4096, 5000, 7000])
def test_knn_select_shapes(cuda, N, M, dup):
    """K1's selection (``csrc/select_core.cuh``) equal to its plain version at K
    = 1, 32, 48 and N: packed keys up to 4096 points, exact keys above, the
    cloud read from L2 above 6144; with every point twice (ties to the lower
    index); two launches the same bits."""
    rs = np.random.RandomState(N + M + dup)
    B = 2
    pxyz = _ball_cloud(rs, N, dup)[None].expand(B, N, 3).contiguous().to(cuda)
    qxyz = _mk(rs, B, M, 3, scale=0.4).to(cuda)
    for K in sorted({k for k in (1, 32, 48, N) if k <= N}):
        got = knn_attn.knn_select(qxyz, pxyz, K)
        again = knn_attn.knn_select(qxyz, pxyz, K)
        want = knn_attn.knn_select_plain(qxyz, pxyz, K)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (B, M, K)
        assert torch.equal(got, want), (K, int((got != want).sum()))
        assert torch.equal(got, again), K


@pytest.mark.parametrize("B,M,N,SB,BQ,C,K,tight", [
    (4, 799, 4096, 128, 32, 8, 32, True),      # the defaults; a ragged last block
    (2, 203, 1000, 40, 7, 3, 48, False),       # bucket size no multiple of 32
    (2, 100, 768, 96, 50, 1, 16, True),        # one candidate bucket
    (2, 65, 16384, 512, 16, 12, 32, True),     # 6144 candidates: the most staged
    (2, 65, 16384, 512, 16, 13, 32, False),    # 6656: read from L2
    (1, 40, 32768, 1024, 32, 32, 32, True),    # 32 768, every bucket a candidate
    (2, 65, 600, 24, 64, 25, 48, False),       # every bucket a candidate, one ragged block
    (1, 9, 360, 45, 4, 2, 90, False),          # K = n_cand x bucket size
])
def test_knn_select_bucketed_shapes(cuda, B, M, N, SB, BQ, C, K, tight):
    """K9's selection alone equal to its plain version: indices identical,
    margins certified alike and within 1e-6 (the sentinel where every bucket is
    a candidate), two launches the same bits."""
    rs = np.random.RandomState(N + C)
    cloud = rs.randn(N, 3).astype(np.float32)
    perm, lo, hi = points.build_balanced_buckets(cloud, SB)
    q = cloud[7] + rs.randn(B, M, 3).astype(np.float32) * (0.05 if tight else 1.0)
    qxyz, lo, hi = (torch.from_numpy(a).to(cuda) for a in (q, lo, hi))
    pxyz = torch.from_numpy(cloud[perm])[None].expand(B, N, 3).contiguous().to(cuda)
    cand = knn_attn.select_candidate_buckets(knn_attn._pad_queries_edge(qxyz, BQ), lo, hi, BQ, C)
    args = (qxyz, pxyz, lo, hi, cand, K, BQ, C, SB)
    idx, margins = knn_attn.knn_select_bucketed(*args)
    idx2, margins2 = knn_attn.knn_select_bucketed(*args)
    widx, wm = knn_attn.knn_select_bucketed_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(idx, widx) and torch.equal(idx, idx2)
    assert torch.equal(margins, margins2)
    assert margins.shape == wm.shape == (B, -(-M // BQ))
    assert torch.equal(margins >= 0, wm >= 0)
    finite = wm < 1e30
    assert torch.equal(margins < 1e30, finite)
    assert float((margins - wm)[finite].abs().max() if finite.any() else 0.0) <= 1e-6
    if C * SB == N:
        assert bool((margins == knn_attn.MARGIN_SENTINEL).all())


@pytest.mark.parametrize("name", select.VARIANTS)
@pytest.mark.parametrize("B,M,N,K,BQ,CJ", [(2, 64, 512, 8, 16, 4), (3, 130, 4096, 32, 65, 16),
                                           (1, 12, 1000, 30, 4, 5), (2, 10, 37, 37, 5, 37)])
def test_kth_key_variants(cuda, name, B, M, N, K, BQ, CJ):
    """K10: every variant equal (integers: tolerance 0) to its plain version and
    to np.partition; N = 37 = K takes the whole row."""
    keys_np = select.make_keys(N, B, M, N)
    keys = torch.from_numpy(keys_np)
    got = select.variant_calls(keys.to(cuda), K, BQ, CJ)[name]()
    torch.cuda.synchronize()
    want = select.variant_calls(keys, K, BQ, CJ, plain=True)[name]()
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    kth = np.partition(keys_np, K - 1, axis=2)[..., K - 1:K]
    if name in ("scan32", "radix8"):
        assert np.array_equal(got.cpu().numpy(), kth)
    elif name in ("cur", "bcast"):
        assert np.array_equal(got.cpu().numpy(), kth + K * BQ)


@pytest.mark.parametrize("N,K", [(1, 1), (33, 1), (33, 32), (33, 33), (4095, 1), (4095, 32),
                                 (4095, 4095), (4096, 1), (4096, 32), (4096, 4096)])
@pytest.mark.parametrize("kind", ["benchmark", "prefix"])
def test_kth_key_variants_on_prefix_keys_and_ragged_rows(cuda, kind, N, K):
    """K10's five variants on rows whose keys share a 20-bit prefix (radix8's
    active set stays the whole row for five passes) and on rows of 1, 33 and
    4095 keys (no 16-byte loads), K from 1 to N: equal to the plain versions,
    scan32 and radix8 to np.partition."""
    B, M = 2, 8
    keys_np = (select.make_keys(N + K, B, M, N) if kind == "benchmark"
               else select.make_prefix_keys(N + K, B, M, N))
    CJ = max(d for d in range(1, 17) if K % d == 0)
    keys = torch.from_numpy(keys_np).to(cuda)
    calls = select.variant_calls(keys, K, M, CJ)
    plains = select.variant_calls(keys.cpu(), K, M, CJ, plain=True)
    kth = np.partition(keys_np, K - 1, axis=2)[..., K - 1:K]
    for name in select.VARIANTS:
        got = calls[name]().cpu()
        assert torch.equal(got, plains[name]()), name
        if name in ("scan32", "radix8"):
            assert np.array_equal(got.numpy(), kth), name


@pytest.mark.parametrize("kind,N", [("benchmark", 33), ("benchmark", 500), ("benchmark", 4096),
                                    ("prefix", 4096)])
def test_kth_key_radix8_repeated_launches(cuda, kind, N):
    """radix8 on many rows, launched 20 times: rows that compact at once (N 33
    and 500), two register passes (the benchmark's keys) and five (shared
    prefix); every launch equal to the plain version."""
    B, M, K = 4, 832, 32
    maker = select.make_keys if kind == "benchmark" else select.make_prefix_keys
    keys = torch.from_numpy(maker(N, B, M, N)).to(cuda)
    want = select.variant_calls(keys, K, M, 16, plain=True)["radix8"]()
    call = select.variant_calls(keys, K, M, 16)["radix8"]
    assert all(torch.equal(call(), want) for _ in range(20))


def test_kth_key_launch_counts_and_checks(cuda):
    keys = torch.from_numpy(select.make_keys(0, 1, 8, 64)).to(cuda)
    for fn in (select.kth_key_scan32, select.kth_key_radix8, select.kth_key_cur,
               select.kth_key_bcast):
        kw = dict(block_q=4, chunk_j=2) if fn in (select.kth_key_cur, select.kth_key_bcast) else {}
        before = fn.launches
        fn(keys, 4, **kw)
        assert fn.launches == before + 1
        with pytest.raises(ValueError, match="non-negative"):
            fn(-keys - 1, 4, **kw)
        assert fn.launches == before + 1
    wide = torch.zeros(1, 4, 4096, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        select.kth_key_cur(wide, 64, block_q=4, chunk_j=64)
    with pytest.raises(ValueError, match="column"):
        select.kth_key_scan32(torch.zeros(1, 4, 4097, dtype=torch.int32, device=cuda), 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [128, 512, 1024])
def test_knn_vector_attention_trainable_at_the_tiers_widths(cuda, dtype, D):
    """K6 at the widths of the small, large and huge tiers, K = 32: the value,
    and in float32 the gradients of all 14 inputs (K7 scatters D-wide rows),
    with K1's indices on the card identical to the plain ones."""
    rs = np.random.RandomState(D)
    B, M, N, K = 2, 90, 400, 32
    s = 1 / math.sqrt(D)
    args = [_mk(rs, B, M, D), _mk(rs, B, M, 3), _mk(rs, B, N, 3), _mk(rs, B, N, D),
            _mk(rs, D, D, scale=s), _mk(rs, D, D, scale=s),
            _mk(rs, 3, D), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=s), _mk(rs, D, scale=0.1),
            _mk(rs, D, D, scale=s), _mk(rs, D, scale=0.1), _mk(rs, D, D, scale=s),
            _mk(rs, D, scale=0.1)]
    args = [a.to(dtype) if i in (0, 3) else a for i, a in enumerate(args)]
    ct = _mk(rs, B, M, D)

    def run(ts):
        ts = [t.clone().requires_grad_() for t in ts]
        out = knn_attn.knn_vector_attention_trainable(*ts[:6], ts[6:10], ts[10:], n_neighbor=K)
        return out, torch.autograd.grad((out.float() * ct.to(out.device)).sum(), ts)

    want, gw = run(args)
    got, gg = run([a.to(cuda) for a in args])
    torch.cuda.synchronize()
    with torch.no_grad():
        idx = [knn_attn.fused_knn_vector_attention(*ts[:6], ts[6:10], ts[10:], n_neighbor=K,
                                                   return_idx=True)[1].cpu()
               for ts in (args, [a.to(cuda) for a in args])]
    assert torch.equal(*idx)
    _close(got, want, dtype)
    if dtype != torch.float32:
        return
    # The backward is the same PyTorch recompute on both sides, at identical
    # indices. Among B * M * K * D relu inputs (millions at these widths) a few
    # lie within float32 rounding of 0, and their derivative flips between the
    # card and the CPU (each side then sits ~7e-3 of the peak from a float64
    # run, on one query row). So gradients are held in the L2 norm, where one
    # flipped unit weighs ~1e-3 and a wrong scatter or a lost term weighs ~1,
    # and q's gradient also row by row: all but 2% of the query rows to 1e-4.
    for i, (g, w) in enumerate(zip(gg, gw)):
        scale = float(gw[12 if i == 13 else i].norm())
        assert float((g.cpu() - w).norm()) <= 2e-3 * scale, i
    row_err = (gg[0].cpu() - gw[0]).abs().amax(-1)
    assert float((row_err > 1e-4 * float(gw[0].abs().max())).float().mean()) <= 0.02


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [128, 512, 1024, 36])
def test_scatter_add_rows_at_the_tiers_widths(cuda, dtype, D):
    """K7 with D-wide rows, into 799 (self), 4096 (cross) and 9000 rows (more
    than one segment's worth of rows); D = 36 is no multiple of 16 bytes in
    bfloat16 (one column a lane)."""
    rs = np.random.RandomState(D + 7)
    B, M, K = 2, 200, 32
    g = _mk(rs, B, M, K, D).to(dtype)
    for n_rows in (799, 4096, 9000):
        idx = torch.from_numpy(rs.randint(0, n_rows // 8, (B, M, K)).astype(np.int32) * 8)
        want = scatter.plain_scatter_add_rows(g, idx, n_rows)
        got = scatter.scatter_add_rows(g.to(cuda), idx.to(cuda), n_rows)
        again = scatter.scatter_add_rows(g.to(cuda), idx.to(cuda), n_rows)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _close(got, want, torch.float32)


def test_parametric_step_float32_gradient_conditioning(cuda):
    """One medium_MANO train step at B1 (the inputs of chip_smoke phase 4d): the
    float32 gradients of the CPU (8 threads and 1 thread, the same plain code) and
    of the card against a float64 step on the CPU, per module, over the module's
    largest gradient. The loss reaches decoder blocks 0 and 1 only through block
    2's attention, and float32 noise there is ~1e-4 of their largest gradient on
    every device (measured: CPU 8.95e-5 and 5.1e-5, card 2.9e-5 in block 1; blocks
    0 and 2 <= 1.5e-5): this bounds what a card-vs-CPU comparison of the
    parametric step can ask of the blocks (3e-4). A property of the model at
    random weights in float32, not of a kernel."""
    import copy

    from poem_v2_tpu_torch.configs import RELEASE
    from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu_torch.models.poem import create_poem_model, draw_ref_noise
    from poem_v2_tpu_torch.training.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    cfg = RELEASE["medium_MANO"]
    model, aux = create_poem_model(cfg["MODEL"], device="cpu",
                                   generator=torch.Generator().manual_seed(1))
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    raw = SyntheticMultiviewDataset(batch_size=1, view_max=4, view_range=(2, 4), image_size=256,
                                    seed=5).sample_batch()
    draws = draw_ref_noise(torch.Generator().manual_seed(7), 1)

    def grads(dev, dtype):
        mdl = copy.deepcopy(model).to(dev, dtype).train()
        trainer = Trainer(mdl, aux, cfg["TRAIN"], cfg["MODEL"]["LOSS"])
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in trainer.to_device(raw).items()}
        preds = mdl(b["image"], b["view_mask"], b["cam_intr"], b["cam_extr"],
                    b["master_joints_3d"], ref_draws=tuple(d.to(dtype) for d in draws))
        trainer.loss_fn(preds, b)[0].backward()
        return {n: p.grad.detach().cpu().double() for n, p in mdl.named_parameters()
                if p.grad is not None}

    def blocks(got, ref):
        out = {}
        for n, r in ref.items():
            parts = n.split(".")
            if parts[:2] != ["head", "transformer"]:
                continue
            err, scale = out.get(parts[2], (0.0, 0.0))
            out[parts[2]] = (max(err, float((got[n] - r).abs().max())),
                             max(scale, float(r.abs().max())))
        return {k: e / s for k, (e, s) in out.items()}

    ref = grads("cpu", torch.float64)
    threads = torch.get_num_threads()
    runs = {"cpu": grads("cpu", torch.float32), "card": grads(cuda, torch.float32)}
    torch.set_num_threads(1)
    try:
        runs["cpu, 1 thread"] = grads("cpu", torch.float32)
    finally:
        torch.set_num_threads(threads)
    for name, got in runs.items():
        rel = blocks(got, ref)
        print(f"{name} vs float64, max |dgrad| / max |grad| per block: "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        assert set(rel) == {"block_0", "block_1", "block_2"}
        assert max(rel.values()) <= 3e-4, (name, rel)
