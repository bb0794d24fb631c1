"""Fused exact-KNN and fixed-anchor vector attention (kernels K1, K2, K6, K6b).

Counterparts of ``poem_v2_tpu/ops/pallas_knn_attn.py``:

* :func:`fused_knn_vector_attention` <- ``fused_knn_vector_attention``
  (exact K-NN selection + neighbour gather + vector attention);
* :func:`fused_anchor_vector_attention` <- ``fused_anchor_vector_attention``
  (the same attention against fixed, pre-projected anchors);
* :func:`knn_vector_attention_trainable` <- ``knn_vector_attention_trainable``
  (K6: K1's forward with its indices saved) and its backward
  :func:`knn_vector_attention_trainable_bwd` <- ``_trainable_bwd`` (K6b: on
  the card the hand-written chain of ``csrc/knn_attn_bwd.cu``, which reruns
  the forward's products and writes the backward out, then K7's scatter; its
  plain version is the gradient of :func:`attention_from_idx`, as the JAX
  backward is);
* :func:`fused_knn_vector_attention_bucketed` <-
  ``fused_knn_vector_attention_bucketed`` (K9: the exact K-NN restricted to
  the nearest k-d buckets of a static cloud, with a per-block exactness
  margin; ``csrc/knn_bucketed.cu`` selects, :func:`knn_select_bucketed`
  alone, K1's attention kernel follows) and its host step
  :func:`select_candidate_buckets`. As in the JAX package it is a function
  only: no model path calls it.

Each wrapper takes CPU tensors to its plain PyTorch version and CUDA
tensors to the hand-written kernel in ``csrc/knn_attn.cu`` (K6b: in
``csrc/knn_attn_bwd.cu``); there is no fallback from one to the other.
``<wrapper>.launches`` counts kernel launches. K1 and K2 have no backward:
on the card they raise when autograd would need one; K6's backward is K6b.

Widths: the kernels take float32 or bfloat16 tensors with D a multiple of
4 up to 1024 (the released tiers use 128, 256, 512 and 1024) and any
neighbour or anchor count K (at most the cloud's size); the wrappers raise
``ValueError`` for anything else, ``TypeError`` for another dtype. The
selection (:func:`knn_select`, on ``csrc/select_core.cuh`` as K9's is) takes
any cloud size (packed 12-bit-column keys up to 4096 points, exact (distance,
index) keys above). :func:`fused_knn_vector_attention` also takes
the caller's indices (``neighbor_idx``, the TPU kernel's
``_kernel_from_idx``) and then skips the selection.

In bfloat16 the attention is the tensor-core chain of ``csrc/knn_attn.cu``
(see ``vector_attn.run_attention_core``): K1 projects the whole cloud once,
kv = x_full [Wk | Wv] in float32, and gathers its rows, where the TPU kernel
projects every gathered row; the same arithmetic up to the order of float32
sums.

Numerics follow the TPU kernel: operands of every matrix product are cast
to the compute dtype (that of ``q``), products accumulate in float32,
biases, the softmax and the (v + pos) aggregate stay float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import _lib
from .points import index_points
from .remat import kernel_outputs
from .scatter import index_points_mxu, scatter_add_rows
from .vector_attn import (CORE_TILE, CORE_WIDTH, MODE_ANCHOR, MODE_KNN, _mm, _padded, _rounded,
                          check_attention_shapes, check_one_device, core_rows, run_attention_core,
                          vector_attention_plain, vector_attention_reference)

PACKED_MAX_POINTS = 4096  # the packed keys keep the column in 12 bits


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def use_packed_keys(n_points: int) -> bool:
    """Packed-key selection iff the cloud padded to 128 fits 12 bits,
    as the TPU wrapper decides (pallas_knn_attn.py:877)."""
    return _round_up(n_points, 128) <= PACKED_MAX_POINTS


def square_distance_rn(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(B, M, 3), (B, N, 3) -> (B, M, N) squared distances, formed as
    ``(|q|^2 + |p|^2) - 2 q.p`` one rounded float32 operation at a time
    (no matrix product, no fused multiply-add): the kernel forms the same
    values bit for bit, so both select the same neighbours."""
    q = query.float()[:, :, None, :]
    p = points.float()[:, None, :, :]

    def sq(a):
        return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]

    cross = q[..., 0] * p[..., 0] + q[..., 1] * p[..., 1] + q[..., 2] * p[..., 2]
    return (sq(q) + sq(p)) - 2.0 * cross


def knn_select_plain(query_xyz: torch.Tensor, pt_xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M, K) int32 neighbour indices in ascending (distance, index) order."""
    d2 = square_distance_rn(query_xyz, pt_xyz)
    if use_packed_keys(pt_xyz.shape[1]):
        col = torch.arange(d2.shape[-1], device=d2.device, dtype=torch.int32)
        keys = (d2.clamp_min(0.0).view(torch.int32) & ~0xFFF) | col
        # keys are unique, so the sort is a total order
        return (torch.sort(keys, dim=-1).values[..., :k] & 0xFFF).to(torch.int32)
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k].to(torch.int32)


def knn_select(query_xyz: torch.Tensor, pt_xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M, k) int32 exact K-NN indices, as K1 selects them: the plain
    version on the CPU, ``knn_select_kernel`` on the card (no launch count of
    its own: it is part of K1)."""
    if query_xyz.device.type == "cpu":
        return knn_select_plain(query_xyz, pt_xyz, k)
    B, M, _ = query_xyz.shape
    N = pt_xyz.shape[1]
    qxyz = query_xyz.float().contiguous()
    pxyz = pt_xyz.float().contiguous()
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query_xyz.device)
    _lib.lib().call("poem_knn_select", qxyz.data_ptr(), pxyz.data_ptr(), idx.data_ptr(),
                    B, M, N, k, int(use_packed_keys(N)), _lib.stream_ptr(query_xyz))
    return idx


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    B, M, K = idx.shape
    flat = idx.reshape(B, M * K).long()
    return torch.gather(x, 1, flat[..., None].expand(B, M * K, x.shape[-1])).reshape(B, M, K, -1)


def _plain_attention_at(q, query_xyz, pt_xyz, x_full, wk, wv, fc_delta, fc_gamma, idx):
    """The plain gather and vector attention at given (B, M, K) neighbour indices."""
    dt = q.dtype
    # gathered as float32 (the same values): the gather's backward then sums
    # each point's neighbour gradients in float32
    x_g = _gather(_rounded(x_full, dt), idx)
    nn_xyz = _gather(pt_xyz.float(), idx)
    delta = query_xyz.float()[:, :, None] - nn_xyz
    return vector_attention_plain(
        q, _mm(x_g, wk, dt), _mm(x_g, wv, dt), delta, fc_delta, fc_gamma
    )


def plain_fused_knn_vector_attention(q, query_xyz, pt_xyz, x_full, wk, wv, fc_delta, fc_gamma,
                                     n_neighbor: int = 32, return_idx: bool = False,
                                     neighbor_idx=None):
    """Plain PyTorch version of :func:`fused_knn_vector_attention`."""
    idx = knn_select_plain(query_xyz, pt_xyz, n_neighbor) if neighbor_idx is None \
        else neighbor_idx
    out = _plain_attention_at(q, query_xyz, pt_xyz, x_full, wk, wv, fc_delta, fc_gamma, idx)
    return (out, idx) if return_idx else out


def plain_fused_anchor_vector_attention(q, query_xyz, k_anchor, v_anchor, anchor_xyz,
                                        fc_delta, fc_gamma):
    """Plain PyTorch version of :func:`fused_anchor_vector_attention`."""
    B, M, D = q.shape
    A = k_anchor.shape[1]
    a_xyz = anchor_xyz.float().expand(B, A, 3) if anchor_xyz.dim() == 3 else \
        anchor_xyz.float()[None].expand(B, A, 3)
    k = k_anchor.to(q.dtype).float()[:, None].expand(B, M, A, D)
    v = v_anchor.to(q.dtype).float()[:, None].expand(B, M, A, D)
    delta = query_xyz.float()[:, :, None] - a_xyz[:, None]
    return vector_attention_plain(q, k, v, delta, fc_delta, fc_gamma)


def check_neighbor_idx(neighbor_idx: torch.Tensor, B: int, M: int, K: int, N: int) -> None:
    """(B, M, K) integer indices into a cloud of N points, else ``ValueError``."""
    if tuple(neighbor_idx.shape) != (B, M, K) or neighbor_idx.is_floating_point():
        raise ValueError(f"neighbor_idx must be ({B}, {M}, {K}) integers, got "
                         f"{tuple(neighbor_idx.shape)} {neighbor_idx.dtype}")
    # the values are read back to the host, except while a CUDA graph is being
    # captured, where a read-back is not allowed
    if neighbor_idx.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    if neighbor_idx.numel() and not bool(((neighbor_idx >= 0) & (neighbor_idx < N)).all()):
        raise ValueError(f"neighbor_idx holds indices outside [0, {N})")


def fused_knn_vector_attention(
    q: torch.Tensor,          # (B, M, D) w_qs(query_feat)
    query_xyz: torch.Tensor,  # (B, M, 3)
    pt_xyz: torch.Tensor,     # (B, N, 3)
    x_full: torch.Tensor,     # (B, N, D) fc1 activations of the cloud
    wk: torch.Tensor,         # (D, D) (in, out)
    wv: torch.Tensor,         # (D, D)
    fc_delta: Sequence[torch.Tensor],  # (w1 (3, D), b1, w2 (D, D), b2)
    fc_gamma: Sequence[torch.Tensor],  # (g0 (D, D), c0, g1 (D, D), c1)
    n_neighbor: int = 32,
    return_idx: bool = False,
    neighbor_idx: torch.Tensor = None,  # (B, M, K) precomputed exact-KNN indices
):
    """Vector attention of every query over its ``n_neighbor`` exact
    nearest cloud points; (B, M, D), plus the (B, M, K) int32 indices
    when ``return_idx``. With ``neighbor_idx`` the selection is skipped and
    those neighbours are attended; it excludes ``return_idx``, as in the
    JAX function."""
    B, M, D = q.shape
    N = pt_xyz.shape[1]
    if n_neighbor > N:
        raise ValueError(f"n_neighbor={n_neighbor} exceeds the cloud's {N} points")
    if neighbor_idx is not None:
        if return_idx:
            raise ValueError("neighbor_idx and return_idx exclude each other: the indices are "
                             "the caller's")
        check_neighbor_idx(neighbor_idx, B, M, n_neighbor, N)
    if q.device.type == "cpu":
        return plain_fused_knn_vector_attention(
            q, query_xyz, pt_xyz, x_full, wk, wv, fc_delta, fc_gamma, n_neighbor, return_idx,
            neighbor_idx)
    check_one_device(q, query_xyz, pt_xyz, x_full, wk, wv, *fc_delta, *fc_gamma)
    check_attention_shapes(D)
    _lib.no_grad_guard("fused_knn_vector_attention", q, query_xyz, pt_xyz, x_full, wk, wv,
                       *fc_delta, *fc_gamma)
    qxyz = query_xyz.float().contiguous()
    pxyz = pt_xyz.float().contiguous()
    if neighbor_idx is None:
        idx = knn_select(qxyz, pxyz, n_neighbor)
    else:
        check_one_device(q, neighbor_idx)
        idx = neighbor_idx.to(torch.int32).contiguous()
    out = run_attention_core(MODE_KNN, q, qxyz, pxyz, idx, x_full, None, None, wk, wv, fc_delta,
                             fc_gamma, N, n_neighbor)
    fused_knn_vector_attention.launches += 1
    return (out, idx) if return_idx else out


fused_knn_vector_attention.launches = 0


def fused_anchor_vector_attention(
    q: torch.Tensor,           # (B, M, D) w_qs(query_feat)
    query_xyz: torch.Tensor,   # (B, M, 3)
    k_anchor: torch.Tensor,    # (B, A, D) pre-projected anchor keys
    v_anchor: torch.Tensor,    # (B, A, D)
    anchor_xyz: torch.Tensor,  # (A, 3) or (B, A, 3)
    fc_delta: Sequence[torch.Tensor],
    fc_gamma: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Vector attention of every query over the same A anchors; (B, M, D)."""
    B, M, D = q.shape
    A = k_anchor.shape[1]
    if q.device.type == "cpu":
        return plain_fused_anchor_vector_attention(
            q, query_xyz, k_anchor, v_anchor, anchor_xyz, fc_delta, fc_gamma)
    check_one_device(q, query_xyz, k_anchor, v_anchor, anchor_xyz, *fc_delta, *fc_gamma)
    check_attention_shapes(D)
    _lib.no_grad_guard("fused_anchor_vector_attention", q, query_xyz, k_anchor, v_anchor,
                       anchor_xyz, *fc_delta, *fc_gamma)
    axyz = anchor_xyz.float()
    axyz = (axyz if axyz.dim() == 3 else axyz[None]).expand(B, A, 3).contiguous()
    out = run_attention_core(MODE_ANCHOR, q, query_xyz.float().contiguous(), axyz, None, k_anchor,
                             v_anchor, None, None, None, fc_delta, fc_gamma, A, A)
    fused_anchor_vector_attention.launches += 1
    return out


fused_anchor_vector_attention.launches = 0


def attention_from_idx(q, query_xyz, pt_xyz, x_full, wk, wv, fc_delta, fc_gamma, idx):
    """Vector attention gathered by precomputed indices, in q's dtype
    (``pallas_knn_attn.py:_attention_from_idx``): the differentiable
    recompute behind :func:`knn_vector_attention_trainable`'s backward.
    Weights and features are cast to q's dtype here, so their gradients come
    back in their own dtypes."""
    dt = q.dtype
    with torch.autocast(q.device.type, enabled=False):
        x_g = index_points_mxu(x_full.to(dt), idx)  # (B, M, K, D); backward by K7
        k_g = x_g @ wk.to(dt)
        v_g = x_g @ wv.to(dt)
        nn_xyz = index_points(pt_xyz, idx)  # (B, M, K, 3)
        delta = query_xyz[:, :, None, :] - nn_xyz
        return vector_attention_reference(
            q, k_g, v_g, delta.to(dt), [p.to(dt) for p in fc_delta],
            [p.to(dt) for p in fc_gamma])


def plain_knn_vector_attention_trainable_bwd(q, query_xyz, pt_xyz, x_full, wk, wv, fc_delta,
                                             fc_gamma, idx, dout, needs=None):
    """Plain PyTorch version of :func:`knn_vector_attention_trainable_bwd`:
    autograd through :func:`attention_from_idx` at the saved indices, in q's
    dtype, as the JAX backward differentiates ``_attention_from_idx``."""
    inputs = [q, query_xyz, pt_xyz, x_full, wk, wv, *fc_delta, *fc_gamma]
    needs = (True,) * len(inputs) if needs is None else needs
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = attention_from_idx(*leaves[:6], leaves[6:10], leaves[10:], idx)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout.to(out.dtype), allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


def knn_vector_attention_trainable_bwd(
    q, query_xyz, pt_xyz, x_full, wk, wv,
    fc_delta: Sequence[torch.Tensor],
    fc_gamma: Sequence[torch.Tensor],
    idx: torch.Tensor,   # (B, M, K) the forward's neighbour indices
    dout: torch.Tensor,  # (B, M, D) cotangent of the output
    needs=None,          # 14 flags: which gradients to return (None: all)
):
    """The gradients of :func:`knn_vector_attention_trainable`'s 14 inputs
    (q, query_xyz, pt_xyz, x_full, wk, wv, fc_delta's four, fc_gamma's four)
    at the neighbours ``idx`` and cotangent ``dout`` (K6b), each in its
    input's dtype, None where ``needs`` says it is not wanted.

    CPU tensors take the plain version (autograd through
    :func:`attention_from_idx`); CUDA tensors the chain of
    ``csrc/knn_attn_bwd.cu`` in q's dtype (weights cast to it, as the
    forward casts them): the forward's products rerun, then the backward's
    three, with the softmax backward in closed form, every row buffer in
    the forward chain's row layout; then K7 scatters the rows' [dk | dv |
    -ddelta] to the cloud points, where the products per cloud point and the
    weight gradients are matrix products of the buffers the kernels wrote."""
    needs = (True,) * 14 if needs is None else tuple(needs)
    if q.device.type == "cpu":
        return plain_knn_vector_attention_trainable_bwd(q, query_xyz, pt_xyz, x_full, wk, wv,
                                                        fc_delta, fc_gamma, idx, dout, needs)
    check_one_device(q, query_xyz, pt_xyz, x_full, wk, wv, *fc_delta, *fc_gamma, idx, dout)
    B, M, D = q.shape
    N, K = pt_xyz.shape[1], idx.shape[-1]
    check_attention_shapes(D)
    if tuple(dout.shape) != (B, M, D) or tuple(idx.shape) != (B, M, K):
        raise ValueError(f"dout must be {(B, M, D)} and idx (B, M, K), got "
                         f"{tuple(dout.shape)}, {tuple(idx.shape)}")
    dt, dev, f32 = q.dtype, q.device, torch.float32
    Dp = -(-D // CORE_WIDTH) * CORE_WIDTH
    pad = Dp - D
    w1, b1, w2, b2 = fc_delta
    g0, c0, g1, c1 = fc_gamma
    qc, xc, doc, w1c, b1c, b2c, c0c, c1c = (_padded(t, dt, pad) for t in
                                            (q, x_full, dout, w1, b1, b2, c0, c1))
    w2c, g0c, g1c = (_padded(w, dt, pad, both=True) for w in (w2, g0, g1))
    wkv = torch.cat([_padded(wk, dt, pad, both=True), _padded(wv, dt, pad, both=True)], 1)
    qxyz = query_xyz.float().contiguous()
    cxyz = pt_xyz.float().contiguous()
    ix = idx.to(torch.int32).contiguous()
    rows = core_rows(B, M, K)
    E, SW = rows // B, 2 * Dp + 4
    kv = torch.empty((B, N, 2 * Dp), dtype=f32, device=dev)
    t1, x, h, dg, da, dpos, dt1 = (torch.empty((rows, Dp), dtype=dt, device=dev)
                                   for _ in range(7))
    vp = torch.empty((rows, Dp), dtype=f32, device=dev)
    s = torch.empty((rows, SW), dtype=f32, device=dev)
    dq = torch.empty((B, M, Dp), dtype=f32, device=dev)
    # the row tiles' column sums of dg, da, dpos and dt1 (the bias gradients)
    bsum = torch.empty((4, Dp, rows // CORE_TILE), dtype=f32, device=dev)
    ddp = torch.empty((Dp // CORE_WIDTH, rows, 4), dtype=f32, device=dev)
    delta = torch.empty((rows, 4), dtype=dt, device=dev)
    ridx = torch.empty((rows,), dtype=torch.int32, device=dev)
    dqxyz = torch.empty((B, M, 3), dtype=f32, device=dev)
    _lib.lib().call("poem_knn_attention_bwd", _lib.dtype_code(q), *(t.data_ptr() for t in (
        qc, qxyz, cxyz, ix, xc, wkv, w1c, b1c, w2c, b2c, g0c, c0c, g1c, c1c, doc, kv, t1, x, h,
        vp, dg, da, dpos, dt1, s, dq, bsum, ddp, delta, ridx, dqxyz)), B, M, N, Dp, K,
        1.0 / math.sqrt(D), _lib.stream_ptr(q))
    knn_vector_attention_trainable_bwd.launches += 1
    # the rows' [dk | dv | -ddelta] summed per cloud point, (B, N, 2 Dp + 4) float32
    sc = scatter_add_rows(s.view(B, 1, E, SW), ridx.view(B, 1, E), N)
    skv = sc[..., :2 * Dp].reshape(B * N, 2 * Dp).to(dt)
    grads = [None] * 14
    if needs[0]:
        grads[0] = dq[..., :D]
    if needs[1]:
        grads[1] = dqxyz
    if needs[2]:
        grads[2] = sc[..., 2 * Dp:2 * Dp + 3]
    if needs[3]:  # dx_full = dk Wk^T + dv Wv^T, once a cloud point
        grads[3] = (skv @ wkv.t()).reshape(B, N, Dp)[..., :D]
    if needs[4] or needs[5]:
        dwkv = xc.reshape(B * N, Dp).t() @ skv
        grads[4], grads[5] = dwkv[:D, :D], dwkv[:D, Dp:Dp + D]
    # (W1, b1), (W2, b2), (G0, c0), (G1, c1): a^T d, and the column sums of d
    bias = bsum.sum(-1)[:, :D]  # dc1, dc0, db2, db1
    for i, (a, d) in enumerate(((delta[:, :3], dt1), (t1, dpos), (x, da), (h, dg))):
        if needs[6 + 2 * i]:
            grads[6 + 2 * i] = (a.t() @ d)[:, :D] if i == 0 else (a.t() @ d)[:D, :D]
        if needs[7 + 2 * i]:
            grads[7 + 2 * i] = bias[3 - i]
    inputs = (q, query_xyz, pt_xyz, x_full, wk, wv, *fc_delta, *fc_gamma)
    return tuple(None if g is None else g.to(t.dtype) for g, t in zip(grads, inputs))


knn_vector_attention_trainable_bwd.launches = 0


class _KnnVectorAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n_neighbor, q, query_xyz, pt_xyz, x_full, wk, wv, *mlps):
        fc_delta, fc_gamma = mlps[:4], mlps[4:]

        def run():
            out, idx = fused_knn_vector_attention(q, query_xyz, pt_xyz, x_full, wk, wv,
                                                  fc_delta, fc_gamma, n_neighbor,
                                                  return_idx=True)
            if q.device.type == "cuda":
                knn_vector_attention_trainable.launches += 1
            return out, idx

        out, idx = kernel_outputs(run)
        ctx.save_for_backward(q, query_xyz, pt_xyz, x_full, wk, wv, *mlps, idx)
        return out

    @staticmethod
    def backward(ctx, dout):
        *inputs, idx = ctx.saved_tensors
        return (None, *knn_vector_attention_trainable_bwd(
            *inputs[:6], inputs[6:10], inputs[10:], idx, dout, needs=ctx.needs_input_grad[1:]))


def knn_vector_attention_trainable(
    q: torch.Tensor,          # (B, M, D) w_qs(query_feat)
    query_xyz: torch.Tensor,  # (B, M, 3)
    pt_xyz: torch.Tensor,     # (B, N, 3)
    x_full: torch.Tensor,     # (B, N, D) fc1 activations of the cloud
    wk: torch.Tensor,         # (D, D)
    wv: torch.Tensor,         # (D, D)
    fc_delta: Sequence[torch.Tensor],
    fc_gamma: Sequence[torch.Tensor],
    n_neighbor: int = 32,
) -> torch.Tensor:
    """Training-path exact-KNN vector attention (K6); (B, M, D).

    Forward: K1 with ``return_idx`` (the plain version on the CPU), which
    selects exactly the neighbours eval selects. Backward:
    :func:`knn_vector_attention_trainable_bwd` at the saved indices (K6b on
    the card, autograd through :func:`attention_from_idx` on the CPU), so the
    (B, M, N) distances are never recomputed."""
    return _KnnVectorAttentionTrainable.apply(n_neighbor, q, query_xyz, pt_xyz, x_full, wk, wv,
                                              *fc_delta, *fc_gamma)


knn_vector_attention_trainable.launches = 0


# ---------------------------------------------------------------------------
# K9: exact K-NN restricted to the nearest k-d buckets of a static cloud
# ---------------------------------------------------------------------------

MARGIN_SENTINEL = 3.4e38  # the margin of a block that has no non-candidate bucket
# the most candidate points a query block the selection kernel takes
MAX_CANDIDATE_POINTS = 32768


def box_lower_bound(query_xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(..., 3) queries, (NB, 3) box corners -> (..., NB): the least squared
    distance from each query to each box, ``sum_axis max(lo - q, q - hi, 0)^2``
    summed x, y, z one rounded operation at a time (the kernel's order)."""
    q = query_xyz.float()[..., None, :]
    d = torch.clamp_min(torch.maximum(lo.float() - q, q - hi.float()), 0.0)
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def select_candidate_buckets(query_xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                             block_q: int, n_cand: int) -> torch.Tensor:
    """The ``n_cand`` buckets nearest to each block of ``block_q`` queries, by
    the least box distance of any query of the block.

    query_xyz (B, Mp, 3) with Mp a multiple of ``block_q``; lo / hi (NB, 3).
    Returns (B * Mp / block_q * n_cand,) int32, nearest first. Equal scores
    (every bucket whose box holds a query of the block scores 0) go to the
    lowest bucket id, as ``jax.lax.top_k`` orders them: the order is the
    candidates' column order, which breaks distance ties in the selection."""
    B, Mp, _ = query_xyz.shape
    if Mp % block_q:
        raise ValueError(f"{Mp} queries are not a multiple of block_q={block_q}")
    lb = box_lower_bound(query_xyz.reshape(B, Mp // block_q, block_q, 3), lo, hi)
    score = lb.min(dim=2).values  # (B, nblk, NB)
    order = torch.sort(score, dim=-1, stable=True).indices
    return order[..., :n_cand].to(torch.int32).reshape(-1)


def _pad_queries_edge(query_xyz: torch.Tensor, block_q: int) -> torch.Tensor:
    """Query coordinates padded to a multiple of ``block_q`` by repeating the
    last query, so that pad rows pick no other bucket and leave the margin alone."""
    B, M, _ = query_xyz.shape
    m_pad = _round_up(M, block_q) - M
    if not m_pad:
        return query_xyz
    return torch.cat([query_xyz, query_xyz[:, -1:].expand(B, m_pad, 3)], dim=1)


def _check_buckets(N: int, NB: int, n_neighbor: int, n_cand: int, bucket_size: int) -> None:
    if N != NB * bucket_size:
        raise ValueError(f"the cloud's {N} points are not {NB} buckets of {bucket_size}")
    if n_cand > NB:
        raise ValueError(f"n_cand={n_cand} exceeds the {NB} buckets")
    if n_neighbor > n_cand * bucket_size:
        raise ValueError(f"n_neighbor={n_neighbor} exceeds the {n_cand * bucket_size} "
                         "candidate points")


def knn_select_bucketed_plain(query_xyz, pt_xyz, lo, hi, cand, n_neighbor: int, block_q: int,
                              n_cand: int, bucket_size: int):
    """Plain version of :func:`knn_select_bucketed`."""
    B, M, _ = query_xyz.shape
    K, SB, C = n_neighbor, bucket_size, n_cand
    qxyz = _pad_queries_edge(query_xyz.float(), block_q)
    nblk = qxyz.shape[1] // block_q
    cand = cand.reshape(B, nblk, C).long()
    # cloud index of every candidate column, (B, nblk, C * SB)
    cols = (cand[..., None] * SB + torch.arange(SB, device=cand.device)).reshape(B, nblk, C * SB)
    cand_xyz = index_points(pt_xyz.float(), cols)  # (B, nblk, C * SB, 3)
    qb = qxyz.reshape(B, nblk, block_q, 3)
    d2 = square_distance_rn(qb.reshape(B * nblk, block_q, 3), cand_xyz.reshape(B * nblk, C * SB, 3))
    # K rounds of (smallest d2, lowest candidate column among equals)
    order = torch.sort(d2, dim=-1, stable=True)
    pos = order.indices[..., :K].reshape(B, nblk, block_q * K)
    kth_d2 = order.values[..., K - 1].reshape(B, nblk, block_q)
    idx = torch.gather(cols, 2, pos).reshape(B, nblk * block_q, K)[:, :M].to(torch.int32)

    lb = box_lower_bound(qb, lo, hi)  # (B, nblk, block_q, NB)
    is_cand = torch.zeros((B, nblk, lo.shape[0]), dtype=torch.bool, device=cand.device)
    is_cand.scatter_(2, cand, True)
    lb = lb.masked_fill(is_cand[:, :, None, :], float("inf"))
    margins = (lb.min(dim=-1).values - kth_d2).min(dim=-1).values  # (B, nblk)
    margins = torch.where(torch.isfinite(margins), margins,
                          torch.full_like(margins, MARGIN_SENTINEL))
    return idx, margins


def knn_select_bucketed(query_xyz: torch.Tensor, pt_xyz: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, cand: torch.Tensor, n_neighbor: int, block_q: int,
                        n_cand: int, bucket_size: int):
    """K9's selection alone: for every query its ``n_neighbor`` nearest points
    among the ``n_cand`` candidate buckets of its block (``cand``, as
    :func:`select_candidate_buckets` returns them), as (B, M, K) int32 cloud
    indices in ascending (d2, candidate column) order, and the (B, ceil(M /
    block_q)) float32 margins. The plain version on the CPU,
    ``csrc/knn_bucketed.cu`` on the card (no launch count of its own: it is
    part of K9)."""
    B, M, _ = query_xyz.shape
    N, NB = pt_xyz.shape[1], lo.shape[0]
    _check_buckets(N, NB, n_neighbor, n_cand, bucket_size)
    if query_xyz.device.type == "cpu":
        return knn_select_bucketed_plain(query_xyz, pt_xyz, lo, hi, cand, n_neighbor, block_q,
                                         n_cand, bucket_size)
    check_one_device(query_xyz, pt_xyz, lo, hi, cand)
    if n_cand * bucket_size > MAX_CANDIDATE_POINTS:
        raise ValueError(f"the CUDA kernel takes at most {MAX_CANDIDATE_POINTS} candidate "
                         f"points a block, got {n_cand} x {bucket_size}")
    nblk = _round_up(M, block_q) // block_q
    if cand.numel() != B * nblk * n_cand:
        raise ValueError(f"cand holds {cand.numel()} bucket ids, not {B} x {nblk} x {n_cand}")
    qxyz = query_xyz.float().contiguous()
    pxyz = pt_xyz.float().contiguous()
    lo32, hi32 = lo.float().contiguous(), hi.float().contiguous()
    cand32 = cand.to(torch.int32).contiguous()
    idx = torch.empty((B, M, n_neighbor), dtype=torch.int32, device=qxyz.device)
    margins = torch.empty((B, nblk), dtype=torch.float32, device=qxyz.device)
    qmargin = torch.empty((B, M), dtype=torch.float32, device=qxyz.device)  # per-query scratch
    _lib.lib().call("poem_knn_select_bucketed", qxyz.data_ptr(), pxyz.data_ptr(),
                    cand32.data_ptr(), lo32.data_ptr(), hi32.data_ptr(), idx.data_ptr(),
                    margins.data_ptr(), qmargin.data_ptr(), B, M, N, NB, n_neighbor, block_q,
                    n_cand, bucket_size, _lib.stream_ptr(qxyz))
    return idx, margins


def plain_fused_knn_vector_attention_bucketed(
        q, query_xyz, pt_xyz, x_full, lo, hi, wk, wv, fc_delta, fc_gamma, n_neighbor: int = 32,
        block_q: int = 32, n_cand: int = 8, bucket_size: int = 128, return_idx: bool = False):
    """Plain PyTorch version of :func:`fused_knn_vector_attention_bucketed`."""
    _check_buckets(pt_xyz.shape[1], lo.shape[0], n_neighbor, n_cand, bucket_size)
    cand = select_candidate_buckets(_pad_queries_edge(query_xyz.float(), block_q), lo, hi,
                                    block_q, n_cand)
    idx, margins = knn_select_bucketed_plain(query_xyz, pt_xyz, lo, hi, cand, n_neighbor,
                                             block_q, n_cand, bucket_size)
    out = _plain_attention_at(q, query_xyz, pt_xyz, x_full, wk, wv, fc_delta, fc_gamma, idx)
    return (out, margins, idx) if return_idx else (out, margins)


def fused_knn_vector_attention_bucketed(
    q: torch.Tensor,          # (B, M, D) w_qs(query_feat)
    query_xyz: torch.Tensor,  # (B, M, 3)
    pt_xyz: torch.Tensor,     # (B, N, 3) in bucket-contiguous order
    x_full: torch.Tensor,     # (B, N, D) in the same order
    lo: torch.Tensor,         # (NB, 3) lower corners of the buckets' boxes
    hi: torch.Tensor,         # (NB, 3) upper corners
    wk: torch.Tensor,
    wv: torch.Tensor,
    fc_delta: Sequence[torch.Tensor],
    fc_gamma: Sequence[torch.Tensor],
    n_neighbor: int = 32,
    block_q: int = 32,
    n_cand: int = 8,
    bucket_size: int = 128,
    return_idx: bool = False,
):
    """:func:`fused_knn_vector_attention` over a static cloud laid out by
    ``ops/points.py:build_balanced_buckets``, looking only at the ``n_cand``
    buckets nearest to each block of ``block_q`` queries.

    Returns (out (B, M, D), margins (B, ceil(M / block_q)) float32), plus the
    (B, M, K) int32 cloud indices when ``return_idx``. ``margins >= 0`` proves
    that the block's neighbours are those of a search over the whole cloud
    (ties aside, which go to the lowest candidate column here); with every
    bucket a candidate the margin is ``MARGIN_SENTINEL``. Distances are
    compared as full float32 values, not as K1's packed keys."""
    B, M, D = q.shape
    N, NB = pt_xyz.shape[1], lo.shape[0]
    _check_buckets(N, NB, n_neighbor, n_cand, bucket_size)
    if q.device.type == "cpu":
        return plain_fused_knn_vector_attention_bucketed(
            q, query_xyz, pt_xyz, x_full, lo, hi, wk, wv, fc_delta, fc_gamma, n_neighbor,
            block_q, n_cand, bucket_size, return_idx)
    check_one_device(q, query_xyz, pt_xyz, x_full, lo, hi, wk, wv, *fc_delta, *fc_gamma)
    check_attention_shapes(D)
    _lib.no_grad_guard("fused_knn_vector_attention_bucketed", q, query_xyz, pt_xyz, x_full,
                       wk, wv, *fc_delta, *fc_gamma)
    qxyz = query_xyz.float().contiguous()
    pxyz = pt_xyz.float().contiguous()
    cand = select_candidate_buckets(_pad_queries_edge(qxyz, block_q), lo.float(), hi.float(),
                                    block_q, n_cand)
    idx, margins = knn_select_bucketed(qxyz, pxyz, lo, hi, cand, n_neighbor, block_q, n_cand,
                                       bucket_size)
    out = run_attention_core(MODE_KNN, q, qxyz, pxyz, idx, x_full, None, None, wk, wv, fc_delta,
                             fc_gamma, N, n_neighbor)
    fused_knn_vector_attention_bucketed.launches += 1
    return (out, margins, idx) if return_idx else (out, margins)


fused_knn_vector_attention_bucketed.launches = 0
