"""Scatter-add of gathered-row gradients (kernel K7) and the gather it undoes.

Counterparts of ``poem_v2_tpu/ops/pallas_scatter.py``:

* :func:`scatter_add_rows` <- ``scatter_add_rows``: out[b, idx[b, m, k]] +=
  grads[b, m, k] into a (B, n_rows, D) float32 output. CPU tensors take
  :func:`plain_scatter_add_rows` (``index_add_`` in float32), CUDA tensors
  the deterministic kernels in ``csrc/scatter.cu``: a stable counting sort
  of the entries into rows, in parallel over segments of ``SEGMENT``
  entries of each sample (histogram, scan, placement), then each row summed
  in ascending entry order with 16-byte loads. Two launches on one input
  give the same bits; a call counts one launch.
* :func:`index_points_mxu` <- ``index_points_mxu``: a plain row gather
  whose backward is :func:`scatter_add_rows` cast to the points' dtype.

Indices outside [0, n_rows) contribute nothing, as in the TPU kernel.
"""

from __future__ import annotations

import torch

from . import _lib
from .points import index_points

SEGMENT = 1024  # entries a segment of the sort (csrc/scatter.cu: SC_SEG)
MAX_ROWS = 51200  # a segment's histogram of the rows lives in 200 KB of shared memory


def plain_scatter_add_rows(grads: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` in float32."""
    B, M, K, D = grads.shape
    flat_idx = idx.reshape(B, M * K).long()
    valid = (flat_idx >= 0) & (flat_idx < n_rows)
    rows = (torch.arange(B, device=idx.device)[:, None] * n_rows
            + flat_idx.clamp(0, n_rows - 1)).reshape(-1)
    src = torch.where(valid[..., None], grads.reshape(B, M * K, D).float(), 0.0)
    out = torch.zeros((B * n_rows, D), dtype=torch.float32, device=grads.device)
    out.index_add_(0, rows, src.reshape(-1, D))
    return out.reshape(B, n_rows, D)


def scatter_add_rows(
    grads: torch.Tensor,  # (B, M, K, D) float32 or bfloat16
    idx: torch.Tensor,    # (B, M, K) int32 in [0, n_rows)
    n_rows: int,
) -> torch.Tensor:
    """out[b, idx[b, m, k], :] += grads[b, m, k, :] -> (B, n_rows, D) float32."""
    if grads.device.type == "cpu":
        return plain_scatter_add_rows(grads, idx, n_rows)
    if grads.device.type != "cuda":
        raise ValueError(f"unsupported device {grads.device}")
    B, M, K, D = grads.shape
    if idx.shape != (B, M, K):
        raise ValueError(f"idx must be (B, M, K) = ({B}, {M}, {K}), got {tuple(idx.shape)}")
    if idx.device != grads.device:
        raise ValueError("grads and idx must be on one device")
    if not 1 <= n_rows <= MAX_ROWS:
        raise ValueError(f"the CUDA kernel takes 1 <= n_rows <= {MAX_ROWS}, got {n_rows}")
    E = M * K
    g = grads.contiguous()
    ix = idx.to(torch.int32).contiguous()
    dev = grads.device
    out = torch.empty((B, n_rows, D), dtype=torch.float32, device=dev)
    # the segments' histograms, the first slots within each row, the row totals
    counts = torch.empty((B * (2 * -(-E // SEGMENT) + 1) * n_rows,), dtype=torch.int32,
                         device=dev)
    offsets = torch.empty((B, n_rows + 1), dtype=torch.int32, device=dev)
    perm = torch.empty((B, E), dtype=torch.int32, device=dev)
    _lib.lib().call("poem_scatter_add_rows", _lib.dtype_code(g), g.data_ptr(), ix.data_ptr(),
                    out.data_ptr(), counts.data_ptr(), offsets.data_ptr(), perm.data_ptr(),
                    B, E, n_rows, D, _lib.stream_ptr(grads))
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


class _IndexPointsMXU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = points.shape[1], points.dtype
        return index_points(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_add_rows(grad, idx, ctx.n_rows).to(ctx.dtype), None


def index_points_mxu(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, D), idx (B, M, K) -> (B, M, K, D); backward by :func:`scatter_add_rows`."""
    return _IndexPointsMXU.apply(points, idx)
