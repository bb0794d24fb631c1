"""The merge-input scramble of a mixed-view batch (kernel K5).

Counterpart of ``poem_v2_tpu/ops/pallas_scramble.py:scrambled_merge_gather``.
The head must reproduce the reference's ``.view(1, -1, V, C)`` of the
(V, C, NS)-contiguous sampled features: output row (i, j) of sample b is
the C-element run at ``(i * n_b + j) * C`` of the sample's flat layout,
``n_b`` its number of valid views. Rows with ``j >= n_b`` alias later data
(clamped to the last row) and are masked by the merge.

CPU tensors take the plain row gather, CUDA tensors the kernel in
``csrc/scramble.cu``; there is no fallback from one to the other.
``scrambled_merge_gather.launches`` counts kernel launches. Eval only: it
has no backward and raises on the card when autograd would need one
(training keeps the differentiable :func:`plain_scrambled_merge_gather`).

The kernel is a copy of 16-byte vectors: it takes any dtype whose row of C
elements is a multiple of 16 bytes (C % 4 == 0 in float32, C % 8 == 0 in
bfloat16) and raises ``ValueError`` otherwise. ``n_val`` holds counts in
0..V and is read on the device, unchecked. It has none of the TPU kernel's
tiling limits (``NS % 64``, ``C % 128``).
"""

from __future__ import annotations

import torch

from . import _lib


def scramble_row_index(n_val: torch.Tensor, V: int, NS: int) -> torch.Tensor:
    """(B, NS * V) int64 source rows: min(i * n_b + j, V * NS - 1) at (i, j)."""
    dev = n_val.device
    r = (torch.arange(NS, device=dev)[None, :, None] * n_val.long()[:, None, None]
         + torch.arange(V, device=dev)[None, None, :])
    return torch.clamp_max(r, V * NS - 1).reshape(n_val.shape[0], NS * V)


def plain_scrambled_merge_gather(flat: torch.Tensor, n_val: torch.Tensor, V: int,
                                 C: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`scrambled_merge_gather` (differentiable)."""
    B = flat.shape[0]
    NS = flat.shape[1] // (V * C)
    rows = flat.reshape(B, V * NS, C)
    r = scramble_row_index(n_val, V, NS)
    return torch.gather(rows, 1, r[..., None].expand(B, NS * V, C)).reshape(B, NS, V, C)


def scrambled_merge_gather(
    flat: torch.Tensor,   # (B, V * NS * C): each sample's (V, C, NS) layout, flat
    n_val: torch.Tensor,  # (B,) integer valid view counts, 1..V
    V: int,
    C: int,
) -> torch.Tensor:
    """(B, NS, V, C) with row (i, j) of sample b = flat[b, (i * n_b + j) * C : + C]."""
    if flat.dim() != 2 or flat.shape[1] % (V * C) or n_val.shape != (flat.shape[0],):
        raise ValueError(f"flat must be (B, V * NS * C) and n_val (B,), got {tuple(flat.shape)}, "
                         f"{tuple(n_val.shape)} with V={V}, C={C}")
    if flat.device.type == "cpu":
        return plain_scrambled_merge_gather(flat, n_val, V, C)
    if flat.device.type != "cuda" or n_val.device != flat.device:
        raise ValueError(f"flat and n_val must be on one CUDA device, got {flat.device}, "
                         f"{n_val.device}")
    row_bytes = C * flat.element_size()
    if row_bytes % 16:
        raise ValueError(f"the CUDA kernel copies 16-byte vectors: a row of C={C} "
                         f"{flat.dtype} elements has {row_bytes} bytes")
    _lib.no_grad_guard("scrambled_merge_gather", flat)
    B = flat.shape[0]
    NS = flat.shape[1] // (V * C)
    src = flat.contiguous()
    n32 = n_val.to(torch.int32).contiguous()
    out = torch.empty((B, NS, V, C), dtype=flat.dtype, device=flat.device)
    _lib.lib().call("poem_scramble_rows", src.data_ptr(), n32.data_ptr(), out.data_ptr(),
                    B, V, NS, row_bytes, _lib.stream_ptr(flat))
    scrambled_merge_gather.launches += 1
    return out


scrambled_merge_gather.launches = 0
