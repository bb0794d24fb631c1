"""Dense multi-head cross-attention, forward (kernel K3).

Counterpart of ``poem_v2_tpu/ops/pallas_cross_attn.py:dense_cross_attention``:
softmax(q_h k_h^T * sm_scale) v_h per head, no mask, no dropout. CPU
tensors take :func:`plain_dense_cross_attention`, CUDA tensors the kernel
in ``csrc/cross_attn.cu``. The backward (training) is not ported yet.
"""

from __future__ import annotations

import torch

from . import _lib


def plain_dense_cross_attention(q, k, v, num_heads: int = 4, sm_scale: float = 0.125):
    """Plain PyTorch version: float32 logits and softmax, output in q's dtype."""
    B, M, H = q.shape
    N = k.shape[1]
    hd = H // num_heads
    qh = q.float().reshape(B, M, num_heads, hd).transpose(1, 2)
    kh = k.float().reshape(B, N, num_heads, hd).transpose(1, 2)
    vh = v.float().reshape(B, N, num_heads, hd).transpose(1, 2)
    p = torch.softmax((qh @ kh.transpose(-1, -2)) * sm_scale, dim=-1)
    return (p @ vh).transpose(1, 2).reshape(B, M, H).to(q.dtype)


def dense_cross_attention(
    q: torch.Tensor,  # (B, M, H)
    k: torch.Tensor,  # (B, N, H)
    v: torch.Tensor,  # (B, N, H)
    num_heads: int = 4,
    sm_scale: float = 0.125,
) -> torch.Tensor:
    """softmax(q_h k_h^T * sm_scale) v_h per head; returns (B, M, H)."""
    if q.device.type == "cpu":
        return plain_dense_cross_attention(q, k, v, num_heads, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, M, H = q.shape
    N = k.shape[1]
    if k.shape != (B, N, H) or v.shape != (B, N, H):
        raise ValueError(f"k, v must be (B, N, H) = ({B}, N, {H}), got {k.shape}, {v.shape}")
    if H % num_heads:
        raise ValueError(f"H={H} not divisible by num_heads={num_heads}")
    hd = H // num_heads
    if not (32 <= hd <= 256 and hd % 16 == 0):
        raise ValueError(f"the CUDA kernel takes head dims 32..256 in steps of 16, got {hd}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    qc = q.contiguous()
    kc = k.to(q.dtype).contiguous()
    vc = v.to(q.dtype).contiguous()
    out = torch.empty_like(qc)
    _lib.lib().call("poem_dense_cross_attention", _lib.dtype_code(qc), qc.data_ptr(),
                    kc.data_ptr(), vc.data_ptr(), out.data_ptr(), B, M, N, H, num_heads,
                    float(sm_scale), _lib.stream_ptr(q))
    dense_cross_attention.launches += 1
    return out


dense_cross_attention.launches = 0
