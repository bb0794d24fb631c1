"""Dense multi-head cross-attention, forward (kernel K3) and backward (K3b).

Counterpart of ``poem_v2_tpu/ops/pallas_cross_attn.py:dense_cross_attention``
and its custom VJP ``_dense_bwd``: softmax(q_h k_h^T * sm_scale) v_h per
head, no mask, no dropout. :func:`dense_cross_attention` is a
``torch.autograd.Function`` that saves q, k and v, as ``_dense_fwd`` does.
CPU tensors take the plain versions (:func:`plain_dense_cross_attention`
and autograd through it), CUDA tensors the kernels in
``csrc/cross_attn.cu``; there is no fallback from one to the other.

Widths: the kernels take q (B, M, H), k and v (B, N, H) on one CUDA device
with H divisible by ``num_heads``. In bfloat16 (tensor-core tiles) the head
dim H / num_heads must be 32, 64, 128 or 256, the four released tiers' at 4
heads, and every tensor 16-byte aligned; in float32 any head dim from 32 to
256 in steps of 16. The wrappers raise ``ValueError`` for anything else and
``TypeError`` for another dtype; the raw forward raises ``RuntimeError``
under autograd (use :func:`dense_cross_attention`, whose backward is K3b).
"""

from __future__ import annotations

import torch

from . import _lib
from .remat import kernel_outputs


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


def plain_dense_cross_attention_bwd(q, k, v, dout, num_heads: int = 4, sm_scale: float = 0.125):
    """Plain version of the backward: autograd through :func:`plain_dense_cross_attention`."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = plain_dense_cross_attention(qq, kk, vv, num_heads, sm_scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def _check_cuda(q, k, v, num_heads):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, M, H = q.shape
    N = k.shape[1]
    if k.shape != (B, N, H) or v.shape != (B, N, H):
        raise ValueError(f"k, v must be (B, N, H) = ({B}, N, {H}), got {k.shape}, {v.shape}")
    if H % num_heads:
        raise ValueError(f"H={H} not divisible by num_heads={num_heads}")
    hd = H // num_heads
    if q.dtype == torch.bfloat16:
        if hd not in (32, 64, 128, 256):
            raise ValueError(f"the bfloat16 kernels take head dims 32, 64, 128 or 256, got {hd}")
    elif not (32 <= hd <= 256 and hd % 16 == 0):
        raise ValueError(f"the float32 kernels take head dims 32..256 in steps of 16, got {hd}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")


def _check_aligned(*ts):
    """The bfloat16 tensor-core kernels load 16-byte vectors."""
    if ts[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the bfloat16 kernels need 16-byte aligned tensors")


def dense_cross_attention_forward(q, k, v, num_heads: int = 4, sm_scale: float = 0.125):
    """The forward alone: the plain version on the CPU, the K3 kernel on the card."""
    if q.device.type == "cpu":
        return plain_dense_cross_attention(q, k, v, num_heads, sm_scale)
    _check_cuda(q, k, v, num_heads)
    _lib.no_grad_guard("the dense attention forward kernel", q, k, v)
    B, M, H = q.shape
    qc = q.contiguous()
    kc = k.to(q.dtype).contiguous()
    vc = v.to(q.dtype).contiguous()
    out = torch.empty_like(qc)
    _check_aligned(qc, kc, vc, out)
    _lib.lib().call("poem_dense_cross_attention", _lib.dtype_code(qc), qc.data_ptr(),
                    kc.data_ptr(), vc.data_ptr(), out.data_ptr(), B, M, k.shape[1], H,
                    num_heads, float(sm_scale), _lib.stream_ptr(q))
    dense_cross_attention.launches += 1
    return out


def dense_cross_attention_bwd(q, k, v, dout, num_heads: int = 4, sm_scale: float = 0.125):
    """(dq, dk, dv) of :func:`dense_cross_attention` at cotangent ``dout``, in
    the dtypes of q, k, v: the plain version on the CPU, K3b on the card."""
    if q.device.type == "cpu":
        return plain_dense_cross_attention_bwd(q, k, v, dout, num_heads, sm_scale)
    _check_cuda(q, k, v, num_heads)
    B, M, H = q.shape
    N = k.shape[1]
    qc = q.contiguous()
    kc, vc, doc = (t.to(q.dtype).contiguous() for t in (k, v, dout))
    dq, dk, dv = torch.empty_like(qc), torch.empty_like(kc), torch.empty_like(vc)
    lse = torch.empty((B, num_heads, M), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    _check_aligned(qc, kc, vc, doc, dq, dk, dv)
    _lib.lib().call("poem_dense_cross_attention_bwd", _lib.dtype_code(qc), qc.data_ptr(),
                    kc.data_ptr(), vc.data_ptr(), doc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, M, N, H, num_heads,
                    float(sm_scale), _lib.stream_ptr(q))
    dense_cross_attention_bwd.launches += 1
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _DenseCrossAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, sm_scale):
        (out,) = kernel_outputs(
            lambda: (dense_cross_attention_forward(q, k, v, num_heads, sm_scale),))
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = dense_cross_attention_bwd(q, k, v, dout, ctx.num_heads, ctx.sm_scale)
        return dq, dk, dv, None, None


def dense_cross_attention(
    q: torch.Tensor,  # (B, M, H)
    k: torch.Tensor,  # (B, N, H)
    v: torch.Tensor,  # (B, N, H)
    num_heads: int = 4,
    sm_scale: float = 0.125,
) -> torch.Tensor:
    """softmax(q_h k_h^T * sm_scale) v_h per head; returns (B, M, H).
    Differentiable: the backward is K3b (or its plain version)."""
    return _DenseCrossAttention.apply(q, k, v, num_heads, sm_scale)


dense_cross_attention.launches = 0
dense_cross_attention_bwd.launches = 0
