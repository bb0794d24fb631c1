"""Dense multi-head cross-attention, forward (kernel K3) and backward (K3b).

Counterpart of ``poem_v2_tpu/ops/pallas_cross_attn.py:dense_cross_attention``
and its custom VJP ``_dense_bwd``: softmax(q_h k_h^T * sm_scale) v_h per
head, no mask, no dropout. :func:`dense_cross_attention` is a
``torch.autograd.Function`` that saves q, k, v, the output and the rows'
logsumexp ``lse`` (float32, (B, heads, M)); on the card its backward starts
from those (P = exp(S * sm_scale - lse), delta = rowsum(dO * O)) and never
recomputes the softmax statistics. CPU tensors take the plain versions
(:func:`plain_dense_cross_attention`, :func:`plain_dense_cross_attention_lse`
and autograd through the first), CUDA tensors the kernels in
``csrc/cross_attn.cu``; there is no fallback from one to the other.

On the card bfloat16 runs the kernels written for the H100's warpgroup tensor
cores (``wgmma`` on tiles that TMA copies bring into a ring of shared-memory
stages, softmax, P and dS in registers; the tensor maps are encoded per launch
by ``cuTensorMapEncodeTiled``, looked up in the loaded libcuda through
``cudaGetDriverEntryPoint``), float32 simple FMA kernels that serve the parity
checks. The backward is three launches inside one wrapper call (the rows'
(lse, delta) pairs, the dq pass, the dkv pass), deterministic: no atomics,
the same bits on every launch.

Widths: the kernels take q (B, M, H), k and v (B, N, H) on one CUDA device
with H divisible by ``num_heads``, any M and N. In bfloat16 the head dim
H / num_heads must be 16, 32, 64, 128 or 256 (the four released tiers' at 4
heads, and the synthetic ResNet models' 16), every tensor 16-byte aligned and
``sm_scale`` positive (the kernel keeps the running maximum of the raw
logits, as the TPU kernel folds the scale into the exponent); in float32 any
head dim from 16 to 256 in steps of 16.
The wrappers raise ``ValueError`` for anything else and
``TypeError`` for another dtype; the raw forward raises ``RuntimeError``
under autograd (use :func:`dense_cross_attention`, whose backward is K3b).
"""

from __future__ import annotations

import torch

from . import _lib
from .remat import kernel_outputs


def _heads(t, num_heads):
    """(B, L, H) -> float32 (B, heads, L, hd)."""
    B, L, H = t.shape
    return t.float().reshape(B, L, num_heads, H // num_heads).transpose(1, 2)


def plain_dense_cross_attention(q, k, v, num_heads: int = 4, sm_scale: float = 0.125):
    """Plain PyTorch version: float32 logits and softmax, output in q's dtype."""
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    p = torch.softmax((qh @ kh.transpose(-1, -2)) * sm_scale, dim=-1)
    return (p @ vh).transpose(1, 2).reshape(q.shape).to(q.dtype)


def plain_dense_cross_attention_lse(q, k, num_heads: int = 4, sm_scale: float = 0.125):
    """Plain version of the forward's second output: logsumexp over the keys of
    the scaled logits, float32 (B, heads, M)."""
    qh, kh = _heads(q, num_heads), _heads(k, num_heads)
    return torch.logsumexp((qh @ kh.transpose(-1, -2)) * sm_scale, dim=-1)


def plain_dense_cross_attention_bwd(q, k, v, dout, num_heads: int = 4, sm_scale: float = 0.125):
    """Plain version of the backward: autograd through :func:`plain_dense_cross_attention`."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = plain_dense_cross_attention(qq, kk, vv, num_heads, sm_scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def _check_cuda(q, k, v, num_heads, sm_scale):
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
        if hd not in (16, 32, 64, 128, 256):
            raise ValueError(f"the bfloat16 kernels take head dims 16, 32, 64, 128 or 256, "
                             f"got {hd}")
        if not sm_scale > 0:
            raise ValueError(f"the bfloat16 kernels take a positive sm_scale, got {sm_scale}")
    elif not (16 <= hd <= 256 and hd % 16 == 0):
        raise ValueError(f"the float32 kernels take head dims 16..256 in steps of 16, got {hd}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")


def _check_aligned(*ts):
    """The bfloat16 kernels' tensor maps need 16-byte aligned tensors."""
    if ts[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the bfloat16 kernels need 16-byte aligned tensors")


def plain_dense_cross_attention_bwd_from_lse(q, k, v, out, lse, dout, num_heads: int = 4,
                                             sm_scale: float = 0.125):
    """The backward kernels' formulas with tensors: from the forward's ``out``
    and ``lse``, P = exp(S * sm_scale - lse), delta = rowsum(dO * O),
    dS = P * (dO V^T - delta) * sm_scale, dQ = dS K, dK = dS^T Q, dV = P^T dO,
    all in float32, returned in the dtypes of q, k, v."""
    qh, kh, vh, oh, doh = (_heads(t, num_heads) for t in (q, k, v, out, dout))
    p = torch.exp((qh @ kh.transpose(-1, -2)) * sm_scale - lse.float()[..., None])
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = p * (doh @ vh.transpose(-1, -2) - delta) * sm_scale
    dq, dk, dv = ds @ kh, ds.transpose(-1, -2) @ qh, p.transpose(-1, -2) @ doh
    return tuple(g.transpose(1, 2).reshape(t.shape).to(t.dtype)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


def dense_cross_attention_forward(q, k, v, num_heads: int = 4, sm_scale: float = 0.125,
                                  return_lse: bool = False):
    """The forward alone: the plain version on the CPU, the K3 kernel on the
    card. With ``return_lse`` it returns (out, lse), the rows' logsumexp as
    float32 (B, heads, M), which the kernel writes in the same launch."""
    if q.device.type == "cpu":
        out = plain_dense_cross_attention(q, k, v, num_heads, sm_scale)
        if not return_lse:
            return out
        return out, plain_dense_cross_attention_lse(q, k, num_heads, sm_scale)
    _check_cuda(q, k, v, num_heads, sm_scale)
    _lib.no_grad_guard("the dense attention forward kernel", q, k, v)
    B, M, H = q.shape
    qc = q.contiguous()
    kc = k.to(q.dtype).contiguous()
    vc = v.to(q.dtype).contiguous()
    out = torch.empty_like(qc)
    lse = torch.empty((B, num_heads, M), dtype=torch.float32, device=q.device) \
        if return_lse else None
    _check_aligned(qc, kc, vc, out)
    _lib.lib().call("poem_dense_cross_attention", _lib.dtype_code(qc), qc.data_ptr(),
                    kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if return_lse else None, B, M, k.shape[1], H,
                    num_heads, float(sm_scale), _lib.stream_ptr(q))
    dense_cross_attention.launches += 1
    return (out, lse) if return_lse else out


def dense_cross_attention_bwd(q, k, v, dout, num_heads: int = 4, sm_scale: float = 0.125,
                              out=None, lse=None):
    """(dq, dk, dv) of :func:`dense_cross_attention` at cotangent ``dout``, in
    the dtypes of q, k, v: the plain version on the CPU, K3b on the card.

    With the forward's ``out`` and ``lse`` it is the backward alone, which is
    what the autograd Function calls. Without them it first obtains both by
    the forward (on the card one launch of K3, counted as such). The plain
    version differentiates the plain forward and has no use for the pair;
    :func:`plain_dense_cross_attention_bwd_from_lse` states what the kernels
    compute from it."""
    if (out is None) != (lse is None):
        raise ValueError("give both out and lse, or neither")
    if q.device.type == "cpu":
        return plain_dense_cross_attention_bwd(q, k, v, dout, num_heads, sm_scale)
    _check_cuda(q, k, v, num_heads, sm_scale)
    B, M, H = q.shape
    N = k.shape[1]
    if out is None:
        with torch.no_grad():
            out, lse = dense_cross_attention_forward(q, k, v, num_heads, sm_scale,
                                                     return_lse=True)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B, num_heads, M):
        raise ValueError(f"out and dout must be {tuple(q.shape)} and lse {(B, num_heads, M)}, "
                         f"got {tuple(out.shape)}, {tuple(dout.shape)}, {tuple(lse.shape)}")
    qc = q.contiguous()
    kc, vc, oc, doc = (t.to(q.dtype).contiguous() for t in (k, v, out, dout))
    lsec = lse.float().contiguous()
    dq, dk, dv = torch.empty_like(qc), torch.empty_like(kc), torch.empty_like(vc)
    # scratch for the kernels' (lse, delta) pairs, rows padded to a block's 128
    stats = torch.empty((B, num_heads, -(-M // 128) * 128, 2), dtype=torch.float32,
                        device=q.device)
    _check_aligned(qc, kc, vc, oc, doc, dq, dk, dv)
    _lib.lib().call("poem_dense_cross_attention_bwd", _lib.dtype_code(qc), qc.data_ptr(),
                    kc.data_ptr(), vc.data_ptr(), oc.data_ptr(), doc.data_ptr(),
                    lsec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    stats.data_ptr(), B, M, N, H, num_heads, float(sm_scale),
                    _lib.stream_ptr(q))
    dense_cross_attention_bwd.launches += 1
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _DenseCrossAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, sm_scale):
        out, lse = kernel_outputs(
            lambda: dense_cross_attention_forward(q, k, v, num_heads, sm_scale, return_lse=True))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = dense_cross_attention_bwd(q, k, v, dout, ctx.num_heads, ctx.sm_scale,
                                               out=out, lse=lse)
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
