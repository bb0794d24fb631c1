"""Vector attention on pre-gathered neighbours (kernel K8, and the training math).

Counterparts of ``poem_v2_tpu/ops/pallas_vector_attn.py``:

* :func:`fused_vector_attention` <- ``fused_vector_attention`` (K8): the
  attention core of the point-transformer blocks on keys, values and
  offsets the caller has gathered. CPU tensors take the plain version
  :func:`vector_attention_plain`, CUDA tensors the kernels in
  ``csrc/knn_attn.cu`` (the core it shares with K1 and K2, launched by
  :func:`run_attention_core`); there is no fallback from one to the other.
  ``fused_vector_attention.launches`` counts calls that launched the core.
  Eval only: it has no backward and raises on the card when autograd would
  need one. It takes any K and D a multiple of 4 up to 1024, float32 or
  bfloat16, and raises for others. Numerics follow the TPU kernel: operands
  of the four products are cast to the compute dtype (that of ``q``),
  products accumulate in float32, and ``x = q - k + pos``, the softmax and
  the aggregate stay float32. In bfloat16 the core is a chain of tensor-core
  kernels over row tiles of 128 whose intermediates (x, h in bfloat16,
  v + pos in float32; K1's projected cloud in float32) live in scratch that
  :func:`run_attention_core` allocates; widths that are no multiple of 128 are padded with zero
  channels, which changes no real channel. Float32 runs the scalar FMA kernel.
* :func:`vector_attention_reference` <- ``vector_attention_reference``,
  the training math: every product, the softmax over the neighbour axis
  and the aggregate run in the inputs' dtype, with the 1/sqrt(D) scale
  cast to it, as the JAX function computes them. In float32 the two agree
  to rounding.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _lib

MAX_D = 1024  # the float32 kernel: three [16][D] float32 buffers of a block must fit 227 KB
CORE_TILE = 128  # rows of a tile of the bfloat16 chain (csrc/knn_attn.cu: CR)
CORE_WIDTH = 128  # the bfloat16 chain takes widths that are multiples of this
MODE_KNN, MODE_ANCHOR, MODE_GATHERED = 0, 1, 2


def vector_attention_reference(
    q: torch.Tensor,      # (B, M, D)
    k_g: torch.Tensor,    # (B, M, K, D)
    v_g: torch.Tensor,    # (B, M, K, D)
    delta: torch.Tensor,  # (B, M, K, 3)
    fc_delta: Sequence[torch.Tensor],  # (w1 (3, D), b1, w2 (D, D), b2)
    fc_gamma: Sequence[torch.Tensor],  # (g0 (D, D), c0, g1 (D, D), c1)
) -> torch.Tensor:
    """(B, M, D): sum_k softmax_k(gamma(q - k + pos)) * (v + pos), pos = delta(xyz)."""
    with torch.autocast(q.device.type, enabled=False):
        w1, b1, w2, b2 = fc_delta
        g0, c0, g1, c1 = fc_gamma
        t1 = torch.relu(delta @ w1 + b1)
        pos = t1 @ w2 + b2
        x = q[:, :, None] - k_g + pos
        g = torch.relu(x @ g0 + c0) @ g1 + c1
        # sqrt(D) rounded to float32, then to g's dtype, as jnp.sqrt(float32(D)).astype
        scale = float(torch.tensor(math.sqrt(k_g.shape[-1]), dtype=torch.float32).to(g.dtype))
        attn = torch.softmax(g / scale, dim=-2)
        return (attn * (v_g + pos)).sum(-2)


def _rounded(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """t rounded to ``dt``, as float32. Under autograd the rounding passes the
    gradient through unchanged: the gradient of a plain version is then the
    float32 gradient at its rounded values (what K6b computes), not one
    rounded to ``dt`` at every cast. The values are the same either way."""
    r = t.to(dt).float()
    if t.dtype == dt or not (torch.is_grad_enabled() and t.requires_grad):
        return r
    t = t.float()
    return t + (r - t).detach()  # exactly r: r - t is exact, r representable


def _mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x @ w with both operands rounded to ``dt``, accumulated in float32."""
    return _rounded(x, dt) @ _rounded(w, dt)


def vector_attention_plain(
    q: torch.Tensor,         # (B, M, D)
    k: torch.Tensor,         # (B, M, K, D) float32 keys
    v: torch.Tensor,         # (B, M, K, D) float32 values
    delta: torch.Tensor,     # (B, M, K, 3) float32 q_xyz - nn_xyz
    fc_delta: Sequence[torch.Tensor],
    fc_gamma: Sequence[torch.Tensor],
) -> torch.Tensor:
    """The attention the kernels K1, K2 and K8 compute, on gathered
    neighbours, with their roundings; (B, M, D) in q's dtype."""
    dt = q.dtype
    w1, b1, w2, b2 = fc_delta
    g0, c0, g1, c1 = fc_gamma
    t1 = torch.relu(_mm(delta, w1, dt) + _rounded(b1, dt))
    pos = _mm(t1, w2, dt) + _rounded(b2, dt)
    x = q.float()[:, :, None] - k + pos
    h = torch.relu(_mm(x, g0, dt) + _rounded(c0, dt))
    g = (_mm(h, g1, dt) + _rounded(c1, dt)) * (1.0 / math.sqrt(q.shape[-1]))
    attn = torch.softmax(g, dim=-2)
    return torch.sum(attn * (v + pos), dim=-2).to(dt)


def check_attention_shapes(D: int) -> None:
    """What csrc/knn_attn.cu takes: D % 4 == 0 up to 1024 (any neighbour count)."""
    if D < 4 or D > MAX_D or D % 4:
        raise ValueError(f"the CUDA kernel takes D % 4 == 0 up to {MAX_D}, got D={D}")


def core_rows(B: int, M: int, K: int) -> int:
    """Rows of the bfloat16 chain's intermediates: tiles of 128 that hold
    floor(128 / K) whole queries, or ceil(K / 128) tiles a query for K > 128."""
    tiles = -(-M // (CORE_TILE // K)) if K <= CORE_TILE else M * -(-K // CORE_TILE)
    return B * tiles * CORE_TILE


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _padded(t: torch.Tensor, dt: torch.dtype, pad: int, both: bool = False) -> torch.Tensor:
    """t in dtype ``dt`` with ``pad`` zero channels after its last dimension
    (and its first too, for a square weight, with ``both``), 16-byte aligned."""
    t = t.to(dt)
    if pad:
        t = F.pad(t, (0, pad, 0, pad) if both else (0, pad))
    return _aligned(t)


def run_attention_core(mode: int, q, qxyz, cxyz, idx, xk, va, delta, wk, wv, fc_delta, fc_gamma,
                       N: int, K: int) -> torch.Tensor:
    """Launch the attention core of ``csrc/knn_attn.cu`` on CUDA tensors;
    (B, M, D) in q's dtype.

    mode MODE_KNN (K1): ``idx`` (B, M, K) int32 rows of ``xk`` = x_full (B, N, D),
    projected by ``wk`` / ``wv``; MODE_ANCHOR (K2): ``xk`` / ``va`` (B, N, D)
    anchors' keys / values at ``cxyz`` (B, N, 3); MODE_GATHERED (K8): ``xk`` /
    ``va`` (B, M, K, D) and ``delta`` (B, M, K, 3). Feature tensors and weights
    are taken in q's dtype; xyz float32."""
    B, M, D = q.shape
    dt = q.dtype
    code = _lib.dtype_code(q)
    ws = [*(() if wk is None else (wk, wv)), *fc_delta, *fc_gamma]
    # bf16: zero channels up to a multiple of 128; every product's sum and every
    # real channel stay as they were
    Dp = -(-D // CORE_WIDTH) * CORE_WIDTH if dt == torch.bfloat16 else D
    pad = Dp - D
    qc, kc, vc = (None if t is None else _padded(t, dt, pad) for t in (q, xk, va))
    ws = [_padded(w, dt, pad, both=w.dim() == 2 and w.shape[0] == D) for w in ws]
    if wk is None:
        ws = [None, None, *ws]
    dl = None if delta is None else delta.to(dt).contiguous()
    out = torch.empty((B, M, Dp), dtype=dt, device=q.device)
    kv = ta = tb = vp = None
    if dt == torch.bfloat16:
        rows = core_rows(B, M, K)
        ta = torch.empty((rows, Dp), dtype=dt, device=q.device)
        tb = torch.empty_like(ta)
        vp = torch.empty((rows, Dp), dtype=torch.float32, device=q.device)
        if mode == MODE_KNN:
            kv = torch.empty((B, N, 2 * Dp), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    _lib.lib().call("poem_vector_attention", code, mode, qc.data_ptr(), ptr(qxyz), ptr(cxyz),
                    ptr(idx), ptr(kc), ptr(vc), ptr(dl), *[ptr(w) for w in ws], out.data_ptr(),
                    ptr(kv), ptr(ta), ptr(tb), ptr(vp), B, M, N, Dp, K,
                    1.0 / math.sqrt(D), _lib.stream_ptr(q))
    return out if Dp == D else out[..., :D]


def check_one_device(*ts) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got one on {t.device}")


def plain_fused_vector_attention(q, k_g, v_g, delta, fc_delta, fc_gamma):
    """Plain PyTorch version of :func:`fused_vector_attention`."""
    dt = q.dtype
    return vector_attention_plain(q, k_g.to(dt).float(), v_g.to(dt).float(), delta, fc_delta,
                                  fc_gamma)


def fused_vector_attention(
    q: torch.Tensor,      # (B, M, D) w_qs-projected queries
    k_g: torch.Tensor,    # (B, M, K, D) gathered, w_ks-projected
    v_g: torch.Tensor,    # (B, M, K, D)
    delta: torch.Tensor,  # (B, M, K, 3) q_xyz - neighbour xyz
    fc_delta: Sequence[torch.Tensor],
    fc_gamma: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Vector attention of every query over its K gathered neighbours; (B, M, D)."""
    B, M, K, D = k_g.shape
    if q.shape != (B, M, D) or v_g.shape != (B, M, K, D) or delta.shape != (B, M, K, 3):
        raise ValueError(f"shapes do not fit q (B, M, D), k_g / v_g (B, M, K, D), delta "
                         f"(B, M, K, 3): {tuple(q.shape)}, {tuple(k_g.shape)}, "
                         f"{tuple(v_g.shape)}, {tuple(delta.shape)}")
    if q.device.type == "cpu":
        return plain_fused_vector_attention(q, k_g, v_g, delta, fc_delta, fc_gamma)
    check_one_device(q, k_g, v_g, delta, *fc_delta, *fc_gamma)
    check_attention_shapes(D)
    _lib.no_grad_guard("fused_vector_attention", q, k_g, v_g, delta, *fc_delta, *fc_gamma)
    out = run_attention_core(MODE_GATHERED, q, None, None, None, k_g, v_g, delta, None, None,
                             fc_delta, fc_gamma, 0, K)
    fused_vector_attention.launches += 1
    return out


fused_vector_attention.launches = 0
