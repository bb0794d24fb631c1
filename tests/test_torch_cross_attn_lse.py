"""The dense attention's logsumexp and the backward that starts from it, on the CPU.

On the card K3 writes the rows' logsumexp beside the output and K3b takes
both (P = exp(S * scale - lse), delta = rowsum(dO * O)) instead of
recomputing the softmax statistics. The kernels cannot run here; these tests
hold the algebra they implement, written with tensors
(``plain_dense_cross_attention_lse``, ``plain_dense_cross_attention_bwd_from_lse``),
against the JAX package (its Pallas kernel with ``interpret=True``, matmul
precision "highest") and the plumbing around them: what the autograd
Function saves, what the remat recompute replays, and the wrapper's two
call forms. Inputs are numpy arrays from a seed, float32 on both sides;
limits are 1e-5 absolute for the logsumexp and 1e-5 x max|JAX| for the
gradients, both sides summing in float32 in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from poem_v2_tpu_torch.ops import cross_attn, remat

NH = 4


def _inputs(hd, N, B=2, M=67):
    rs = np.random.RandomState(hd + N)
    H = NH * hd
    return [rs.randn(B, n, H).astype(np.float32) for n in (M, N, N, M)]


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, rel=1e-5, msg=""):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    lim = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{msg}: max abs err {err:.3e} > {lim:.3e}"


@pytest.mark.parametrize("hd,N", [(32, 150), (64, 150), (64, 300)])
def test_plain_lse_is_the_logsumexp_of_jax_scaled_logits(hd, N):
    q, k, _, _ = _inputs(hd, N)
    B, M, H = q.shape
    scale = hd ** -0.5
    with jax.default_matmul_precision("highest"):
        qh = jnp.asarray(q).reshape(B, M, NH, hd)
        kh = jnp.asarray(k).reshape(B, N, NH, hd)
        want = jax.nn.logsumexp(jnp.einsum("bmhd,bnhd->bhmn", qh, kh) * scale, axis=-1)
    got = cross_attn.plain_dense_cross_attention_lse(_t(q), _t(k), NH, scale)
    assert got.shape == (B, NH, M) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5
    # the forward's second output on the CPU is this function
    out, lse = cross_attn.dense_cross_attention_forward(_t(q), _t(k), _t(k), NH, scale,
                                                        return_lse=True)
    assert torch.equal(lse, got) and out.shape == q.shape


@pytest.mark.parametrize("hd,N", [(32, 150), (32, 300), (64, 150), (64, 300)])
def test_backward_from_out_and_lse_matches_jax_vjp(hd, N):
    """The backward kernels' formulas, from the forward's (out, lse), against
    ``jax.vjp`` of the Pallas ``dense_cross_attention`` (N is no multiple of
    128: its padded-key masking runs) and against autograd through the plain
    forward."""
    from poem_v2_tpu.ops.pallas_cross_attn import dense_cross_attention as jdense

    q, k, v, do = _inputs(hd, N)
    scale = hd ** -0.5
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(lambda a, b, c: jdense(a, b, c, num_heads=NH, sm_scale=scale,
                                                    interpret=True), q, k, v)
        grads_j = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (_t(a) for a in (q, k, v, do))
    out, lse = cross_attn.dense_cross_attention_forward(qt, kt, vt, NH, scale, return_lse=True)
    _close(out, out_j, msg="out")
    grads = cross_attn.plain_dense_cross_attention_bwd_from_lse(qt, kt, vt, out, lse, dot, NH,
                                                                scale)
    plain = cross_attn.plain_dense_cross_attention_bwd(qt, kt, vt, dot, NH, scale)
    for name, g, gj, gp in zip("qkv", grads, grads_j, plain):
        assert g.shape == gp.shape and g.dtype == gp.dtype
        _close(g, gj, msg=f"d{name} vs jax.vjp")
        _close(g, gp, msg=f"d{name} vs the plain backward")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_with_and_without_saved_out_and_lse_agree(dtype):
    """``dense_cross_attention_bwd`` takes the saved pair or obtains it itself:
    the same gradients either way (here the plain version, which needs no
    pair), and those the kernels' formulas give from the pair."""
    q, k, v, do = (_t(a).to(dtype) for a in _inputs(32, 100, M=19))
    scale = 32 ** -0.5
    out, lse = cross_attn.dense_cross_attention_forward(q, k, v, NH, scale, return_lse=True)
    saved = cross_attn.dense_cross_attention_bwd(q, k, v, do, NH, scale, out=out, lse=lse)
    alone = cross_attn.dense_cross_attention_bwd(q, k, v, do, NH, scale)
    algebra = cross_attn.plain_dense_cross_attention_bwd_from_lse(q, k, v, out, lse, do, NH,
                                                                  scale)
    # bfloat16: the saved output is rounded, so delta = rowsum(dO * O) carries
    # 2**-9 of O where autograd carries none
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for name, a, b, c, t in zip("qkv", saved, alone, algebra, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape and torch.equal(a, b)
        _close(c, a.float().numpy(), rel=rel, msg=f"d{name}")


@pytest.mark.parametrize("missing", ["out", "lse"])
def test_bwd_refuses_half_of_the_saved_pair(missing):
    q, k, v, do = (_t(a) for a in _inputs(32, 40, M=9))
    out, lse = cross_attn.dense_cross_attention_forward(q, k, v, NH, 0.2, return_lse=True)
    kw = dict(out=out, lse=lse)
    kw[missing] = None
    with pytest.raises(ValueError, match="both out and lse"):
        cross_attn.dense_cross_attention_bwd(q, k, v, do, NH, 0.2, **kw)


def test_function_saves_out_and_lse_and_its_backward_uses_them(monkeypatch):
    """The Function keeps (q, k, v, out, lse) and hands the pair to the
    backward wrapper; on the CPU its gradients are bit for bit those of
    autograd through the plain forward."""
    q, k, v, do = (_t(a, i < 3) for i, a in enumerate(_inputs(32, 90, M=21)))
    seen = {}
    real = cross_attn.dense_cross_attention_bwd

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(cross_attn, "dense_cross_attention_bwd", spy)
    out = cross_attn.dense_cross_attention(q, k, v, NH, 0.2)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[3].shape == out.shape
    assert saved[4].shape == (q.shape[0], NH, q.shape[1]) and saved[4].dtype == torch.float32
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert torch.equal(seen["out"], out.detach()) and torch.equal(seen["lse"], saved[4])
    plain = cross_attn.plain_dense_cross_attention_bwd(q.detach(), k.detach(), v.detach(), do,
                                                       NH, 0.2)
    for g, gp in zip(grads, plain):
        assert torch.equal(g, gp)


def test_remat_replays_out_and_lse_without_a_forward_call(monkeypatch):
    """Inside a checkpointed block the Function's forward runs once: the store
    records the (out, lse) pair and the recompute hands both back, so the
    backward sees the first forward's bits."""
    calls = []
    real = cross_attn.dense_cross_attention_forward

    def counted(*a, **kw):
        calls.append(kw.get("return_lse"))
        return real(*a, **kw)

    monkeypatch.setattr(cross_attn, "dense_cross_attention_forward", counted)
    q, k, v, do = (_t(a, i < 3) for i, a in enumerate(_inputs(32, 70, M=17)))
    w = torch.eye(q.shape[-1], requires_grad=True)

    def block(q, k, v):
        return torch.tanh(cross_attn.dense_cross_attention(q @ w, k, v, NH, 0.2))

    store = remat.KernelOutputStore()
    out = checkpoint(block, q, k, v, use_reentrant=False, context_fn=store.contexts)
    assert len(store) == 1 and [t.shape for t in store._outputs[0]] == [
        out.shape, (q.shape[0], NH, q.shape[1])]
    grads = torch.autograd.grad(out, (q, k, v, w), do)
    assert calls == [True]                       # the recompute called no forward
    calls.clear()
    plain = torch.autograd.grad(block(q, k, v), (q, k, v, w), do)
    assert calls == [True]
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
