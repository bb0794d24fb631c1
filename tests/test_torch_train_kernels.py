"""The port's training-path ops against the JAX package's, on the CPU.

K3b (the dense attention backward), K6 (trainable KNN vector attention)
and K7 (the deterministic scatter-add) run here as their plain PyTorch
versions, through the same autograd Functions the card uses; the JAX side
runs its Pallas kernels with ``interpret=True``. Inputs are numpy arrays
from a seed, float32 on both sides. Limits: max abs error <= 1e-5 x
max|JAX| per output, both sides summing in float32 in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.models import decoder
from poem_v2_tpu_torch.models.decoder import PtEmbedDecoder
from poem_v2_tpu_torch.ops import cross_attn, knn_attn, remat, sampling, scatter, vector_attn

REL = 1e-5


def _close(got, want, rel=REL, scale=None, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    lim = rel * (float(np.abs(want).max()) if scale is None else scale)
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{msg}: max abs err {err:.3e} > {lim:.3e}"


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("hd,N", [(32, 150), (64, 150), (64, 300)])
def test_dense_attention_backward_matches_jax(hd, N):
    """K3b: gradients of the port's Function (plain backward) against jax.vjp of
    ``dense_cross_attention(interpret=True)``; N is no multiple of 128, so the
    TPU kernel's padded-key masking is exercised."""
    from poem_v2_tpu.ops.pallas_cross_attn import dense_cross_attention as jdense

    rs = np.random.RandomState(hd + N)
    B, M, nh = 2, 67, 4
    H = nh * hd
    q, k, v, do = (rs.randn(B, n, H).astype(np.float32) for n in (M, N, N, M))
    scale = hd ** -0.5
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(lambda a, b, c: jdense(a, b, c, num_heads=nh, sm_scale=scale,
                                                    interpret=True), q, k, v)
        grads_j = vjp(jnp.asarray(do))
    qt, kt, vt = (_t(a, True) for a in (q, k, v))
    out = cross_attn.dense_cross_attention(qt, kt, vt, nh, scale)
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    _close(out, out_j, msg="out")
    for name, g, gj in zip("qkv", grads, grads_j):
        _close(g, gj, msg=f"d{name}")


def _knn_inputs(rs, B, M, N, D):
    mk = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    return [mk(B, M, D), mk(B, M, 3), mk(B, N, 3), mk(B, N, D), mk(D, D) / 8, mk(D, D) / 8,
            mk(3, D), mk(D), mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D), mk(D, D) / 8, mk(D)]


@pytest.mark.parametrize("self_attn", [False, True])
def test_knn_trainable_value_and_grads_match_jax(self_attn):
    """K6: value and the gradients of all 14 inputs (q, both xyz, the cloud
    features, wk, wv and both MLPs) against knn_vector_attention_trainable
    with the Pallas forward in interpret mode. fc_gamma's output bias moves
    every neighbour of a channel alike, so its exact gradient is 0 and both
    sides hold float32 noise: it is held to the scale of g1's gradient."""
    import poem_v2_tpu.ops.pallas_knn_attn as pk

    rs = np.random.RandomState(11 + self_attn)
    B, M, N, D, K = 2, 35, 96, 32, 8
    a = _knn_inputs(rs, B, M, N if not self_attn else M, D)
    if self_attn:
        a[2], a[3] = a[1], rs.randn(B, M, D).astype(np.float32)
    ct = rs.randn(B, M, D).astype(np.float32)

    def jloss(q, qx, px, xf, wk, wv, fcd, fcg):
        out = pk.knn_vector_attention_trainable(q, qx, px, xf, wk, wv, fcd, fcg, K, 16, 4, True)
        return jnp.sum(out * ct), out

    ja = [jnp.asarray(x) for x in a]
    with jax.default_matmul_precision("highest"):
        (val_j, out_j), g_j = jax.value_and_grad(jloss, argnums=range(8), has_aux=True)(
            *ja[:6], tuple(ja[6:10]), tuple(ja[10:]))
    g_j = jax.tree_util.tree_leaves(g_j)

    ts = [_t(x, True) for x in a]
    out = knn_attn.knn_vector_attention_trainable(*ts[:6], ts[6:10], ts[10:], n_neighbor=K)
    grads = torch.autograd.grad((out * _t(ct)).sum(), ts)
    _close(out, out_j, msg="out")
    for i, (g, gj) in enumerate(zip(grads, g_j)):
        scale = float(np.abs(np.asarray(g_j[12 if i == 13 else i])).max())
        _close(g, gj, scale=scale, msg=f"grad {i}")


def test_scatter_add_rows_matches_jax():
    """K7's plain version against the TPU kernel in interpret mode, with
    duplicated indices (200 rows, 720 entries per batch element)."""
    from poem_v2_tpu.ops.pallas_scatter import scatter_add_rows as jscatter

    rs = np.random.RandomState(0)
    B, M, K, D, N = 2, 45, 8, 128, 200
    grads = rs.randn(B, M, K, D).astype(np.float32)
    idx = rs.randint(0, N, size=(B, M, K)).astype(np.int32)
    want = jscatter(jnp.asarray(grads), jnp.asarray(idx), N, chunk_m=16, interpret=True)
    _close(scatter.scatter_add_rows(_t(grads), _t(idx), N), want)


def test_index_points_mxu_grads_match_jax():
    """The gather whose backward is K7: forward and gradient against JAX's."""
    from poem_v2_tpu.ops.pallas_scatter import index_points_mxu as jipm

    rs = np.random.RandomState(1)
    B, N, D, M, K = 2, 96, 128, 35, 8
    pts = rs.randn(B, N, D).astype(np.float32)
    idx = rs.randint(0, N, size=(B, M, K)).astype(np.int32)
    ct = rs.randn(B, M, K, D).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p: jipm(p, jnp.asarray(idx), True), jnp.asarray(pts))
    (g_j,) = vjp(jnp.asarray(ct))
    pt = _t(pts, True)
    out = scatter.index_points_mxu(pt, _t(idx))
    (g,) = torch.autograd.grad(out, pt, _t(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    _close(g, g_j)


def test_vector_attention_reference_matches_jax():
    """The training math of the anchor path, value and input gradients."""
    from poem_v2_tpu.ops.pallas_vector_attn import vector_attention_reference as jref

    rs = np.random.RandomState(2)
    B, M, K, D = 2, 20, 8, 32
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    a = [mk(B, M, D), mk(B, M, K, D), mk(B, M, K, D), mk(B, M, K, 3),
         mk(3, D), mk(D), mk(D, D) / 6, mk(D), mk(D, D) / 6, mk(D), mk(D, D) / 6, mk(D)]
    ct = mk(B, M, D)
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(lambda *x: jref(*x[:4], x[4:8], x[8:]), *map(jnp.asarray, a))
        g_j = vjp(jnp.asarray(ct))
    ts = [_t(x, True) for x in a]
    out = vector_attn.vector_attention_reference(*ts[:4], ts[4:8], ts[8:])
    grads = torch.autograd.grad(out, ts, _t(ct))
    _close(out, out_j, msg="out")
    for i, (g, gj) in enumerate(zip(grads, g_j)):
        scale = float(np.abs(np.asarray(g_j[10 if i == 11 else i])).max())
        _close(g, gj, scale=scale, msg=f"grad {i}")


def test_train_sampler_matches_jax():
    """grid_sample_points_matmul: value and the gradient in the features,
    with points inside, on and outside the map's border."""
    from poem_v2_tpu.ops.sampling import grid_sample_points_matmul as jsample

    rs = np.random.RandomState(3)
    feat = rs.randn(3, 8, 8, 16).astype(np.float32)
    coords = rs.uniform(-1.3, 1.3, (3, 50, 2)).astype(np.float32)
    coords[:, :3] = [[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0]]
    ct = rs.randn(3, 50, 16).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(lambda f: jsample(f, jnp.asarray(coords)), jnp.asarray(feat))
        (g_j,) = vjp(jnp.asarray(ct))
    ft = _t(feat, True)
    out = sampling.grid_sample_points_matmul(ft, _t(coords))
    (g,) = torch.autograd.grad(out, ft, _t(ct))
    _close(out, out_j, msg="out")
    _close(g, g_j, msg="dfeat")


def test_remat_keeps_kernel_outputs_out_of_the_recompute(monkeypatch):
    """With remat the decoder's backward recomputes each block but not its
    kernels: the dense attention and K6 forwards run once per call, as
    without remat (``checkpoint`` replaced by a plain call), and the
    gradients are the same bits."""
    calls = {"dense": 0, "knn": 0}
    dense_fwd, knn_fwd = cross_attn.dense_cross_attention_forward, knn_attn.fused_knn_vector_attention

    def count(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(cross_attn, "dense_cross_attention_forward", count("dense", dense_fwd))
    monkeypatch.setattr(knn_attn, "fused_knn_vector_attention", count("knn", knn_fwd))
    rs = np.random.RandomState(4)
    B, M, N, D = 1, 24, 48, 32
    args = [_t(rs.randn(B, M, 3).astype(np.float32) * 0.3),
            _t(rs.randn(B, M, D).astype(np.float32)),
            _t(rs.randn(B, N, 3).astype(np.float32) * 0.3),
            _t(rs.randn(B, N, D).astype(np.float32))]
    aidx = torch.arange(4)
    results = {}
    for use_remat in (True, False):
        if not use_remat:
            monkeypatch.setattr(decoder, "checkpoint", lambda fn, *a, **kw: fn(*a))
        torch.manual_seed(0)
        dec = PtEmbedDecoder(n_blocks=3, hidden_size=D, num_heads=4, n_neighbor=4,
                             n_neighbor_query=4, dropout=0.1)
        torch.manual_seed(1)
        calls.update(dense=0, knn=0)
        dec.train()
        coords, _, _ = dec(*args, aidx, aidx, None)
        # the last block's FFN feeds no coordinate: its parameters get None
        grads = torch.autograd.grad((coords ** 2).sum(), list(dec.parameters()),
                                    allow_unused=True)
        results[use_remat] = (dict(calls), grads)
    # 3 blocks x 2 attentions; blocks 1 and 2 x (self, cross) KNN attentions
    assert results[True][0] == results[False][0] == {"dense": 6, "knn": 4}
    for a, b in zip(results[True][1], results[False][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_kernel_output_store_refuses_an_unrecorded_replay():
    store = remat.KernelOutputStore()
    _, replay = store.contexts()
    with replay, pytest.raises(RuntimeError, match="more kernel outputs"):
        remat.kernel_outputs(lambda: (torch.zeros(1),))


def test_train_mode_dropout_sites_match_jax():
    """A decoder block in training drops at the JAX block's sites, in the same
    order and on the same shapes: the shared embedding of queries and of the
    cloud, each attention's output projection and the FFN output; never the
    attention probabilities (the ``use_flash_train`` path, deviation #4)."""
    import flax.linen as fnn

    from poem_v2_tpu.models.decoder import PointMetroBlock as JBlock
    from poem_v2_tpu_torch.models.decoder import PointMetroBlock
    from torch_port_helpers import fill_params, pallas_interpret

    rs = np.random.RandomState(5)
    B, M, N, D = 1, 24, 48, 32
    a = [rs.randn(B, M, 3).astype(np.float32) * 0.3, rs.randn(B, M, D).astype(np.float32),
         rs.randn(B, N, 3).astype(np.float32) * 0.3, rs.randn(B, N, D).astype(np.float32)]
    jblock = JBlock(hidden_size=D, num_heads=4, dropout=0.1, n_neighbor=4, n_neighbor_query=4,
                    deterministic=False, use_fused_knn_train=True, use_flash=True,
                    use_flash_train=True)
    ja = [jnp.asarray(x) for x in a]
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    variables = fill_params(jax.eval_shape(lambda: jblock.init(rngs, *ja)), gain=0.5)
    sites = []

    def spy(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__" \
                and not mod.deterministic and mod.rate > 0:
            sites.append(("/".join(mod.path), tuple(args[0].shape)))
        return next_fun(*args, **kwargs)

    with pallas_interpret(), fnn.intercept_methods(spy):
        jblock.apply(variables, *ja, rngs={"dropout": jax.random.PRNGKey(1)})
    jax_sites = [({"Dropout_0": "drop"}.get(p, p.replace("/Dropout_0", ".drop")), s)
                 for p, s in sites]

    block = PointMetroBlock(D, 4, 4, 4, init_block=False, dropout=0.1).train()
    port_sites = []
    for name, mod in block.named_modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.register_forward_hook(
                lambda m, inp, out, name=name: port_sites.append((name, tuple(inp[0].shape))))
    block(*(_t(x) for x in a))
    assert port_sites == jax_sites == [
        ("drop", (B, M, D)), ("drop", (B, N, D)), ("attn.drop", (B, M, D)),
        ("cross_attn.drop", (B, M, D)), ("ffn.drop", (B, M, D))]
