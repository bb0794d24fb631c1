"""``--no-flash_train``: the reference's attention-probability dropout and the
gathered KNN train path, against the JAX package on the CPU.

With ``use_flash_train=False`` the JAX ``MultiHeadCrossAttention`` trains
through its einsum path (``models/bricks/attention.py:72-101``) and the blocks
take the gathered path, whose bfloat16 gather is ``index_points_mxu``
(backward: the K7 scatter, ``_gather_shared``). The port's einsum path is held
to the JAX module in values and ``jax.vjp`` gradients, its gathered bfloat16
block to the JAX block with ``index_points_mxu`` in Pallas interpret mode, its
probability dropout to the Trainer's seed, and the tiny model's no-flash step
at dropout 0 to its flash step (the same function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted, tiny_cfg

from poem_v2_tpu_torch.cli.opt import parse_exp_args
from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
from poem_v2_tpu_torch.models.bricks import point_transformer as tpt
from poem_v2_tpu_torch.models.bricks.attention import MultiHeadCrossAttention
from poem_v2_tpu_torch.models.poem import create_poem_model
from poem_v2_tpu_torch.ops import scatter
from poem_v2_tpu_torch.training.trainer import Trainer


def _jax_value_and_grads(module, variables, args, ct, **kw):
    """(output, d(params), d(args)) of a flax module by jax.vjp with cotangent ct."""
    def f(params, *a):
        return module.apply({"params": params}, *a, **kw)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(f, variables["params"], *[jnp.asarray(a) for a in args])
        grads = vjp(jnp.asarray(ct, out.dtype))
    return np.asarray(out.astype(jnp.float32)), grads[0], [np.asarray(g.astype(jnp.float32))
                                                          for g in grads[1:]]


def _torch_grads(module, args, ct, **kw):
    """(output, {param: grad}, [input grads]) of a port module with cotangent ct."""
    ins = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = module(*ins, **kw)
    out.float().backward(torch.from_numpy(ct).to(out.dtype).float())
    return (out.detach().float().numpy(), {k: p.grad for k, p in module.named_parameters()},
            [t.grad.float().numpy() for t in ins])


def _within(got, want, rel, name="", peak=None):
    peak = float(np.abs(want).max()) if peak is None else peak
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert peak > 0 and err <= rel * peak, f"{name}: {err:.3e} vs peak {peak:.3e}"


def test_einsum_attention_matches_jax_values_and_gradients():
    """The port's training path without the kernel (``use_flash_train=False``,
    train mode, dropout 0) against the JAX module with ``use_flash=False``: output
    and the gradients of every parameter and both inputs, float32, within 1e-5
    of each peak (sums in other orders)."""
    from poem_v2_tpu.models.bricks.attention import MultiHeadCrossAttention as JMHA

    rs = np.random.RandomState(3)
    hidden, kv = rs.randn(2, 50, 32).astype(np.float32), rs.randn(2, 70, 32).astype(np.float32)
    jmod = JMHA(32, 4, dropout=0.0, use_flash=False)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), hidden, kv))
    variables = fill_params(shapes, gain=0.5)
    ct = rs.randn(2, 50, 32).astype(np.float32)
    want, want_p, want_in = _jax_value_and_grads(jmod, variables, (hidden, kv), ct,
                                                 deterministic=False,
                                                 rngs={"dropout": jax.random.PRNGKey(1)})
    mod = MultiHeadCrossAttention(32, 4, dropout=0.0, use_flash_train=False)
    load_converted(mod, variables)
    got, got_p, got_in = _torch_grads(mod.train(), (hidden, kv), ct)
    _within(got, want, 1e-5, "output")
    for g, w, name in zip(got_in, want_in, ("hidden", "kv")):
        _within(g, w, 1e-5, name)
    from poem_v2_tpu_torch.convert import flax_to_state_dict

    want_sd = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want_p)})
    assert set(want_sd) == set(got_p)
    peak = max(float(np.abs(w).max()) for w in want_sd.values())
    for k, w in want_sd.items():
        _within(got_p[k].numpy(), w, 1e-5, k, peak)


def test_einsum_path_runs_only_in_training_without_flash(monkeypatch):
    """Eval keeps the dense attention kernel's function; training takes the
    einsum path only with ``use_flash_train=False`` or a key mask."""
    import poem_v2_tpu_torch.models.bricks.attention as tattn

    calls = []
    real = tattn.dense_cross_attention
    monkeypatch.setattr(tattn, "dense_cross_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.randn(1, 5, 32)
    mod = MultiHeadCrossAttention(32, 4, use_flash_train=False)
    mod.eval()(x, x)
    mod.train()(x, x)
    assert len(calls) == 1
    MultiHeadCrossAttention(32, 4).train()(x, x)
    assert len(calls) == 2
    masked = MultiHeadCrossAttention(32, 4, dropout=0.0).eval()
    keep = torch.tensor([[True, True, False, True, False]])
    got = masked(x, x, kv_mask=keep)
    assert len(calls) == 2  # the mask takes the einsum path
    torch.testing.assert_close(got, masked(x, x[:, [0, 1, 3]]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cross", [False, True])
def test_gathered_bf16_block_matches_jax_gather_shared(monkeypatch, cross):
    """The gathered KNN block in bfloat16 (parameters float32, compute bfloat16:
    autocast here, ``dtype=bfloat16`` in flax), the JAX block gathering through
    ``_gather_shared`` -> ``index_points_mxu`` (its backward the K7 scatter, in
    Pallas interpret mode). Output and the gradient of the gathered features
    (the scatter's output) agree within 3e-2 of each peak: both sides round the
    same intermediates to bfloat16 (2**-8 relative) and sum in other orders. A
    parameter's gradient sums hundreds of bfloat16 products whose signs cancel,
    so each side is held to the float32 JAX block instead: the port's error at
    most twice the JAX package's own plus 1e-3 of the largest gradient. The
    port's backward reaches the scatter of K7 (``scatter_add_rows``) once per
    block call; float32 keeps the plain gather."""
    import poem_v2_tpu.ops.pallas_scatter as ps
    from poem_v2_tpu.models.bricks import point_transformer as jpt
    from poem_v2_tpu_torch.convert import flax_to_state_dict

    jax_calls, calls = [], []
    real_mxu = ps.index_points_mxu

    def mxu(points, idx, interpret=None):  # the blocks call it with two arguments
        if interpret is None:
            jax_calls.append(points.dtype)
        return real_mxu(points, idx, True)

    monkeypatch.setattr(ps, "index_points_mxu", mxu)
    real_scatter = scatter.scatter_add_rows
    monkeypatch.setattr(scatter, "scatter_add_rows",
                        lambda *a: calls.append(a[0].dtype) or real_scatter(*a))
    rs = np.random.RandomState(4)
    B, M, N, D, K = 2, 40, 100, 32, 8
    xyz, feats = rs.randn(B, N, 3).astype(np.float32), rs.randn(B, N, D).astype(np.float32)
    qxyz, qf = rs.randn(B, M, 3).astype(np.float32), rs.randn(B, M, D).astype(np.float32)
    if cross:
        jcls, tmod, args = jpt.PtCrossAttnBlock, tpt.PtCrossAttnBlock(
            D, D, K, use_fused_knn_train=False), (xyz, feats, qxyz, qf)
    else:
        jcls, tmod, args = jpt.PtSelfAttnBlock, tpt.PtSelfAttnBlock(
            D, D, K, use_fused_knn_train=False), (qxyz, qf)
    jmod = jcls(D, D, K, approx_knn=False, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *[jnp.asarray(a) for a in args]))
    variables = fill_params(shapes, gain=0.5)
    ct = rs.randn(B, M, D).astype(np.float32)
    jax_calls.clear()  # the init traced the block once
    want, want_p, want_in = _jax_value_and_grads(jmod, variables, args, ct)
    assert jax_calls == [jnp.bfloat16]
    _, f32_p, _ = _jax_value_and_grads(jcls(D, D, K, approx_knn=False), variables, args, ct)
    load_converted(tmod, variables)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got, got_p, got_in = _torch_grads(tmod.train(), args, ct)
    assert calls == [torch.bfloat16]
    _within(got, want, 3e-2, "output")
    _within(got_in[-1], want_in[-1], 3e-2, "features")
    sd = lambda p: flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, p)})
    want_sd, f32_sd = sd(want_p), sd(f32_p)
    peak = max(float(np.abs(w).max()) for w in f32_sd.values())
    for k, w in f32_sd.items():
        jax_err = float(np.abs(want_sd[k].astype(np.float64) - w).max())
        err = float(np.abs(got_p[k].double().numpy() - w).max())
        assert err <= 2 * jax_err + 1e-3 * peak, f"{k}: {err:.3e} vs JAX bf16 {jax_err:.3e}"
    tmod.zero_grad()
    _torch_grads(tmod, args, ct)  # float32: the plain gather
    assert calls == [torch.bfloat16]


def _model(use_flash_train, dropout):
    cfg = tiny_cfg(norm="frozen_bn")
    cfg.HEAD.TRANSFORMER.DROPOUT = dropout
    model, aux = create_poem_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                                   use_flash_train=use_flash_train)
    return cfg, model, aux


def _batch():
    return SyntheticMultiviewDataset(batch_size=2, view_max=3, view_range=(1, 3), image_size=64,
                                     seed=2).sample_batch()


def _losses(use_flash_train, seed, global_seed, dropout=0.3, steps=2):
    cfg, model, aux = _model(use_flash_train, dropout)
    trainer = Trainer(model, aux, cfg.TRAIN, cfg.LOSS, seed=seed)
    torch.manual_seed(global_seed)
    batch = _batch()
    return [float(trainer.step(batch)["loss"]) for _ in range(steps)]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_probability_dropout_follows_the_trainers_seed(one_thread):
    """At dropout 0.3 the no-flash step drops attention probabilities too: two
    Trainers of one seed read the same losses over two steps whatever the global
    generators hold, another seed reads others, and the flash step of the same
    seed (no probability dropout) reads others again."""
    a, b, c = _losses(False, 1, 11), _losses(False, 1, 22), _losses(False, 2, 11)
    assert a == b
    assert a[0] != c[0] and a[1] != c[1]
    flash = _losses(True, 1, 11)
    assert flash[0] != a[0]


def test_no_flash_step_is_the_flash_step_at_dropout_0(one_thread, monkeypatch):
    """The tiny model's train step with ``use_flash_train=False`` (einsum
    attention, gathered KNN) against the step through K3 and K6 on the same
    weights, batch and seed at dropout 0: the same function in float32, summed
    in other orders, once both select the same neighbours. K6 selects by K1's
    packed keys, which break distance ties within 2**-11 relative by the lowest
    index, where the gathered path sorts exact distances (as the JAX gathered
    path does); here the gathered path is fed K1's selection. Loss terms within
    1e-5 relative, every gradient within 1e-5 of its module's largest."""
    from poem_v2_tpu_torch.ops.knn_attn import knn_select_plain
    from poem_v2_tpu_torch.ops.points import index_points

    def k1_selection(query, points, k):
        idx = knn_select_plain(query, points, k).long()
        return None, idx, index_points(points, idx)

    monkeypatch.setattr(tpt, "knn_points", k1_selection)
    out = {}
    for flash in (True, False):
        cfg, model, aux = _model(flash, 0.0)
        trainer = Trainer(model, aux, cfg.TRAIN, cfg.LOSS, seed=1)
        grads = {}
        step = trainer.optimizer.step

        def keep(grads=grads, model=model, step=step):
            grads.update({k: p.grad.clone() for k, p in model.named_parameters()
                          if p.grad is not None})
            step()

        trainer.optimizer.step = keep
        out[flash] = ({k: float(v) for k, v in trainer.step(_batch()).items()}, grads)
    (want, want_g), (got, got_g) = out[True], out[False]
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
    groups = {}
    for k, w in want_g.items():
        mod = ".".join(k.split(".")[:3]) if k.startswith("head.transformer") else k.split(".")[0]
        err, peak = groups.get(mod, (0.0, 0.0))
        groups[mod] = (max(err, float((got_g[k] - w).abs().max())),
                       max(peak, float(w.abs().max())))
    for mod, (err, peak) in groups.items():
        assert err <= 1e-5 * peak, f"{mod}: {err:.3e} vs {peak:.3e}"


def test_no_flash_train_flag_builds_the_reference_paths():
    """``--no-flash_train`` parses, and the train CLI's model then trains through
    the einsum attention and the gathered KNN blocks."""
    from poem_v2_tpu_torch.cli.train import build_model
    from poem_v2_tpu_torch.utils.config import get_config

    args = parse_exp_args(["-c", "x.yaml", "--no-flash_train", "--device", "cpu",
                           "--dtype", "fp32"])
    assert args.flash_train is False
    cfg = get_config({"MODEL": tiny_cfg(norm="frozen_bn").to_dict()}, arg=args)
    model, _ = build_model(cfg, args)
    attn = [m for m in model.modules() if isinstance(m, MultiHeadCrossAttention)]
    blocks = [m for m in model.modules() if isinstance(m, tpt._VectorAttention)]
    assert attn and not any(m.use_flash_train for m in attn)
    assert blocks and not any(m.use_fused_knn_train for m in blocks)
    assert all(m.use_fused_knn for m in blocks)  # eval keeps K1 / K2
