"""The port's operation-order transformer kit against the JAX package's, on the CPU.

Same numpy inputs and flax parameters (``fill_params``, converted by
``convert.py``) through both, TF32 off, JAX at "highest" matmul precision:
``MultiheadAttention`` with and without a key mask, ``BaseTransformerLayer``
under the post-norm and the pre-norm order with a key mask (one sample's
last third of keys masked), ``TransformerLayerSequence``; eval, and training
mode at dropout 0. Tolerance 1e-5 absolute on outputs of order 1 (float32
sums in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted, one_thread_no_tf32

from poem_v2_tpu_torch.models.bricks import transformer_layer as tl
from poem_v2_tpu_torch.utils.registry import ATTENTION, TRANSFORMER

ATOL = 1e-5
E, NH, FF = 32, 4, 64
POST = ("self_attn", "norm", "cross_attn", "norm", "ffn", "norm")
PRE = ("norm", "self_attn", "norm", "cross_attn", "norm", "ffn")


@pytest.fixture(autouse=True)
def cpu_settings():
    with one_thread_no_tf32():
        yield


def _inputs(seed=0, B=2, Q=7, N=12):
    rs = np.random.RandomState(seed)
    query = rs.randn(B, Q, E).astype(np.float32)
    memory = rs.randn(B, N, E).astype(np.float32)
    query_pos = rs.randn(B, Q, E).astype(np.float32)
    memory_pos = rs.randn(B, N, E).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 2 * N // 3:] = False
    return query, memory, query_pos, memory_pos, mask


def _pair(jmod, tmod, args, train=False, **apply_kw):
    """(JAX output, port output) with the same filled parameters."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmod.init(rng, *jargs, **apply_kw))
    variables = fill_params(shapes, gain=0.5)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmod.apply(variables, *jargs, **apply_kw))
    load_converted(tmod, variables)
    tmod.train(train)
    with torch.no_grad():
        got = tmod(*(None if a is None else torch.from_numpy(a) for a in args)).numpy()
    return want, got


@pytest.mark.parametrize("masked", [False, True])
def test_multihead_attention_matches_jax(masked):
    from poem_v2_tpu.models.bricks.transformer_layer import MultiheadAttention as J

    query, memory, query_pos, memory_pos, mask = _inputs()
    args = (query, memory, memory, query_pos, memory_pos, mask if masked else None)
    want, got = _pair(J(E, NH, 0.1), tl.MultiheadAttention(E, NH, 0.1), args)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("order", [POST, PRE], ids=["post_norm", "pre_norm"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_dropout0"])
def test_base_transformer_layer_matches_jax(order, train):
    """Post-norm and pre-norm orders with a key mask; in training mode at dropout 0
    the port's dropouts are identities, as JAX's deterministic ones."""
    from poem_v2_tpu.models.bricks.transformer_layer import BaseTransformerLayer as J

    query, memory, query_pos, memory_pos, mask = _inputs(1)
    dropout = 0.0 if train else 0.1
    jmod = J(E, NH, FF, dropout, order)
    tmod = tl.BaseTransformerLayer(E, NH, FF, dropout, order)
    want, got = _pair(jmod, tmod, (query, memory, query_pos, memory_pos, mask), train=train)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert [n for n, _ in tmod.named_children()] == (
        ["attn_0", "norm_0", "attn_1", "norm_1", "ffn_0", "norm_2"] if order == POST
        else ["norm_0", "attn_0", "norm_1", "attn_1", "norm_2", "ffn_0"])
    assert all(m.eps == 1e-6 for m in tmod.modules() if isinstance(m, torch.nn.LayerNorm))


def test_masked_keys_do_not_reach_the_output():
    """Keys the mask drops (values and positions changed) leave the output as it was."""
    query, memory, query_pos, memory_pos, mask = _inputs(2)
    torch.manual_seed(0)
    layer = tl.BaseTransformerLayer(E, NH, FF, 0.1, POST).eval()
    t = lambda a: torch.from_numpy(a)
    with torch.no_grad():
        base = layer(t(query), t(memory), t(query_pos), t(memory_pos), t(mask))
        memory2, pos2 = memory.copy(), memory_pos.copy()
        memory2[~mask] += 5.0
        pos2[~mask] -= 3.0
        moved = layer(t(query), t(memory2), t(query_pos), t(pos2), t(mask))
    assert torch.equal(base[0], moved[0])  # sample 0 masks nothing: the same bits
    np.testing.assert_allclose(moved[1].numpy(), base[1].numpy(), atol=1e-6, rtol=0)


def test_layer_sequence_matches_jax():
    """Two layers with every intermediate returned, (L, B, Q, C)."""
    from poem_v2_tpu.models.bricks.transformer_layer import TransformerLayerSequence as J

    query, memory, query_pos, memory_pos, mask = _inputs(3)
    jmod = J(num_layers=2, embed_dims=E, num_heads=NH, feedforward_channels=FF)
    tmod = tl.TransformerLayerSequence(2, E, NH, FF)
    want, got = _pair(jmod, tmod, (query, memory, query_pos, memory_pos, mask))
    assert got.shape == want.shape == (2, 2, 7, E)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bf16_autocast_keeps_float32_logits():
    """Under bfloat16 autocast the softmax takes float32 logits and the output is
    within 5% of the float32 output's peak."""
    query, memory, query_pos, memory_pos, mask = _inputs(4)
    torch.manual_seed(0)
    attn = tl.MultiheadAttention(E, NH, 0.0).eval()
    t = lambda a: torch.from_numpy(a)
    seen = {}
    real_softmax = torch.softmax

    def spy(x, dim):
        seen["dtype"] = x.dtype
        return real_softmax(x, dim=dim)

    with torch.no_grad():
        ref = attn(t(query), t(memory), t(memory), t(query_pos), t(memory_pos), t(mask))
        torch.softmax = spy
        try:
            with torch.autocast("cpu", dtype=torch.bfloat16):
                low = attn(t(query), t(memory), t(memory), t(query_pos), t(memory_pos), t(mask))
        finally:
            torch.softmax = real_softmax
    assert seen["dtype"] == torch.float32 and low.dtype == torch.bfloat16
    np.testing.assert_allclose(low.float().numpy(), ref.numpy(),
                               atol=0.05 * ref.abs().max().item())


def test_registries_and_unknown_operation():
    assert ATTENTION.get("MultiheadAttention") is tl.MultiheadAttention
    assert TRANSFORMER.get("BaseTransformerLayer") is tl.BaseTransformerLayer
    assert TRANSFORMER.get("TransformerLayerSequence") is tl.TransformerLayerSequence
    with pytest.raises(ValueError, match="Unknown operation"):
        tl.BaseTransformerLayer(E, NH, FF, 0.1, ("self_attn", "mlp"))
    layer = tl.BaseTransformerLayer(E, NH, FF, 0.1, POST)
    with pytest.raises(ValueError, match="no memory"):
        layer(torch.zeros(1, 2, E))
