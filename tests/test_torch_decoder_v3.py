"""PtEmbedTRv2, METROEncoderBlock and PtEmbedTRv3 of the port against the JAX package, on the CPU.

Same numpy inputs, converted weights (``fill_params`` at gain 0.5, as the
other model tests: at unit gain the random Δxyz heads move queries metres off
the cloud, where neighbour distances all but tie), float32, JAX at "highest"
matmul precision. The JAX blocks select neighbours with ``approx_max_k``,
which is exact ``top_k`` on the CPU, by full float32 distances. The port's
blocks run here with ``use_fused_knn=False``, the gathered path, which selects
by the same rule. By default they run K1 (its plain version on the CPU), which
orders by K1's packed keys: distances within 2**-11 relative tie and go to the
lowest index, as the JAX package's own K1 orders them (held against it in
``test_torch_knn_select_shapes.py``); at these random inputs such near-ties
fall at a few queries' K-th neighbour and move those queries by up to ~5e-3
(normalised units).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted

from poem_v2_tpu_torch.models.decoder_v2 import PtEmbedTRv2
from poem_v2_tpu_torch.models.decoder_v3 import PtEmbedTRv3
from poem_v2_tpu_torch.models.metro import METROEncoderBlock

# float32 on both sides, summed in other orders through two blocks: the
# coordinates (normalised units, |x| ~ 1) agree to ~1e-6
ATOL = 2e-5


def _apply_jax(module, variables, *args, **kw):
    with jax.default_matmul_precision("highest"):
        out = module.apply(variables, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                         for a in args), **kw)
    return np.asarray(out)


def _init_jax(module, *args, seed=0, **kw):
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": rng, "dropout": rng},
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw))
    return fill_params(shapes, seed=seed, gain=0.5)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", [
    dict(query_feat=True, pt_embed=False, query_emb=False, inv_sigmoid=False, point_embed=True),
    dict(query_feat=False, pt_embed=False, query_emb=True, inv_sigmoid=True, point_embed=True),
    dict(query_feat=True, pt_embed=True, query_emb=True, inv_sigmoid=False, point_embed=True),
    dict(query_feat=True, pt_embed=True, query_emb=True, inv_sigmoid=True, point_embed=False),
])
def test_pt_embed_trv2_matches_jax(case):
    from poem_v2_tpu.models.decoder_v2 import PtEmbedTRv2 as JaxTRv2

    rs = np.random.RandomState(0)
    B, N, M, F = 2, 96, 40, 32
    pt_xyz = rs.rand(B, N, 3).astype(np.float32)
    feats = lambda n: rs.randn(B, n, F).astype(np.float32)
    pt_feats, query_xyz = feats(N), rs.uniform(0.2, 0.8, (B, M, 3)).astype(np.float32)
    query_feat = feats(M) if case["query_feat"] else None
    pt_embed = feats(N) if case["pt_embed"] else None
    query_emb = feats(M) if case["query_emb"] else None
    kw = dict(n_blocks=2, n_neighbor=8, n_neighbor_query=6, feat_dim=F, transformer_dim=F,
              with_point_embed=case["point_embed"], predict_inv_sigmoid=case["inv_sigmoid"])
    jm = JaxTRv2(**kw)
    args = (pt_xyz, pt_feats, query_xyz, query_feat, pt_embed, query_emb)
    variables = _init_jax(jm, *args)
    want = _apply_jax(jm, variables, *args)
    tm = PtEmbedTRv2(**kw, use_fused_knn=False).eval()
    load_converted(tm, variables)
    with torch.no_grad():
        got = tm(*_torch(*args)).numpy()
    assert got.shape == want.shape == (2, B, M, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if case["inv_sigmoid"]:
        assert (got > 0).all() and (got < 1).all()


def test_pt_embed_trv2_from_config():
    cfg = {"N_BLOCKS": 3, "N_NEIGHBOR": 16, "N_NEIGHBOR_QUERY": 8, "POINTS_FEAT_DIM": 64,
           "TRANSFORMER_DIM": 64, "PREDICT_INV_SIGMOID": True}
    m = PtEmbedTRv2.from_config(cfg)
    assert m.n_blocks == 3 and m.predict_inv_sigmoid and m.with_point_embed
    assert m.feats_self_attn.k == 16 and m.query_self_attn_2.k == 8 and m.query_cross_attn_0.k == 16


@pytest.mark.parametrize("train", [False, True])
def test_metro_encoder_block_matches_jax(train):
    """Eval, and training with dropout 0 (the einsum attention path both sides
    train through)."""
    from poem_v2_tpu.models.metro import METROEncoderBlock as JaxBlock

    rs = np.random.RandomState(1)
    tokens = rs.randn(2, 30, 11).astype(np.float32)
    kw = dict(hidden_size=32, output_dim=8, num_layers=2, num_heads=4, dropout=0.0,
              max_positions=40)
    jm = JaxBlock(**kw)
    variables = _init_jax(jm, tokens)
    want = _apply_jax(jm, variables, tokens, deterministic=not train,
                      rngs={"dropout": jax.random.PRNGKey(3)})
    tm = METROEncoderBlock(11, **kw).train(train)
    load_converted(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (2, 30, 8)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pt_embed_trv3_matches_jax():
    """tests/test_baselines.py's sizes: 128 cloud points of width 32, 799 queries,
    two views of 8 x 8 maps, METRO hidden (64, 32) with outputs (32, 3), one
    layer each, one refinement block, K 8; one of two views masked in sample 1."""
    from poem_v2_tpu.models.decoder_v3 import PtEmbedTRv3 as JaxTRv3

    rs = np.random.RandomState(2)
    B, V, H, W, F, N, Q = 2, 2, 8, 8, 32, 128, 799
    x = rs.randn(N * B, 3)
    pt_xyz = (x / np.linalg.norm(x, axis=1, keepdims=True) * rs.rand(N * B, 1) ** (1 / 3))
    args = (pt_xyz.reshape(B, N, 3).astype(np.float32), rs.randn(B, N, F).astype(np.float32),
            (rs.randn(B, Q, 3) * 0.5).astype(np.float32), rs.randn(B, Q, F).astype(np.float32),
            rs.randn(B, V, H, W, F).astype(np.float32), np.array([[True, True], [True, False]]),
            np.broadcast_to(np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32),
                            (B, V, 3, 3)).copy(),
            np.broadcast_to(np.eye(4, dtype=np.float32), (B, V, 4, 4)).copy(),
            np.array([[0, 0, 0.6], [0.01, -0.02, 0.55]], np.float32))
    kw = dict(feat_dim=F, vt_hidden_dims=(64, 32), vt_output_dims=(32, 3), vt_num_layers=1,
              pt_n_blocks=1, pt_n_neighbor=8, pt_n_neighbor_query=8)
    jm = JaxTRv3(**kw)
    variables = _init_jax(jm, *args, 0.1, inp_res=(64, 64))
    want = _apply_jax(jm, variables, *args, 0.1, inp_res=(64, 64))
    tm = PtEmbedTRv3(**kw, max_positions=Q + N, use_fused_knn=False).eval()
    load_converted(tm, variables)
    assert tm.metro_block_0.position_embeddings.shape == (Q + N, 64)
    with torch.no_grad():
        got = tm(*_torch(*args), 0.1, inp_res=(64, 64)).numpy()
    assert got.shape == want.shape == (2, B, Q, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
