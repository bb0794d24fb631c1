"""Mixed-view serving at every released tier: the port against the JAX package on the CPU.

Configs and weight conversion at the five release configurations; the
scramble (K5) and gathered vector attention (K8) plain versions against the
Pallas kernels in interpret mode; the ``use_fused`` blocks; K1 / K2 at
D = 512 and 1024; the 6D rotation chain; and a tiny parametric (MANO) model on a
mixed-view batch. JAX runs at "highest" matmul precision (the CPU backend's
default float32 product rounds its operands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (fill_params, flax_model_shapes, load_converted, look_at_cameras,
                                pallas_interpret, tiny_cfg, zeros_like_shapes)

from poem_v2_tpu_torch import configs
from poem_v2_tpu_torch.geometry import rotations as trot
from poem_v2_tpu_torch.models.bricks.point_transformer import PtCrossAttnBlock, PtSelfAttnBlock
from poem_v2_tpu_torch.models.decoder import PointerLayer
from poem_v2_tpu_torch.models.heads.ptemb_head import scramble_views
from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create
from poem_v2_tpu_torch.ops import knn_attn, scramble, vector_attn
from poem_v2_tpu_torch.serving.predictor import Predictor

TIERS = ["small", "medium_MANO", "large", "huge"]  # medium: test_torch_modules / _convert


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---- configs and conversion -------------------------------------------------

@pytest.mark.parametrize("name", TIERS)
def test_tier_config_matches_release_yaml(name):
    import yaml

    with open(f"configs/release/train_{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    assert configs.RELEASE[name] == {k: cfg[k] for k in ("TRAIN", "MODEL", "DATA_PRESET")}


def test_release_table_names_the_five_configs():
    assert configs.RELEASE == {"small": configs.SMALL, "medium": configs.MEDIUM,
                               "medium_MANO": configs.MEDIUM_MANO, "large": configs.LARGE,
                               "huge": configs.HUGE}
    assert configs.MEDIUM["MODEL"]["HEAD"]["EMBED_DIMS"] == 256  # deriving copies, never edits


@pytest.mark.parametrize("name", TIERS)
def test_tier_tree_maps_one_to_one(name):
    """Every flax leaf and every torch key is matched once, with equal shapes,
    and ``Predictor.from_config`` builds the tier."""
    from poem_v2_tpu.utils.config import Config
    from poem_v2_tpu_torch.convert import flax_to_state_dict

    cfg = configs.RELEASE[name]
    shapes = flax_model_shapes(Config(cfg["MODEL"]), 64)
    sd = flax_to_state_dict(zeros_like_shapes(shapes))
    pred = Predictor.from_config(cfg, dtype=torch.float32, device="cpu")
    tsd = pred.model.state_dict()
    assert len(sd) == len(jax.tree_util.tree_leaves(shapes))
    assert set(sd) == set(tsd), (sorted(set(sd) - set(tsd))[:5], sorted(set(tsd) - set(sd))[:5])
    for k, v in sd.items():
        assert tuple(tsd[k].shape) == v.shape, k
    width = cfg["MODEL"]["HEAD"]["EMBED_DIMS"]
    assert tsd["head.query_feat_embedding"].shape == (799, width)
    parametric = cfg["MODEL"]["HEAD"]["TRANSFORMER"]["PARAMETRIC_OUTPUT"]
    assert ("head.transformer.block_2.flat_verts.weight" in tsd) == parametric
    if parametric:
        assert tsd["head.transformer.block_2.flat_verts.weight"].shape == (1, 799)
        assert tsd["head.transformer.block_2.mano_linear.weight"].shape == (106, width)


def test_create_poem_model_targets_the_card():
    """Without a device the model goes to the card, and there is no silent move
    to the CPU: where there is no card, building raises."""
    cfg = tiny_cfg()
    if torch.cuda.is_available():
        model, _ = torch_create(cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            torch_create(cfg)
    model, _ = torch_create(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("cfg_change", [{"TYPE": "PtEmbedTRv3"}, {"PETR": True},
                                        {"BACKBONE": "resnet18"}])
def test_head_variants_and_resnet_build(cfg_change):
    """The PtEmbedTRv3 decoder, the PETR embedding and the ResNet backbones build
    (tests/test_torch_poem_variants.py and tests/test_torch_resnet.py hold them
    against JAX)."""
    cfg = tiny_cfg()
    if "TYPE" in cfg_change:
        cfg.HEAD.TRANSFORMER.TYPE = cfg_change["TYPE"]
        model, _ = torch_create(cfg, device="cpu")
        assert type(model.head.transformer).__name__ == "PtEmbedTRv3"
        assert model.head.transformer.point_transformer.n_blocks == 2
    elif "PETR" in cfg_change:
        cfg.HEAD.PETR_EMBEDDING = True
        model, _ = torch_create(cfg, device="cpu")
        assert type(model.head.position_encoder).__name__ == "FrustumPositionEncoder"
        assert type(model.head.transformer).__name__ == "PtEmbedDecoder"
    else:
        cfg.BACKBONE.TYPE = cfg_change["BACKBONE"]
        model, _ = torch_create(cfg, device="cpu")
        assert type(model.backbone).__name__ == "ResNet" and model.backbone.arch == "resnet18"


# ---- K5: the scramble ---------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(V=4, NS=32, C=8, G=8, n_val=[4, 2, 1]),         # tests/test_pallas_kernels.py:478
    dict(V=4, NS=128, C=128, G=64, n_val=[1, 3, 4, 2]),  # a C the TPU kernel's gate takes
    dict(V=8, NS=64, C=128, G=8, n_val=[8, 1, 5, 7]),
])
def test_scramble_matches_pallas_kernel(case):
    """A copy: exact equality on the live rows j < n_b (the Pallas kernel's
    out-of-span rows alias by another rule than the clamp)."""
    from poem_v2_tpu.ops.pallas_scramble import scrambled_merge_gather as jax_scramble

    V, NS, C, G, n_val = (case[k] for k in ("V", "NS", "C", "G", "n_val"))
    B = len(n_val)
    flat = np.random.RandomState(4).randn(B, V * NS * C).astype(np.float32)
    want = np.asarray(jax_scramble(jnp.asarray(flat), jnp.asarray(n_val, jnp.int32), V=V, C=C,
                                   G=G, interpret=True)).reshape(B, NS, V, C)
    got = scramble.scrambled_merge_gather(torch.from_numpy(flat), torch.tensor(n_val), V, C)
    assert got.shape == (B, NS, V, C)
    for b, n in enumerate(n_val):
        np.testing.assert_array_equal(got[b, :, :n].numpy(), want[b, :, :n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scramble_matches_the_row_gather_on_all_rows(dtype):
    """Against the gather written out from the index formula, on every row
    (the aliased and the clamped ones too), and through the head's
    ``scramble_views``, whose uniform batch is the plain reshape."""
    rs = np.random.RandomState(5)
    B, V, NS, C = 4, 8, 16, 8
    a = torch.from_numpy(rs.randn(B, V, C, NS).astype(np.float32)).to(dtype)
    n_val = torch.tensor([8, 1, 3, 6])
    rows = a.reshape(B, V * NS, C)
    want = torch.empty(B, NS, V, C, dtype=dtype)
    for b in range(B):
        for i in range(NS):
            for j in range(V):
                want[b, i, j] = rows[b, min(i * int(n_val[b]) + j, V * NS - 1)]
    for fused in (False, True):
        assert torch.equal(scramble_views(a, n_val, fused=fused), want)
    assert torch.equal(scramble.scrambled_merge_gather(a.reshape(B, -1), n_val, V, C), want)
    full = torch.full((B,), V)
    assert torch.equal(scramble_views(a, full, fused=True), a.reshape(B, NS, V, C))
    assert torch.equal(scramble.plain_scrambled_merge_gather(a.reshape(B, -1), full, V, C),
                       a.reshape(B, NS, V, C))


def test_scramble_rejects_wrong_shapes():
    flat = torch.zeros(2, 4 * 16 * 8)
    with pytest.raises(ValueError, match="n_val"):
        scramble.scrambled_merge_gather(flat, torch.tensor([1, 2, 3]), 4, 8)
    with pytest.raises(ValueError, match="V \\* NS \\* C"):
        scramble.scrambled_merge_gather(flat, torch.tensor([1, 2]), 4, 7)


# ---- K8: vector attention on gathered neighbours -----------------------------

def _gathered_case(rs, B, M, K, D):
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    mkw = lambda i, o: (rs.randn(i, o) / np.sqrt(i)).astype(np.float32)
    args = (mk(B, M, D), mk(B, M, K, D), mk(B, M, K, D), mk(B, M, K, 3) * 0.1)
    fcd = (mkw(3, D), mk(D) * 0.1, mkw(D, D), mk(D) * 0.1)
    fcg = (mkw(D, D), mk(D) * 0.1, mkw(D, D), mk(D) * 0.1)
    return args, fcd, fcg


@pytest.fixture(scope="module")
def jax_gathered_attention():
    """(inputs, JAX K8 in interpret mode) at the shapes of tests/test_pallas_kernels.py:16."""
    from poem_v2_tpu.ops.pallas_vector_attn import fused_vector_attention as jax_fused

    args, fcd, fcg = _gathered_case(np.random.RandomState(0), 2, 100, 8, 64)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_fused(*map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)),
                                    tuple(map(jnp.asarray, fcg)), block_q=32, interpret=True))
    return args, fcd, fcg, want


@pytest.mark.parametrize("which", ["fused_vector_attention", "vector_attention_reference"])
def test_gathered_vector_attention_matches_pallas(jax_gathered_attention, which):
    """The wrapper's plain version (the kernels' roundings) and the training
    reference, float32: 1e-5 of the output's largest value."""
    args, fcd, fcg, want = jax_gathered_attention
    got = getattr(vector_attn, which)(*_t(*args), _t(*fcd), _t(*fcg))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_gathered_vector_attention_bf16_rounds_like_the_kernel():
    """bfloat16: operands of the four products rounded, the rest float32. The
    plain version against the same arithmetic in float64 on rounded operands."""
    args, fcd, fcg = _gathered_case(np.random.RandomState(1), 1, 20, 8, 32)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    q, k, v, delta = map(bf, args)
    got = vector_attn.fused_vector_attention(q, k, v, delta, [bf(a) for a in fcd],
                                             [bf(a) for a in fcg])
    assert got.dtype == torch.bfloat16
    r = lambda t: t.bfloat16().double()
    w1, b1, w2, b2 = (bf(a).double() for a in fcd)
    g0, c0, g1, c1 = (bf(a).double() for a in fcg)
    pos = r(torch.relu(delta.double() @ w1 + b1)) @ w2 + b2
    x = q.double()[:, :, None] - k.double() + pos
    g = (r(torch.relu(r(x) @ g0 + c0)) @ g1 + c1) / np.sqrt(32)
    want = (torch.softmax(g, -2) * (v.double() + pos)).sum(-2)
    # one bfloat16 rounding of the output (2**-8 relative) plus float32 sums
    assert float((got.double() - want).abs().max()) <= 2 ** -7 * float(want.abs().max())


# ---- the use_fused blocks ------------------------------------------------------

def _interp_fused(jpt):
    """The JAX blocks' K8 in interpret mode (they bind it at import)."""
    from poem_v2_tpu.ops.pallas_vector_attn import fused_vector_attention as jax_fused

    return lambda *a, **kw: jax_fused(*a, **kw, interpret=True)


def _jax_run(module, *args, **kw):
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *jargs, **kw))
    variables = fill_params(shapes, gain=0.5)
    with pallas_interpret(exact_sampler=True), jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *jargs)
    return variables, jax.tree_util.tree_map(np.asarray, out)


def _torch_run(module, variables, *args, **kw):
    load_converted(module, variables)
    module.eval()
    targs = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a for a in args]
    with torch.no_grad():
        return module(*targs, **kw)


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("anchors", [False, True])
def test_point_transformer_blocks_gathered_path(monkeypatch, anchors, use_fused):
    """PtSelf / PtCrossAttnBlock(use_fused_knn=False): exact knn_points, one
    gather, projections on the gathered tensor, K8 or the reference; float32
    sums in other orders through four products: 1e-4."""
    from poem_v2_tpu.models.bricks import point_transformer as jpt

    monkeypatch.setattr(jpt, "fused_vector_attention", _interp_fused(jpt))
    rs = np.random.RandomState(4)
    B, M, N, D, K, A = 2, 40, 100, 32, 8, 8
    xyz, feats = rs.randn(B, N, 3).astype(np.float32), rs.randn(B, N, D).astype(np.float32)
    qxyz, qf = rs.randn(B, M, 3).astype(np.float32), rs.randn(B, M, D).astype(np.float32)
    jkw, tkw = {}, {}
    if anchors:
        idx = np.sort(rs.choice(M, A, replace=False))
        a_xyz = rs.randn(A, 3).astype(np.float32)
        jkw = dict(anchor_idx=jnp.asarray(idx, jnp.int32), anchor_xyz=jnp.asarray(a_xyz))
        tkw = dict(anchor_idx=torch.from_numpy(idx), anchor_xyz=torch.from_numpy(a_xyz))
    flags = dict(use_fused=use_fused, use_fused_knn=False)
    variables, want = _jax_run(jpt.PtCrossAttnBlock(D, D, K, approx_knn=False, **flags),
                               xyz, feats, qxyz, qf, **jkw)
    got = _torch_run(PtCrossAttnBlock(D, D, K, **flags), variables, xyz, feats, qxyz, qf, **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    variables, want = _jax_run(jpt.PtSelfAttnBlock(D, D, K, approx_knn=False, **flags),
                               qxyz, qf, **jkw)
    got = _torch_run(PtSelfAttnBlock(D, D, K, **flags), variables, qxyz, qf, **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("init_block", [True, False])
def test_pointer_layer_use_fused(monkeypatch, init_block):
    """PointerLayer(use_fused=True, use_fused_knn=False) against the JAX layer
    with approx_knn=False: K8 twice per forward on both sides."""
    from poem_v2_tpu.models import decoder as jdec
    from poem_v2_tpu.models.bricks import point_transformer as jpt

    monkeypatch.setattr(jpt, "fused_vector_attention", _interp_fused(jpt))
    calls = []
    real = vector_attn.fused_vector_attention
    monkeypatch.setattr("poem_v2_tpu_torch.models.bricks.point_transformer.fused_vector_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rs = np.random.RandomState(6)
    B, M, N, D, K, A = 2, 40, 100, 32, 8, 8
    qxyz, qf = rs.randn(B, M, 3).astype(np.float32), rs.randn(B, M, D).astype(np.float32)
    xyz, feats = rs.randn(B, N, 3).astype(np.float32), rs.randn(B, N, D).astype(np.float32)
    q_idx = np.sort(rs.choice(M, A, replace=False))
    p_idx = np.sort(rs.choice(N, A, replace=False))
    a_xyz = rs.randn(A, 3).astype(np.float32)
    jmod = jdec.PointerLayer(D, K, K, init_block, approx_knn=False, use_fused=True,
                             use_fused_knn=False)
    variables, want = _jax_run(jmod, xyz, feats, qxyz, qf, jnp.asarray(q_idx, jnp.int32),
                               jnp.asarray(p_idx, jnp.int32), jnp.asarray(a_xyz))
    layer = PointerLayer(D, K, K, init_block, use_fused=True, use_fused_knn=False)
    got_f, got_xyz = _torch_run(layer, variables, xyz, feats, qxyz, qf, torch.from_numpy(q_idx),
                                torch.from_numpy(p_idx), torch.from_numpy(a_xyz))
    assert len(calls) == 2
    np.testing.assert_allclose(got_f.numpy(), want[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_xyz.numpy(), want[1], atol=1e-4, rtol=1e-4)


def test_default_blocks_keep_the_fused_knn_path(monkeypatch):
    """``use_fused_knn`` defaults to the serving path: K1 for neighbourhoods,
    K2 for anchors, never the gathered path."""
    hits = []
    mod = "poem_v2_tpu_torch.models.bricks.point_transformer."
    for name in ("fused_knn_vector_attention", "fused_anchor_vector_attention",
                 "fused_vector_attention", "vector_attention_reference"):
        real = getattr(__import__(mod[:-1], fromlist=[name]), name)
        monkeypatch.setattr(mod + name,
                            lambda *a, _n=name, _r=real, **kw: hits.append(_n) or _r(*a, **kw))
    rs = np.random.RandomState(8)
    layer = PointerLayer(32, 8, 8, init_block=False).eval()
    args = _t(rs.randn(1, 50, 3).astype(np.float32), rs.randn(1, 50, 32).astype(np.float32),
              rs.randn(1, 20, 3).astype(np.float32), rs.randn(1, 20, 32).astype(np.float32))
    with torch.no_grad():
        layer(*args)
        PointerLayer(32, 8, 8, init_block=True).eval()(
            *args, torch.arange(8), torch.arange(8), torch.zeros(8, 3))
    assert hits == ["fused_knn_vector_attention"] * 2 + ["fused_anchor_vector_attention"] * 2


# ---- K1 / K2 at the wide tiers' D ----------------------------------------------

def _wide_inputs(rs, B, M, N, D):
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    s = 1 / np.sqrt(D)
    fcd = (mk(3, D), mk(D) * 0.1, mk(D, D) * s, mk(D) * 0.1)
    fcg = (mk(D, D) * s, mk(D) * 0.1, mk(D, D) * s, mk(D) * 0.1)
    return mk, s, fcd, fcg


@pytest.mark.parametrize("D", [512, 1024])
def test_knn_vector_attention_at_wide_d_matches_pallas(D):
    from poem_v2_tpu.models.bricks.point_transformer import _fused_block_config
    from poem_v2_tpu.ops.pallas_knn_attn import fused_knn_vector_attention as jax_knn

    B, M, N, K = 1, 24, 96, 32
    mk, s, fcd, fcg = _wide_inputs(np.random.RandomState(9), B, M, N, D)
    args = (mk(B, M, D), mk(B, M, 3), mk(B, N, 3), mk(B, N, D), mk(D, D) * s, mk(D, D) * s)
    _, cj = _fused_block_config(N, K, D)  # the chunking the JAX blocks use at this width
    with jax.default_matmul_precision("highest"):
        want, want_idx = jax_knn(*map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)),
                                 tuple(map(jnp.asarray, fcg)), n_neighbor=K, block_q=8,
                                 chunk_j=cj, return_idx=True, interpret=True)
    got, idx = knn_attn.fused_knn_vector_attention(*_t(*args), _t(*fcd), _t(*fcg), n_neighbor=K,
                                                   return_idx=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # float32 sums over D terms in other orders, five products deep
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("D", [512, 1024])
def test_anchor_vector_attention_at_wide_d_matches_pallas(D):
    from poem_v2_tpu.ops.pallas_knn_attn import fused_anchor_vector_attention as jax_anchor

    B, M, A = 1, 24, 32
    mk, s, fcd, fcg = _wide_inputs(np.random.RandomState(10), B, M, A, D)
    args = (mk(B, M, D), mk(B, M, 3), mk(B, A, D), mk(B, A, D), mk(A, 3))
    with jax.default_matmul_precision("highest"):
        want = jax_anchor(*map(jnp.asarray, args), tuple(map(jnp.asarray, fcd)),
                          tuple(map(jnp.asarray, fcg)), block_q=8, interpret=True)
    got = knn_attn.fused_anchor_vector_attention(*_t(*args), _t(*fcd), _t(*fcg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_attention_wrappers_state_their_widths():
    """What csrc/knn_attn.cu takes, checked before any launch: D a multiple of 4
    up to 1024, any neighbour count (the rows a bf16 tile of 128 holds: floor(128
    / K) queries, or ceil(K / 128) tiles a query)."""
    for D in (128, 256, 512, 1024, 64, 32, 4):
        vector_attn.check_attention_shapes(D)
    for D in (1028, 2048, 30, 0):
        with pytest.raises(ValueError, match="CUDA kernel takes"):
            vector_attn.check_attention_shapes(D)
    assert vector_attn.core_rows(2, 799, 32) == 2 * 200 * 128  # 4 queries a tile
    assert vector_attn.core_rows(1, 65, 24) == 13 * 128        # 5 queries a tile
    assert vector_attn.core_rows(1, 3, 200) == 3 * 2 * 128     # 2 tiles a query
    # three [rows][D] float32 buffers and the softmax state fit a block's 227 KB:
    # 32 rows up to D = 256 and 16 above (VaBlock in csrc/knn_attn.cu)
    for D in (128, 256, 512, 1024):
        rows = 32 if D <= 256 else 16
        assert ((3 * rows + 3) * D + 3 * rows) * 4 + rows * 4 <= 227 * 1024


# ---- rotations ---------------------------------------------------------------

def _rotation_inputs(kind):
    rs = np.random.RandomState(11)
    if kind == "random":
        return rs.randn(64, 6).astype(np.float32)
    axis = rs.randn(64, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    if kind == "near_identity":
        angle = np.concatenate([[0.0, 1e-7, 1e-6, 1e-5], rs.uniform(0, 1e-3, 60)])
    else:  # near pi: the trace pivot loses, one of the three others is taken
        angle = np.pi - np.concatenate([[0.0, 1e-6, 1e-4], rs.uniform(0, 1e-2, 61)])
    from poem_v2_tpu.geometry.rotations import aa_to_rotmat, rotmat_to_rot6d

    aa = jnp.asarray((axis * angle[:, None]).astype(np.float32))
    r6 = np.asarray(rotmat_to_rot6d(aa_to_rotmat(aa)))
    return (r6 * rs.uniform(0.5, 2.0, (64, 1))).astype(np.float32)  # unnormalised rows


@pytest.mark.parametrize("kind", ["random", "near_identity", "near_pi"])
def test_rot6d_to_aa_and_its_parts_match_jax(kind):
    from poem_v2_tpu.geometry import rotations as jrot

    r6 = _rotation_inputs(kind)
    t6, j6 = torch.from_numpy(r6), jnp.asarray(r6)
    jm = jrot.rot6d_to_rotmat(j6)
    tm = trot.rot6d_to_rotmat(t6)
    # float32 elementwise chains: a few ulps
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    # the later stages on the same matrices, so that one branch choice is compared
    tm = torch.from_numpy(np.asarray(jm))
    jq, tq = jrot.rotmat_to_quat(jm), trot.rotmat_to_quat(tm)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(trot.quat_to_aa(torch.from_numpy(np.asarray(jq))).numpy(),
                               np.asarray(jrot.quat_to_aa(jq)), atol=1e-6)
    np.testing.assert_allclose(trot.rotmat_to_aa(tm).numpy(), np.asarray(jrot.rotmat_to_aa(jm)),
                               atol=2e-6)
    got = trot.rot6d_to_aa(t6)
    want = np.asarray(jrot.rot6d_to_aa(j6))
    assert got.dtype == torch.float32 and got.shape == (64, 3)
    if kind == "near_pi":
        # at the angle pi the axis' sign is free: compare the rotations
        np.testing.assert_allclose(trot.aa_to_rotmat(got).numpy(),
                                   np.asarray(jrot.aa_to_rotmat(jnp.asarray(want))), atol=5e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=5e-6)


def test_rot6d_to_aa_round_trip():
    rs = np.random.RandomState(12)
    axis = rs.randn(32, 16, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    aa = torch.from_numpy((axis * rs.uniform(0.0, 3.0, (32, 16, 1))).astype(np.float32))
    r6 = trot.aa_to_rotmat(aa)[..., :2, :].reshape(32, 16, 6)
    np.testing.assert_allclose(trot.rot6d_to_aa(r6).numpy(), aa.numpy(), atol=1e-5)


# ---- the slice: a tiny parametric model on a mixed-view batch -----------------

def _parametric_cfg():
    cfg = tiny_cfg()
    cfg.HEAD.TRANSFORMER.PARAMETRIC_OUTPUT = True
    cfg.HEAD.TRANSFORMER.TRANSFORMER_CENTER_IDX = 9
    return cfg


def test_parametric_slice_matches_jax_poemnet():
    """A tiny ``PARAMETRIC_OUTPUT`` model on a batch that mixes 3, 2 and 1 valid
    views of 3. Coordinates as tests/test_torch_slice.py (2e-5 m); shape
    through the same decoder plus one Dense(1) over 799 tokens: 1e-4. The
    pose is held to 1e-3 (radians, and entries of the rotation matrices):
    with random weights the regressed 6D rows have norms down to 0.04, so
    Gram-Schmidt multiplies the float32 noise of the 799-term sums by up to
    25 (measured: 2.4e-4 on the matrices, 2.9e-4 rad), while a wrong row
    order or convention moves entries by tenths."""
    from poem_v2_tpu.models.poem import create_poem_model as jax_create

    cfg = _parametric_cfg()
    rs = np.random.RandomState(0)
    B, V, size = 3, 3, 64
    images = rs.uniform(-0.5, 0.5, (B, V, size, size, 3)).astype(np.float32)
    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], bool)
    intr, extr = look_at_cameras(rs, B, V, size)
    master = (rs.randn(B, 21, 3) * 0.02 + [0, 0, 0.5]).astype(np.float32)  # single-view ref
    jmodel, jaux = jax_create(cfg, use_flash=True)
    assert jaux["parametric_output"]
    rng = jax.random.PRNGKey(0)
    args = tuple(jnp.asarray(a) for a in (images, mask, intr, extr, master))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": rng, "noise": rng, "dropout": rng}, *args, train=False))
    variables = fill_params(shapes, gain=0.5)
    with pallas_interpret(exact_sampler=True), jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(variables, *args)
        want = jax.tree_util.tree_map(np.asarray, want)

    tmodel, aux = torch_create(cfg, device="cpu")
    assert aux["parametric_output"]
    load_converted(tmodel, variables)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (images, mask, intr, extr, master)))
    assert got["pred_pose"].shape == (B, 16, 3) and got["pred_shape"].shape == (B, 10)
    for key, tol in (("all_coords_preds", 2e-5), ("pred_joints_3d", 2e-5),
                     ("pred_verts_3d", 2e-5), ("pred_pose", 1e-3), ("pred_shape", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=tol, rtol=0, err_msg=key)
    np.testing.assert_allclose(trot.aa_to_rotmat(got["pred_pose"]).numpy(),
                               trot.aa_to_rotmat(torch.from_numpy(want["pred_pose"])).numpy(),
                               atol=1e-3, rtol=0)
    # the final block is the MANO surface: not the decoder's own last coordinates
    assert float(np.abs(want["all_coords_preds"][-1] - want["all_coords_preds"][-2]).max()) > 1e-4


def test_predictor_passes_view_masks_of_differing_counts():
    """A request whose samples have 3, 1 and 2 valid views of 3 goes through
    ``pad`` unchanged (the view bucket is padded behind it, the batch to 4 with
    copies of row 0) and equals the model on the batch padded by hand."""
    model, _ = torch_create(_parametric_cfg(), device="cpu",
                            generator=torch.Generator().manual_seed(4))
    pred = Predictor(model, view_bucket=4, image_size=64)
    rs = np.random.RandomState(2)
    images = rs.randint(0, 256, (3, 3, 64, 64, 3)).astype(np.uint8)
    intr, extr = look_at_cameras(rs, 3, 3, 64)
    mask = np.array([[1, 1, 1], [1, 0, 0], [1, 1, 0]], bool)
    p_img, p_mask, p_intr, p_extr = pred.pad(images, intr, extr, mask)
    assert p_mask.shape == (4, 4) and p_mask[:3, :3].tolist() == mask.tolist()
    assert not p_mask[:, 3].any() and p_mask[3].tolist() == p_mask[0].tolist()
    np.testing.assert_array_equal(p_img[:3, :3], images)
    out = pred(images, intr, extr, mask)
    with torch.no_grad():
        ref = model(torch.from_numpy(p_img).float() / 255.0 - 0.5, torch.from_numpy(p_mask),
                    torch.from_numpy(p_intr), torch.from_numpy(p_extr), torch.zeros(4, 21, 3))
    np.testing.assert_array_equal(out["joints_3d"], ref["pred_joints_3d"][:3].numpy())
    np.testing.assert_array_equal(out["verts_3d"], ref["pred_verts_3d"][:3].numpy())
    assert np.isfinite(out["verts_3d"]).all()
