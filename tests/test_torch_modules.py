"""Port modules vs their flax counterparts on the CPU, at narrow widths.

Parameters come from ``jax.eval_shape`` filled by numpy (gain 0.5, see
test_torch_slice.py), converted by ``poem_v2_tpu_torch.convert``; JAX runs
its Pallas eval kernels in interpret mode at "highest" matmul precision.
Backbone and necks take NCHW in the port, so the tests transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted, look_at_cameras, pallas_interpret

from poem_v2_tpu_torch.models import positional as tpos
from poem_v2_tpu_torch.models.backbones.hrnet import HRNet
from poem_v2_tpu_torch.models.bricks.attention import BertFFN, MultiHeadCrossAttention
from poem_v2_tpu_torch.models.bricks.point_transformer import PtCrossAttnBlock, PtSelfAttnBlock
from poem_v2_tpu_torch.models.decoder import PointMetroBlock
from poem_v2_tpu_torch.models.heads.ptemb_head import POEMGeneralizedHead
from poem_v2_tpu_torch.models.neck import HRNetFeatNeck, UVDecodeNeck

# float32 on both sides, sums in other orders through a few layers
ATOL = 1e-4


def _jax_run(module, *args, **kw):
    """(variables, outputs as numpy) of a flax module on numpy inputs."""
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


def _nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=atol)


@pytest.mark.parametrize("norm", ["gn", "frozen_bn", "bn"])
def test_hrnet_pyramid(norm):
    from poem_v2_tpu.models.backbones.hrnet import HRNet as JHRNet

    img = np.random.RandomState(0).uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
    variables, want = _jax_run(JHRNet(width=8, norm=norm), img)
    got = _torch_run(HRNet(width=8, norm=norm), variables, _nchw(img))
    assert len(got) == len(want) == 4
    # ~40 conv + norm layers in float32: differences grow to ~3e-5 of the
    # activations' scale, so the bound is relative to each branch's max
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w, atol=1e-4 * np.abs(w).max())


def _pyramid(rs, widths=(8, 16, 32, 64), size=16):
    return [rs.randn(2, size >> i, size >> i, c).astype(np.float32)
            for i, c in enumerate(widths)]


def test_hrnet_feat_neck():
    from poem_v2_tpu.models.neck import HRNetFeatNeck as J

    feats = _pyramid(np.random.RandomState(1))
    variables, want = _jax_run(J(feat_size=(8, 16, 32, 64)), feats)
    got = _torch_run(HRNetFeatNeck((8, 16, 32, 64)), variables,
                     [torch.from_numpy(_nchw(f)) for f in feats])
    _close(got.permute(0, 2, 3, 1), want)


def test_uv_decode_neck():
    from poem_v2_tpu.models.neck import UVDecodeNeck as J

    feats = _pyramid(np.random.RandomState(2))
    variables, (want_hm, want_feat) = _jax_run(J(feat_size=(8, 16, 32, 64), hrnet=True), feats)
    neck = UVDecodeNeck((8, 16, 32, 64), hrnet=True)
    hm = _torch_run(neck, variables, [torch.from_numpy(_nchw(f)) for f in feats])
    _close(hm.permute(0, 2, 3, 1), want_hm)
    with torch.no_grad():
        _close(neck.uv_feat(hm).permute(0, 2, 3, 1), want_feat)


def test_sine_positional_encoding_factors():
    from poem_v2_tpu.models.positional import sine_positional_encoding_3d_factors as J

    mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0]], bool)
    want = J(jnp.asarray(mask), 8, 6, num_feats=16)
    got = tpos.sine_positional_encoding_3d_factors(torch.from_numpy(mask), 8, 6, num_feats=16)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), atol=1e-6)


def test_attention_and_ffn():
    from poem_v2_tpu.models.bricks.attention import BertFFN as JFFN
    from poem_v2_tpu.models.bricks.attention import MultiHeadCrossAttention as JMHA

    rs = np.random.RandomState(3)
    hidden, kv = rs.randn(2, 50, 32).astype(np.float32), rs.randn(2, 70, 32).astype(np.float32)
    variables, want = _jax_run(JMHA(32, 4, use_flash=True), hidden, kv, deterministic=True)
    _close(_torch_run(MultiHeadCrossAttention(32, 4), variables, hidden, kv), want)
    variables, want = _jax_run(JFFN(32, 128), hidden, deterministic=True)
    _close(_torch_run(BertFFN(32, 128), variables, hidden), want)


@pytest.mark.parametrize("anchors", [False, True])
def test_point_transformer_blocks(anchors):
    from poem_v2_tpu.models.bricks import point_transformer as jpt

    rs = np.random.RandomState(4)
    B, M, N, D, K, A = 2, 40, 100, 32, 8, 8
    xyz, feats = rs.randn(B, N, 3).astype(np.float32), rs.randn(B, N, D).astype(np.float32)
    qxyz, qf = rs.randn(B, M, 3).astype(np.float32), rs.randn(B, M, D).astype(np.float32)
    kw = {}
    if anchors:
        kw = dict(anchor_idx=np.sort(rs.choice(M, A, replace=False)).astype(np.int32),
                  anchor_xyz=rs.randn(A, 3).astype(np.float32))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
           for k, v in kw.items()}

    variables, want = _jax_run(jpt.PtCrossAttnBlock(D, D, K, use_fused_knn=True),
                               xyz, feats, qxyz, qf, **jkw)
    _close(_torch_run(PtCrossAttnBlock(D, D, K), variables, xyz, feats, qxyz, qf, **tkw), want)
    variables, want = _jax_run(jpt.PtSelfAttnBlock(D, D, K, use_fused_knn=True), qxyz, qf, **jkw)
    _close(_torch_run(PtSelfAttnBlock(D, D, K), variables, qxyz, qf, **tkw), want)


@pytest.mark.parametrize("init_block", [True, False])
def test_point_metro_block(init_block):
    from poem_v2_tpu.models.decoder import PointMetroBlock as J

    rs = np.random.RandomState(5)
    B, M, N, D, K, A = 2, 40, 100, 32, 8, 8
    qxyz, qf = rs.randn(B, M, 3).astype(np.float32), rs.randn(B, M, D).astype(np.float32)
    xyz, feats = rs.randn(B, N, 3).astype(np.float32), rs.randn(B, N, D).astype(np.float32)
    q_idx = np.sort(rs.choice(M, A, replace=False)).astype(np.int32)
    p_idx = np.sort(rs.choice(M, A, replace=False)).astype(np.int32)
    a_xyz = rs.randn(A, 3).astype(np.float32)
    jmod = J(D, 4, n_neighbor=K, n_neighbor_query=K, init_block=init_block,
             use_fused_knn=True, use_flash=True)
    variables, want = _jax_run(jmod, qxyz, qf, xyz, feats, jnp.asarray(q_idx),
                               jnp.asarray(p_idx), jnp.asarray(a_xyz))
    feats_out, xyz_out = _torch_run(
        PointMetroBlock(D, 4, K, K, init_block=init_block), variables, qxyz, qf, xyz, feats,
        torch.from_numpy(q_idx.astype(np.int64)), torch.from_numpy(p_idx.astype(np.int64)),
        torch.from_numpy(a_xyz))
    _close(feats_out, want[0])
    _close(xyz_out, want[1])


def test_poem_head_uniform_views():
    """All samples use every view: the scramble is the plain reshape."""
    from poem_v2_tpu.models.heads.ptemb_head import POEMGeneralizedHead as J
    from poem_v2_tpu.models.heads.ptemb_head import generate_bps_basis

    rs = np.random.RandomState(6)
    B, V, H, W, Cin, C, NS = 2, 3, 8, 8, 16, 32, 128
    static = dict(
        bps_basis=generate_bps_basis(NS, 0.1),
        template_mesh=(rs.randn(799, 3) * 0.03).astype(np.float32),
        query_anchor_idx=rs.choice(799, 32, replace=False).astype(np.int32),
        pt_anchor_idx=rs.choice(NS, 32, replace=False).astype(np.int32),
    )
    dims = dict(embed_dims=C, pt_feat_dim=C, in_channels=Cin, nsample=NS, radius=0.1,
                pe_num_feats=16, n_blocks=2, num_heads=4, n_neighbor=8, n_neighbor_query=8)
    jhead = J(**dims, **static, use_fused_knn=True, use_fused_sampling=True, use_flash=True)
    feat = rs.randn(B, V, H, W, Cin).astype(np.float32)
    mask = np.ones((B, V), bool)
    intr, extr = look_at_cameras(rs, B, V, 64)
    ref = (rs.randn(B, 21, 3) * 0.02 + [0, 0, 0.5]).astype(np.float32)
    variables, want = _jax_run(jhead, feat, mask, intr, extr, ref, inp_res=(64, 64),
                               deterministic=True)
    got = _torch_run(POEMGeneralizedHead(**dims, **static), variables, feat, mask, intr, extr,
                     ref, inp_res=(64, 64))
    _close(got["all_coords_preds"], want["all_coords_preds"], atol=2e-5)


def test_medium_config_matches_release_yaml():
    import yaml

    from poem_v2_tpu_torch.configs import MEDIUM

    with open("configs/release/train_medium.yaml") as f:
        cfg = yaml.safe_load(f)
    assert MEDIUM == {"TRAIN": cfg["TRAIN"], "MODEL": cfg["MODEL"],
                      "DATA_PRESET": cfg["DATA_PRESET"]}


def test_mano_arrays_and_template_match_jax():
    import dataclasses

    from poem_v2_tpu.mano.layer import ManoLayer as JLayer
    from poem_v2_tpu.mano.model import synthetic_mano as j_synth
    from poem_v2_tpu_torch.mano.layer import ManoLayer
    from poem_v2_tpu_torch.mano.model import synthetic_mano

    a, b = synthetic_mano(), j_synth()
    for field in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, field.name), getattr(b, field.name),
                                      err_msg=field.name)
    rs = np.random.RandomState(7)
    pose = (rs.randn(2, 48) * 0.3).astype(np.float32)
    pose[0] = 0.0  # the zero pose: the head's template
    betas = (rs.randn(2, 10) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = JLayer(center_idx=9)(jnp.asarray(pose), jnp.asarray(betas))
    got = ManoLayer(center_idx=9)(torch.from_numpy(pose), torch.from_numpy(betas))
    _close(got.joints, np.asarray(want.joints), atol=1e-6)
    _close(got.verts, np.asarray(want.verts), atol=1e-6)
