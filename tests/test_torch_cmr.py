"""The port's CMR (``models/cmr.py``) and its reference-name table
(``convert_reference.convert_cmr_network``) against the JAX package, on the CPU.

Tolerances: the host numpy (hierarchy, spirals, up matrices, relation matrix,
the transform loader) equal array for array from the same template; float32
modules 1e-4 of the output's largest magnitude; converted arrays bit for bit.
``SelfAttention.gamma`` is set nonzero wherever the attention runs (flax
initialises it to zero, which would hide the branch). One torch thread, the JAX
side jitted, its CMRG compiled once for the file.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted, one_thread_no_tf32, to_numpy_tree

from poem_v2_tpu.models import cmr as jcmr
from poem_v2_tpu_torch import convert_reference as cr
from poem_v2_tpu_torch.convert import flax_to_state_dict
from poem_v2_tpu_torch.mano.layer import ManoLayer
from poem_v2_tpu_torch.models import cmr as tcmr
from poem_v2_tpu_torch.utils.registry import MODEL

REL = 1e-4
GAMMA = 0.7


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_no_tf32():
        yield


def _close(name, got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max(), err_msg=name)


def _equal_lists(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=str(i))


@pytest.fixture(scope="module")
def templates():
    """verts[0] of a zero-pose forward of each side's MANO layer (centred on joint 0)."""
    from poem_v2_tpu.mano import ManoLayer as JaxMano

    z48, z10 = np.zeros((1, 48), np.float32), np.zeros((1, 10), np.float32)
    jv = np.asarray(JaxMano(center_idx=0)(z48, z10).verts[0])
    tv = ManoLayer(center_idx=0)(torch.zeros(1, 48), torch.zeros(1, 10)).verts[0].numpy()
    return jv, tv


def test_hierarchy_from_shared_template(templates):
    jv, _ = templates
    for got, want in zip(tcmr.build_mesh_hierarchy(jv), jcmr.build_mesh_hierarchy(jv)):
        _equal_lists(got, want)
    rv = np.random.RandomState(0).randn(300, 3).astype(np.float32)
    kw = dict(levels=(300, 150, 75), spiral_len=5)
    for got, want in zip(tcmr.build_mesh_hierarchy(rv, **kw), jcmr.build_mesh_hierarchy(rv, **kw)):
        _equal_lists(got, want)


def test_hierarchy_from_each_sides_template(templates):
    """The port's float32 zero-pose template is not JAX's bit for bit (LBS sums in
    another order); the levels pick the same vertices and the spirals are equal,
    and the up matrices' inverse-distance weights agree to 2e-6."""
    jv, tv = templates
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-7)
    (jverts, jsp, jup), (tverts, tsp, tup) = (jcmr.build_mesh_hierarchy(jv),
                                              tcmr.build_mesh_hierarchy(tv))
    _equal_lists(tsp, jsp)
    assert [v.shape for v in tverts] == [v.shape for v in jverts]
    for g, w in zip(tverts, jverts):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    for g, w in zip(tup, jup):
        assert ((g != 0) == (w != 0)).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    spirals, ups = tcmr.cmr_hierarchy(None, ManoLayer(center_idx=0))
    _equal_lists(spirals, jsp[:4])
    _equal_lists(ups, tup[:4])


def test_relation_matrix_and_spirals_from_faces():
    from poem_v2_tpu_torch.mano.model import default_mano

    _equal_lists([tcmr.relation_matrix(21), tcmr.relation_matrix(25)],
                 [jcmr.relation_matrix(21), jcmr.relation_matrix(25)])
    faces = np.asarray(default_mano().faces)
    for seq in (9, 27):
        _equal_lists([tcmr.extract_spirals(faces, 778, seq)],
                     [jcmr.extract_spirals(faces, 778, seq)])


def test_load_spiral_transform(tmp_path):
    import scipy.sparse as sp

    from poem_v2_tpu_torch.mano.model import default_mano

    rs = np.random.RandomState(1)
    faces = np.asarray(default_mano().faces)
    payload = {"vertices": [rs.randn(778, 3), rs.randn(389, 3)],
               "face": [faces, faces[:300] // 2],
               "up_transform": [sp.random(778, 389, density=0.01, random_state=rs, format="csr"),
                                rs.rand(389, 195)]}
    path = tmp_path / "transform.pkl"
    path.write_bytes(pickle.dumps(payload))
    for got, want in zip(tcmr.load_spiral_transform(str(path)),
                         jcmr.load_spiral_transform(str(path))):
        _equal_lists(got, want)


def _init(module, *args, seed=0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    variables = fill_params(shapes, seed=seed, gain=0.5)
    if "attention" in variables["params"]:
        variables["params"]["attention"]["gamma"] = np.full((1,), GAMMA, np.float32)
    return variables


def _hier():
    _, spirals, ups = jcmr.build_mesh_hierarchy(
        np.random.RandomState(2).randn(778, 3).astype(np.float32) * 0.05)
    return spirals, ups


@pytest.mark.parametrize("level", [0, 3])
def test_spiral_conv_and_deblock(level):
    spirals, ups = _hier()
    rs = np.random.RandomState(3)
    idx, up = spirals[level], ups[level]
    x = rs.randn(2, up.shape[1], 12).astype(np.float32)
    jdb = jcmr.ParallelDeblock(16, idx, up)
    v = _init(jdb, jnp.asarray(x))
    want = jax.jit(jdb.apply)(v, jnp.asarray(x))
    tdb = tcmr.ParallelDeblock(12, 16, idx, up)
    load_converted(tdb, v)
    with torch.no_grad():
        _close("deblock", tdb(torch.from_numpy(x)), want)
    fine = rs.randn(2, up.shape[0], 12).astype(np.float32)
    jsc = jcmr.SpiralConv(3, idx)
    v = _init(jsc, jnp.asarray(fine), seed=4)
    tsc = tcmr.SpiralConv(12, 3, idx)
    load_converted(tsc, v)
    with torch.no_grad():
        _close("spiral", tsc(torch.from_numpy(fine)), jax.jit(jsc.apply)(v, jnp.asarray(fine)))
        _close("mesh_pool", tcmr.mesh_pool(torch.from_numpy(x), torch.from_numpy(up)),
               jcmr.mesh_pool(jnp.asarray(x), up))


def test_self_attention():
    x = np.random.RandomState(5).randn(3, 40).astype(np.float32)
    jat = jcmr.SelfAttention()
    v = _init(jat, jnp.asarray(x))
    tat = tcmr.SelfAttention(40)
    load_converted(tat, v)
    want = jax.jit(jat.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tat(torch.from_numpy(x))
    _close("attention", got, want)
    assert np.abs(got.numpy() - x).max() > 1e-2  # the branch moves the output


def test_uv_decoder():
    rs = np.random.RandomState(6)
    chans, sizes = (64, 32, 16, 8), (2, 4, 8, 16)
    z = [rs.randn(2, s, s, c).astype(np.float32) for s, c in zip(sizes, chans)]
    jdec = jcmr.UVDecoder((32, 16, 8, 8), 22)
    v = _init(jdec, [jnp.asarray(a) for a in z])
    want = jax.jit(jdec.apply)(v, [jnp.asarray(a) for a in z])
    tdec = tcmr.UVDecoder(chans, (32, 16, 8, 8), 22)
    load_converted(tdec, v)
    with torch.no_grad():
        got = tdec([torch.from_numpy(a).permute(0, 3, 1, 2) for a in z])
    _close("uv", got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("encoder", ["uv", "mesh"])
def test_encoders(encoder):
    """EncodeUV (post-stem feature and four stages) and EncodeMesh (reduce stem,
    stages, the fc latent) on their own, ResNet-18 GN at 32 px."""
    rs = np.random.RandomState(9)
    cin = 3 if encoder == "uv" else 100
    x = rs.randn(2, 32, 32, cin).astype(np.float32)
    jmod = jcmr.EncodeUV() if encoder == "uv" else jcmr.EncodeMesh()
    v = _init(jmod, jnp.asarray(x))
    want = jax.jit(jmod.apply)(v, jnp.asarray(x))
    tmod = (tcmr.EncodeUV() if encoder == "uv" else tcmr.EncodeMesh(cin)).eval()
    load_converted(tmod, v)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    _close("latent / x0", got[0] if encoder == "mesh" else got[0].permute(0, 2, 3, 1), want[0])
    for i in range(1, 5):
        _close(f"stage {5 - i}", got[i].permute(0, 2, 3, 1), want[i])


@pytest.fixture(scope="module")
def jax_cmr():
    """The JAX factory's CMRG (ResNet-18 GN), filled weights with gamma nonzero, a
    64 px batch and its jitted forward."""
    model, _ = jcmr.create_cmr_model()
    img = np.random.RandomState(7).uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
    variables = _init(model, jnp.asarray(img))
    with jax.default_matmul_precision("highest"):
        out = jax.jit(model.apply)(variables, jnp.asarray(img))
    return model, variables, img, jax.tree_util.tree_map(np.asarray, out)


def _check_outputs(got, want):
    shapes = {"pred_verts_3d_rel": (2, 778, 3), "uv_pred": (2, 32, 32, 21),
              "mask_pred": (2, 32, 32), "uv_prior": (2, 32, 32, 21)}
    for key, shape in shapes.items():
        assert got[key].shape == shape, key
        _close(key, got[key], want[key])
    assert len(got["mesh_pred"]) == 4
    for i, (g, w) in enumerate(zip(got["mesh_pred"], want["mesh_pred"])):
        _close(f"mesh_pred[{i}]", g, w)


def test_cmrg_on_the_jax_hierarchy(jax_cmr):
    model, variables, img, want = jax_cmr
    tmodel = tcmr.CMRG(model.spirals, model.up_mats).eval()
    load_converted(tmodel, variables)
    with torch.no_grad():
        _check_outputs(tmodel(torch.from_numpy(img)), want)


def test_create_cmr_model(jax_cmr):
    """The port's factory, on its own hierarchy, with the same converted weights."""
    _, variables, img, want = jax_cmr
    assert MODEL.get("CMR_G") is tcmr.create_cmr_model
    tmodel, aux = tcmr.create_cmr_model(device="cpu")
    assert float(tmodel.attention.gamma.detach()) == 0.0 and isinstance(aux["mano_layer"], ManoLayer)
    load_converted(tmodel, variables)
    with torch.no_grad():
        _check_outputs(tmodel(torch.from_numpy(img)), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tcmr.create_cmr_model()


@pytest.mark.parametrize("cfg", [
    {"BACKBONE": {"TYPE": "resnet50", "FREEZE_BATCHNORM": True}, "OUT_CHANNELS": [16, 16, 32, 32],
     "ATT": False},
    {"BACKBONE": {"TYPE": "resnet34", "NORM": "bn"}},
])
def test_configs_map_one_to_one(cfg):
    """Other trunks, norms and widths: one port key per flax leaf, the same shapes
    (``frozen_bn`` chosen by ``FREEZE_BATCHNORM``, as the JAX factory does)."""
    from poem_v2_tpu.utils.config import Config

    jmodel, _ = jcmr.create_cmr_model(Config(cfg))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    sd = flax_to_state_dict(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                   shapes))
    tmodel, _ = tcmr.create_cmr_model(cfg, device="cpu")
    tsd = {k: v for k, v in tmodel.state_dict().items()}
    assert set(sd) == set(tsd), sorted(set(sd) ^ set(tsd))[:6]
    assert all(tuple(tsd[k].shape) == v.shape for k, v in sd.items())


def test_reference_table_is_the_jax_converter():
    """A reference-named CMR_G state dict (random frozen-BN weights written under the
    reference names by the port's table, and the ConvBlocks' BatchNorm counters,
    which both converters consume and drop): the JAX converter consumes exactly the
    table's keys and fills the arrays the table gives the port, bit for bit."""
    from poem_v2_tpu.utils.torch_convert import convert_cmr_network as jax_convert

    spirals, ups = _hier()
    jmodel = jcmr.CMRG(norm="frozen_bn", spirals=tuple(spirals[:4]), up_mats=tuple(ups[:4]))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    variables = fill_params(shapes, seed=8, gain=0.5)
    port_sd = flax_to_state_dict(to_numpy_tree(variables))
    tmodel = tcmr.CMRG(spirals[:4], ups[:4], norm="frozen_bn")
    table = cr.convert_cmr_network(tmodel.state_dict().keys())
    assert {p for p, _ in table.values() if p is not None} == set(tmodel.state_dict())
    ref = cr.table_to_reference({k: torch.from_numpy(np.array(v)) for k, v in port_sd.items()},
                                table)
    dropped = [k for k, (p, _) in table.items() if p is None]
    assert dropped and all(k.endswith(".norm.num_batches_tracked") for k in dropped)
    ref.update({k: torch.zeros((), dtype=torch.long) for k in dropped})
    ref["unrelated.weight"] = torch.zeros(2)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    used = jax_convert(ref, params)
    assert sorted(used) == sorted(table)
    got, left = cr.apply_table(ref, table)
    assert left == ["unrelated.weight"]
    want = flax_to_state_dict({"params": params})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    tmodel.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in got.items()}, strict=True)
