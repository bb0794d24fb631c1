"""The port's METRO network against the JAX package, on the CPU.

The mesh samplers (synthetic, bit for bit; and the reference npz loader) and
``create_metro_model`` at ``tests/test_aux_models.py``'s config (ResNet-18 GN,
widths 515 / 128 / 32 in, 256 / 64 / 16 hidden) with converted weights, in
eval and in training mode at dropout 0 (the einsum attention path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted

from poem_v2_tpu_torch.models import metro
from poem_v2_tpu_torch.utils.registry import MODEL

CFG = {"BACKBONE": {"TYPE": "resnet18", "NORM": "gn"}, "INPUT_FEAT_DIM": [515, 128, 32],
       "HIDDEN_FEAT_DIM": [256, 64, 16]}


def test_synthetic_mesh_sampler_is_bit_equal():
    from poem_v2_tpu.models.metro import synthetic_mesh_sampler as jax_sampler

    verts = np.random.RandomState(0).randn(778, 3).astype(np.float32) * 0.05
    for n_sub, k in ((195, 3), (49, 4)):
        D0, U0 = jax_sampler(verts, n_sub, k)
        D1, U1 = metro.synthetic_mesh_sampler(verts, n_sub, k)
        np.testing.assert_array_equal(D1, D0)
        np.testing.assert_array_equal(U1, U0)
        assert D1.shape == (n_sub, 778) and np.allclose(U1.sum(1), 1.0)


def test_mesh_sampler_loader_matches_jax(tmp_path):
    import scipy.sparse as sp

    from poem_v2_tpu.models.metro import load_mesh_sampler as jax_load

    rs = np.random.RandomState(0)
    mats = dict(A=sp.eye(12, format="coo"), U=sp.random(12, 5, density=0.4, random_state=rs),
                D=sp.random(5, 12, density=0.4, random_state=rs, format="csr"))
    path = tmp_path / "mano_downsampling.npz"
    np.savez(path, **{k: np.asarray([v], dtype=object) for k, v in mats.items()})
    for got, want in zip(metro.load_mesh_sampler(str(path)), jax_load(str(path))):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_metro():
    from poem_v2_tpu.models.metro import create_metro_model as jax_create
    from poem_v2_tpu.utils.config import Config

    model, aux = jax_create(Config(CFG))
    img = np.random.RandomState(1).uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": rng, "dropout": rng},
                                               jnp.asarray(img)))
    variables = fill_params(shapes, gain=0.5)
    return model, aux, variables, img


@pytest.mark.parametrize("train", [False, True])
def test_create_metro_model_matches_jax(jax_metro, train):
    """Every output to 1e-5 of its largest value; the samplers and templates the
    two factories build agree (D exactly; U to 1e-5, as each side's float32 MANO
    template differs in its last bits and a vertex next to a chosen one has
    weights of 1 / (distance + 1e-6)). Training runs the einsum attention at DROPOUT 0 on both sides."""
    jmodel, jaux, variables, img = jax_metro
    if train:
        from poem_v2_tpu.models.metro import METRONetwork

        jmodel = METRONetwork(**{f: getattr(jmodel, f) for f in (
            "backbone", "downsample_mat", "upsample_init", "template_joints",
            "template_verts_sub", "input_feat_dims", "hidden_feat_dims")}, dropout=0.0)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(variables, jnp.asarray(img), train=train,
                            rngs={"dropout": jax.random.PRNGKey(2)})
    tmodel, taux = metro.create_metro_model(CFG, device="cpu")
    assert MODEL.get("METRO") is metro.create_metro_model
    np.testing.assert_array_equal(taux["downsample"], jaux["downsample"])
    np.testing.assert_allclose(taux["upsample"], jaux["upsample"], atol=1e-5)
    load_converted(tmodel, variables)
    if train:
        for mod in tmodel.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
    tmodel.train(train)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    shapes = {"pred_joints_3d_rel": (2, 21, 3), "pred_verts_sub_3d_rel": (2, 195, 3),
              "pred_verts_3d_rel": (2, 778, 3), "pred_cam": (2, 3)}
    for key, shape in shapes.items():
        w = np.asarray(want[key])
        assert got[key].shape == w.shape == shape, key
        np.testing.assert_allclose(got[key].numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=key)
