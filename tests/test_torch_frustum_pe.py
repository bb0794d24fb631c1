"""The frustum and positional-encoding pieces of the port against the JAX package, on the CPU.

``inverse_sigmoid``, ``sine_positional_encoding_3d``, ``pos2posemb3d``,
``frustum_points`` (linear and LID depth bins) and ``FrustumPositionEncoder``
at the POEM head's and the PETR head's hidden widths, on the same numpy
inputs and converted weights. JAX runs at "highest" matmul precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted, look_at_cameras

from poem_v2_tpu_torch.geometry.camera import inverse_sigmoid
from poem_v2_tpu_torch.models import frustum, positional

# float32 transcendental functions of two libraries: a few ulps
ATOL_TRIG = 2e-6
# frustum points in metres (up to ~1.5 m): float32 products and sums in one order
ATOL_M = 1e-6


def test_inverse_sigmoid_matches_jax():
    from poem_v2_tpu.geometry.camera import inverse_sigmoid as jax_inv

    x = np.array([-0.5, 0.0, 1e-7, 1e-5, 0.01, 0.3, 0.5, 0.77, 1 - 1e-6, 1.0, 1.5], np.float32)
    x = np.concatenate([x, np.random.RandomState(0).rand(64).astype(np.float32)])
    want = np.asarray(jax_inv(jnp.asarray(x)))
    got = inverse_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[1] == pytest.approx(np.log(1e-5)) and got[-66] == pytest.approx(-got[1])


@pytest.mark.parametrize("num_feats", [8, 32])
def test_sine_positional_encoding_3d_matches_jax(num_feats):
    from poem_v2_tpu.models.positional import sine_positional_encoding_3d as jax_pe

    mask = np.array([[True, True, True, True], [True, True, False, False], [True] + [False] * 3])
    want = np.asarray(jax_pe(jnp.asarray(mask), 5, 7, num_feats=num_feats))
    got = positional.sine_positional_encoding_3d(torch.from_numpy(mask), 5, 7,
                                                 num_feats=num_feats).numpy()
    assert got.shape == want.shape == (3, 4, 5, 7, 3 * num_feats)
    np.testing.assert_allclose(got, want, atol=ATOL_TRIG, rtol=0)


@pytest.mark.parametrize("num_pos_feats", [16, 128])
def test_pos2posemb3d_matches_jax(num_pos_feats):
    from poem_v2_tpu.models.positional import pos2posemb3d as jax_emb

    pos = np.random.RandomState(1).rand(6, 9, 3).astype(np.float32)
    want = np.asarray(jax_emb(jnp.asarray(pos), num_pos_feats=num_pos_feats))
    got = positional.pos2posemb3d(torch.from_numpy(pos), num_pos_feats=num_pos_feats).numpy()
    assert got.shape == want.shape == (6, 9, 3 * num_pos_feats)
    np.testing.assert_allclose(got, want, atol=ATOL_TRIG, rtol=0)


def _cameras(B=2, V=3, size=64, seed=2):
    return look_at_cameras(np.random.RandomState(seed), B, V, size)


@pytest.mark.parametrize("lid", [False, True])
def test_frustum_points_match_jax(lid):
    from poem_v2_tpu.models.frustum import frustum_points as jax_fp

    intr, extr = _cameras()
    kw = dict(depth_num=6, depth_start=0.1, depth_end=1.2, lid=lid)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_fp(jnp.asarray(intr), jnp.asarray(extr), (4, 5), (64, 64), **kw))
    got = frustum.frustum_points(torch.from_numpy(intr), torch.from_numpy(extr), (4, 5),
                                 (64, 64), **kw).numpy()
    assert got.shape == want.shape == (2, 3, 5, 4, 6, 3)
    np.testing.assert_allclose(got, want, atol=ATOL_M, rtol=0)


@pytest.mark.parametrize("hidden_mult,lid,box", [(2, False, 0.6), (4, True, 0.3)])
def test_frustum_position_encoder_matches_jax(hidden_mult, lid, box):
    """The POEM head's encoder (hidden 2 x embed) and the PETR head's (4 x), the
    embedding to 1e-5 of its largest value, the points as above and the
    out-of-range mask exactly (position ranges of +-0.6 and +-0.3 m, both of
    which the frusta leave)."""
    from poem_v2_tpu.models.frustum import FrustumPositionEncoder as JaxEnc

    intr, extr = _cameras(seed=3)
    kw = dict(embed_dims=16, depth_num=8, lid=lid, hidden_mult=hidden_mult,
              position_range=(-box, -box, 0.0, box, box, 1.2))
    jenc = JaxEnc(**kw)
    args = (jnp.asarray(intr), jnp.asarray(extr), (4, 6), (64, 64))
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), *args))
    variables = fill_params(shapes)
    with jax.default_matmul_precision("highest"):
        want = [np.asarray(a) for a in jenc.apply(variables, *args)]
    tenc = frustum.FrustumPositionEncoder(**kw)
    load_converted(tenc, variables)
    assert tenc.pe_conv1.weight.shape == (16 * hidden_mult, 24, 1, 1)
    with torch.no_grad():
        got = [a.numpy() for a in tenc(torch.from_numpy(intr), torch.from_numpy(extr), (4, 6),
                                       (64, 64))]
    assert got[0].shape == want[0].shape == (2, 3, 4, 6, 16)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5 * np.abs(want[0]).max(), rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL_M, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])
    assert want[2].any() and not want[2].all()
