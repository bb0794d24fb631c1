"""The port's 2D pose models (``models/pose2d.py``) and the hourglass backbone
(``models/backbones/hourglass.py``) against the JAX package, on the CPU.

Both sides get the same seeded numpy inputs and the same weights (a flax tree
filled from a seed, through ``convert.py``); one torch thread, the JAX side
jitted. Tolerances: float32 modules 1e-4 of the output's largest magnitude;
``dark_decode`` 1e-9 (pixels, float64 host code); the blur 1e-12 of the map's
peak against OpenCV, where OpenCV imports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import fill_params, load_converted, one_thread_no_tf32

from poem_v2_tpu.utils.config import Config
from poem_v2_tpu_torch.convert import convert_leaf
from poem_v2_tpu_torch.models import pose2d
from poem_v2_tpu_torch.models.backbones import hourglass
from poem_v2_tpu_torch.utils.registry import BACKBONE, HEAD, MODEL

REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_no_tf32():
        yield


def _close(name, got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max(), err_msg=name)


def _init(module, *args, seed=0):
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(rng, *args))
    return fill_params(shapes, seed=seed, gain=0.5)


def test_registry_keys():
    assert MODEL.get("IntegralPose") is pose2d.create_integral_pose
    assert MODEL.get("DarkPose_ResNet") is pose2d.create_darkpose
    assert HEAD.get("IntegralDeconvHead") is pose2d.IntegralDeconvHead
    assert BACKBONE.get("HourglassBisected") is hourglass.HourglassBisected


@pytest.mark.parametrize("in_ch,out_ch,hw", [(8, 6, 5), (16, 16, 4)])
def test_conv_transpose_conversion(in_ch, out_ch, hw):
    """flax ConvTranspose(k 4, s 2, "SAME") == ConvTranspose2d(k 4, s 2, p 1) once
    ``convert.py`` flips the kernel in space; unflipped it is not."""
    import flax.linen as fnn

    rs = np.random.RandomState(in_ch)
    x = rs.randn(2, hw, hw, in_ch).astype(np.float32)
    kernel = rs.randn(4, 4, in_ch, out_ch).astype(np.float32)
    layer = fnn.ConvTranspose(out_ch, (4, 4), strides=(2, 2), padding="SAME", use_bias=False)
    want = np.asarray(jax.jit(layer.apply)({"params": {"kernel": jnp.asarray(kernel)}},
                                           jnp.asarray(x))).transpose(0, 3, 1, 2)
    w = convert_leaf(("head", "deconv0"), "kernel", kernel)
    assert w.shape == (in_ch, out_ch, 4, 4)
    np.testing.assert_array_equal(w, kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    deconv = torch.nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1, bias=False)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(w))
        got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close("deconv", got, want)
    unflipped = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    with torch.no_grad():
        wrong = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), unflipped, stride=2, padding=1)
    assert np.abs(wrong.numpy() - want).max() > 100 * REL * np.abs(want).max()
    # a conv kernel elsewhere keeps the OIHW rule
    assert convert_leaf(("head", "deconv0_norm"), "kernel", kernel).shape == (out_ch, in_ch, 4, 4)


@pytest.mark.parametrize("depth", [0, 4])
@pytest.mark.parametrize("norm_type", ["softmax", "sigmoid"])
def test_integral_deconv_head(depth, norm_type):
    from poem_v2_tpu.models.pose2d import IntegralDeconvHead as JHead

    kw = dict(num_joints=5, depth_resolution=depth, num_deconv=2, deconv_features=32,
              norm_type=norm_type)
    feat = np.random.RandomState(1).randn(2, 4, 4, 48).astype(np.float32)
    jhead = JHead(**kw)
    variables = _init(jhead, jnp.asarray(feat))
    want = jax.jit(jhead.apply)(variables, jnp.asarray(feat))
    thead = pose2d.IntegralDeconvHead(48, **kw).eval()
    load_converted(thead, variables)
    with torch.no_grad():
        got = thead(torch.from_numpy(feat))
    assert set(got) == set(want) == ({"uvd", "heatmap"} if depth else {"uv", "heatmap"})
    for key in want:
        _close(key, got[key], want[key])


POSE_CFG = {"BACKBONE": {"TYPE": "resnet18", "NORM": "gn"},
            "HEAD": {"TYPE": "IntegralDeconvHead", "NCLASSES": 21, "DEPTH_RESOLUTION": 0,
                     "NUM_DECONV": 2, "DECONV_FEATURES": 64, "NORM_TYPE": "softmax"}}


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(2).uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)


def test_integral_pose(image):
    from poem_v2_tpu.models.pose2d import create_integral_pose as jcreate

    jmodel = jcreate(Config(POSE_CFG))
    variables = _init(jmodel, jnp.asarray(image))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(image))
    tmodel = pose2d.create_integral_pose(POSE_CFG, device="cpu")
    load_converted(tmodel, variables)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(image))
    assert got["heatmap"].shape == (2, 21, 8, 8)
    for key in ("uv", "heatmap"):
        _close(key, got[key], want[key])


@pytest.fixture(scope="module")
def darkpose_heatmaps(image):
    """The JAX and the port's DarkPose heatmaps on the same weights and images."""
    from poem_v2_tpu.models.pose2d import create_darkpose as jcreate

    cfg = {"BACKBONE": {"TYPE": "resnet18", "NORM": "gn"}, "NCLASSES": 21}
    jmodel = jcreate(Config(cfg))
    variables = _init(jmodel, jnp.asarray(image), seed=3)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(image))["heatmap"])
    tmodel = pose2d.create_darkpose(cfg, device="cpu")
    load_converted(tmodel, variables)
    with one_thread_no_tf32(), torch.no_grad():
        got = tmodel(torch.from_numpy(image))["heatmap"]
    return got, want


def test_darkpose(darkpose_heatmaps):
    got, want = darkpose_heatmaps
    assert want.shape == (2, 21, 16, 16)
    _close("heatmap", got, want)


def test_joints_mse_loss():
    from poem_v2_tpu.models.pose2d import joints_mse_loss as jloss

    rs = np.random.RandomState(4)
    a, b = rs.rand(2, 21, 8, 8).astype(np.float32), rs.rand(2, 21, 8, 8).astype(np.float32)
    vis = (rs.rand(2, 21) > 0.3).astype(np.float32)
    for v in (None, vis):
        want = jloss(jnp.asarray(a), jnp.asarray(b), None if v is None else jnp.asarray(v))
        got = pose2d.joints_mse_loss(torch.from_numpy(a), torch.from_numpy(b),
                                     None if v is None else torch.from_numpy(v))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _gaussian_maps(seed, B=2, J=6, size=32):
    from poem_v2_tpu_torch.geometry.heatmap import gaussian_heatmap2d

    rs = np.random.RandomState(seed)
    uv = rs.uniform(0.15, 0.85, (B, J, 2)).astype(np.float32)
    uv[0, 0] = [0.01, 0.5]  # at the border: no refinement there
    hm = gaussian_heatmap2d(torch.from_numpy(uv), size, 2.0).numpy()
    return hm + 0.01 * rs.rand(*hm.shape).astype(np.float32), uv


@pytest.mark.parametrize("shape", [(32, 32), (16, 24), (7, 9)])
def test_blur_equals_opencv(shape):
    cv2 = pytest.importorskip("cv2")
    m = np.random.RandomState(5).rand(*shape)
    want = cv2.GaussianBlur(m, (11, 11), 0)
    got = pose2d.gaussian_blur_reflect101(m)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_dark_decode_equals_jax(darkpose_heatmaps):
    """With OpenCV present the JAX function blurs through it; the port never imports
    it. The same coordinates to 1e-9 px on Gaussian maps and on DarkPose's maps."""
    pytest.importorskip("cv2")
    from poem_v2_tpu.models.pose2d import dark_decode as jdecode

    hm, uv = _gaussian_maps(6)
    got = pose2d.dark_decode(torch.from_numpy(hm))
    np.testing.assert_allclose(got, jdecode(hm), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[1], uv[1] * 32, atol=0.35)  # sub-pixel, the blur's bias
    for maps in darkpose_heatmaps:
        maps = maps.numpy() if isinstance(maps, torch.Tensor) else maps
        np.testing.assert_allclose(pose2d.dark_decode(maps), jdecode(maps), rtol=0, atol=1e-9)


def test_upsample2x_equals_jax_image_resize():
    from poem_v2_tpu_torch.models.neck import upsample2x

    x = np.random.RandomState(7).randn(2, 3, 5, 7).astype(np.float32)
    want = jax.jit(lambda z: jax.image.resize(z, (2, 3, 10, 14), method="bilinear"))(
        jnp.asarray(x))
    _close("upsample2x", upsample2x(torch.from_numpy(x)), want)


def test_hourglass_bisected():
    from poem_v2_tpu.models.backbones.hourglass import HourglassBisected as JHG

    img = np.random.RandomState(8).uniform(-0.5, 0.5, (2, 32, 32, 3)).astype(np.float32)
    jmodel = JHG(features=32, depth=2)
    variables = _init(jmodel, jnp.asarray(img))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    tmodel = hourglass.HourglassBisected.from_config({"FEATURES": 32, "DEPTH": 2}).eval()
    load_converted(tmodel, variables)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img).permute(0, 3, 1, 2))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2, 32, 8, 8)
        _close(f"branch {i}", g.permute(0, 2, 3, 1), w)


def test_factories_target_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pose2d.create_integral_pose(POSE_CFG)
