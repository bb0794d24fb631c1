"""The port's ResNet backbones and ResNet necks against their flax counterparts on the CPU.

Parameters come from ``jax.eval_shape`` filled by numpy (gain 0.5), converted
by ``poem_v2_tpu_torch.convert``; the port takes NCHW, so the tests transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (fill_params, flax_model_shapes, load_converted,
                                zeros_like_shapes)

from poem_v2_tpu_torch.convert import flax_to_state_dict
from poem_v2_tpu_torch.models.backbones.resnet import ResNet
from poem_v2_tpu_torch.models.neck import ResNetFeatNeck, UVDecodeNeck
from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create

# float32 on both sides, sums in other orders through up to ~50 conv + norm
# layers: bound relative to each output's peak, as for HRNet
REL = 1e-4

DEPTHS = ("resnet18", "resnet34", "resnet50")


def _nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def _jax_run(module, *args):
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *jargs))
    variables = fill_params(shapes, gain=0.5)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(module.apply)(variables, *jargs)
    return variables, jax.tree_util.tree_map(np.asarray, out)


def _torch_run(module, variables, *args):
    load_converted(module, variables)
    module.eval()
    with torch.no_grad():
        return module(*args)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


@pytest.mark.parametrize("norm", ["gn", "frozen_bn", "bn"])
@pytest.mark.parametrize("arch", DEPTHS)
def test_resnet_pyramid(arch, norm):
    from poem_v2_tpu.models.backbones.resnet import ResNet as JResNet

    img = np.random.RandomState(0).uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
    variables, want = _jax_run(JResNet(arch=arch, norm=norm), img)
    model = ResNet(arch=arch, norm=norm)
    got = _torch_run(model, variables, torch.from_numpy(_nchw(img)))
    assert set(got) == set(want)
    assert model.feat_size == JResNet(arch=arch).feat_size
    for key in ("res_layer1", "res_layer2", "res_layer3", "res_layer4"):
        _close(got[key].permute(0, 2, 3, 1), want[key])
    _close(got["res_layer4_mean"], want["res_layer4_mean"])


@pytest.mark.parametrize("cfg,want", [
    ({"TYPE": "resnet50", "NORM": "bn"}, ("resnet50", "bn")),
    ({"TYPE": "ResNet18", "FREEZE_BATCHNORM": True, "NORM": "gn"}, ("resnet18", "frozen_bn")),
    ({"TYPE": "HRNet"}, ("resnet34", "gn")),
])
def test_resnet_from_config(cfg, want):
    from poem_v2_tpu.models.backbones.resnet import ResNet as JResNet
    from poem_v2_tpu.utils.config import Config

    j = JResNet.from_config(Config(cfg))
    assert (j.arch, j.norm) == want
    model = ResNet.from_config(cfg)
    assert model.arch == want[0]
    norm_type = type(model.stem_norm).__name__
    assert norm_type == {"gn": "GroupNorm", "frozen_bn": "FrozenBatchNorm",
                         "bn": "RunningBatchNorm"}[want[1]]


def test_bn_stays_on_running_statistics_in_train_mode():
    """flax's BatchNorm uses ``use_running_average=True`` always: train() changes nothing."""
    model = ResNet("resnet18", norm="bn")
    for m in model.modules():
        if hasattr(m, "running_var"):
            with torch.no_grad():
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.randn(2, 3, 64, 64)
    model.eval()
    with torch.no_grad():
        want = model(x)["res_layer4"]
    model.train()
    with torch.no_grad():
        got = model(x)["res_layer4"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_frozen_bn_statistics_are_trained():
    """The JAX FrozenBatchNorm keeps mean / var in ``params`` and its optimiser
    masks nothing: the port's statistics are parameters with gradients."""
    model = ResNet("resnet18", norm="frozen_bn")
    names = {n for n, _ in model.named_parameters()}
    assert {"stem_norm.running_mean", "stem_norm.running_var"} <= names
    model(torch.randn(1, 3, 64, 64))["res_layer4_mean"].sum().backward()
    assert model.stem_norm.running_mean.grad.abs().max() > 0
    assert model.stem_norm.running_var.grad.abs().max() > 0


def _pyramid(rs, widths, size=16):
    """res_layer1 .. 4 at strides 1, 2, 4, 8 of ``size``, NHWC; widths finest first."""
    return [rs.randn(2, size >> i, size >> i, c).astype(np.float32)
            for i, c in enumerate(widths)]


@pytest.mark.parametrize("feat_size", [(64, 32, 16, 8), (512, 256, 128, 64)])
def test_resnet_feat_neck(feat_size):
    from poem_v2_tpu.models.neck import ResNetFeatNeck as J

    feats = _pyramid(np.random.RandomState(1), tuple(reversed(feat_size)))
    variables, want = _jax_run(J(feat_size=feat_size), feats)
    got = _torch_run(ResNetFeatNeck(feat_size), variables,
                     [torch.from_numpy(_nchw(f)) for f in feats])
    assert got.shape[1] == feat_size[2]
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("feat_size", [(64, 32, 16, 8), (512, 256, 128, 64)])
def test_uv_decode_neck_resnet(feat_size):
    from poem_v2_tpu.models.neck import UVDecodeNeck as J

    feats = _pyramid(np.random.RandomState(2), tuple(reversed(feat_size)))
    variables, (hmap, uv_feat) = _jax_run(J(feat_size=feat_size, hrnet=False), feats)
    neck = UVDecodeNeck(feat_size, hrnet=False)
    got = _torch_run(neck, variables, [torch.from_numpy(_nchw(f)) for f in feats])
    _close(got.permute(0, 2, 3, 1), hmap)
    with torch.no_grad():
        _close(neck.uv_feat(got).permute(0, 2, 3, 1), uv_feat)


@pytest.mark.parametrize("arch", DEPTHS)
def test_resnet_model_tree_maps_one_to_one(arch):
    """``convert.py``'s contract: every flax leaf of the POEMNet and every key
    of the port's state_dict matched once, with the same shapes."""
    from helpers import TINY_MODEL_CFG

    cfg = TINY_MODEL_CFG.clone()
    cfg.BACKBONE.TYPE = arch
    shapes = flax_model_shapes(cfg, 64)
    n_leaves = len(jax.tree_util.tree_leaves(shapes))
    sd = flax_to_state_dict(zeros_like_shapes(shapes))
    model, _ = torch_create(cfg.to_dict(), device="cpu")
    tsd = model.state_dict()
    assert len(sd) == n_leaves == len(tsd)
    assert set(sd) == set(tsd), (sorted(set(sd) - set(tsd))[:5], sorted(set(tsd) - set(sd))[:5])
    for k, v in sd.items():
        assert tuple(tsd[k].shape) == v.shape, k
