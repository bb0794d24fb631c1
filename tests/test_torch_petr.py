"""The PETR baseline of the port against the JAX package, on the CPU.

Heads on feature inputs (no backbone): B2 of 3 views with view 2 of sample 1
padded, 4 x 4 maps of 32 channels, embed 32, 4 heads, 2 decoder layers, 64
queries, 8 depth bins; ``PETRHead`` and ``PETRHeadFTL`` in eval and in
training mode at dropout 0, and ``jax.grad`` against autograd of the summed
coordinates (every parameter and the input features). The whole model at
``tests/test_baselines.py``'s config (ResNet-18 GN, 64 px, embed 64, 2 levels,
799 queries). Same numpy inputs and flax parameters at gain 0.5 (converted by
``convert.py``), TF32 off, JAX at "highest" matmul precision.

Tolerances (float32 sums in other orders): coordinates 2e-5 m for the heads
and 1e-4 m for the whole model (the ResNet's GroupNorms before them); gradients
1e-4 of the largest gradient of the same tensor, plus 1e-6 of the global peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (PETR_HEAD_KW as KW, assert_grads_match, baseline_inputs,
                                fill_params, load_converted, one_thread_no_tf32,
                                petr_head_inputs as head_inputs)

from poem_v2_tpu_torch.models import petr
from poem_v2_tpu_torch.utils.registry import HEAD, MODEL, TRANSFORMER

HEAD_ATOL_M = 2e-5
MODEL_ATOL_M = 1e-4


@pytest.fixture(autouse=True)
def cpu_settings():
    with one_thread_no_tf32():
        yield


def _heads(ftl, dropout):
    from poem_v2_tpu.models.petr import PETRHead, PETRHeadFTL

    jcls, tcls = (PETRHeadFTL, petr.PETRHeadFTL) if ftl else (PETRHead, petr.PETRHead)
    kw = dict(KW, dropout=dropout)
    return jcls(**kw), tcls(**kw)


def _jax_variables(jhead, jargs):
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), *jargs, inp_res=(64, 64)))
    return fill_params(shapes, gain=0.5)


@pytest.mark.parametrize("ftl", [False, True], ids=["PETRHead", "PETRHeadFTL"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_dropout0"])
def test_head_matches_jax(ftl, train):
    args = head_inputs()
    jhead, thead = _heads(ftl, 0.0 if train else 0.1)
    jargs = [jnp.asarray(a) for a in args]
    variables = _jax_variables(jhead, jargs)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, *a: jhead.apply(
            v, *a, inp_res=(64, 64), deterministic=not train)["all_coords_preds"])(
                variables, *jargs))
    load_converted(thead, variables)
    thead.train(train)
    with torch.no_grad():
        got = thead(*(torch.from_numpy(a) for a in args), inp_res=(64, 64))["all_coords_preds"]
    assert got.shape == want.shape == (2, 2, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=HEAD_ATOL_M, rtol=0)
    assert hasattr(thead, "ftl") == ftl and hasattr(thead, "position_encoder") == (not ftl)


@pytest.mark.parametrize("ftl", [False, True], ids=["PETRHead", "PETRHeadFTL"])
def test_head_gradients_match_jax(ftl):
    """d(sum of every level's coordinates) / d(parameters, features): the key mask
    and the FTL's camera algebra in the backward."""
    args = head_inputs(1)
    jhead, thead = _heads(ftl, 0.0)
    jargs = [jnp.asarray(a) for a in args]
    variables = _jax_variables(jhead, jargs)

    def loss(params, feat):
        out = jhead.apply({"params": params}, feat, *jargs[1:], inp_res=(64, 64))
        return out["all_coords_preds"].sum()

    with jax.default_matmul_precision("highest"):
        g_params, g_feat = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jargs[0])
    load_converted(thead, variables)
    thead.train()
    feat = torch.from_numpy(args[0]).requires_grad_()
    thead(feat, *(torch.from_numpy(a) for a in args[1:]), inp_res=(64, 64))[
        "all_coords_preds"].sum().backward()
    assert_grads_match(g_params, thead, [("features", feat.grad.numpy(), np.asarray(g_feat))])
    # the padded view's features take no gradient
    assert float(feat.grad[1, -1].abs().max()) == 0.0


def model_cfg():
    return {
        "TYPE": "PETRMultiView",
        "BACKBONE": {"TYPE": "resnet18", "NORM": "gn"},
        "HEAD": {"TYPE": "PETRHead", "EMBED_DIMS": 64, "IN_CHANNELS": 256, "NUM_QUERY": 799,
                 "NUM_PREDS": 2, "NUM_REG_FCS": 2, "DEPTH_NUM": 8, "DEPTH_START": 0.0,
                 "DEPTH_END": 1.2, "LID": False,
                 "POSITION_RANGE": [-0.6, -0.6, 0.0, 0.6, 0.6, 1.2],
                 "POSITIONAL_ENCODING": {"NUM_FEATS": 32, "NORMALIZE": True}},
        "DATA_PRESET": {"CENTER_IDX": 0, "NUM_JOINTS": 21},
    }


def test_whole_model_matches_jax():
    """``create_petr_model`` against the JAX factory's model on one batch; the
    port's outputs as tests/test_baselines.py asserts them for JAX."""
    from poem_v2_tpu.models.petr import create_petr_model as jax_create
    from poem_v2_tpu.utils.config import Config

    cfg = model_cfg()
    jmodel, _ = jax_create(Config(cfg))
    args = baseline_inputs()
    jargs = [jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *jargs))
    variables = fill_params(shapes, gain=0.5)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a))(variables, *jargs)
    model, aux = petr.create_petr_model(cfg, device="cpu")
    load_converted(model, variables)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    for key in ("all_coords_preds", "pred_joints_3d", "pred_verts_3d", "pred_joints_3d_rel"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=MODEL_ATOL_M,
                                   rtol=0, err_msg=key)
    coords = got["all_coords_preds"]
    assert coords.shape == (2, 2, 799, 3) and torch.isfinite(got["pred_verts_3d"]).all()
    assert coords[..., 2].min() >= 0.0 and coords[..., 2].max() <= 1.2
    assert aux["mano_layer"].center_idx is None


def test_factory_builds_petr_head_whatever_head_type_says():
    """The JAX factory's quirk, kept: ``HEAD.TYPE: PETRHead_FTL`` still builds a
    PETRHead; the registries hold the FTL head for direct construction."""
    cfg = model_cfg()
    cfg["HEAD"]["TYPE"] = "PETRHead_FTL"
    model, _ = petr.create_petr_model(cfg, device="cpu")
    assert type(model.head) is petr.PETRHead and not model.training
    assert MODEL.get("PETRMultiView") is petr.create_petr_model
    assert HEAD.get("PETRHead_FTL") is petr.PETRHeadFTL and HEAD.get("PETRHead") is petr.PETRHead
    assert TRANSFORMER.get("PETRTransformer") is petr.PETRTransformer


def test_factory_targets_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        petr.create_petr_model(model_cfg())
