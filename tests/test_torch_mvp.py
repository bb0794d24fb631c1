"""The MVP baseline of the port against the JAX package, on the CPU.

``get_camera_rays``; ``MVPHead`` on feature inputs (three levels of 2 x 2 x 32,
4 x 4 x 24 and 8 x 8 x 16, B2 of 3 views with view 2 of sample 1 padded,
embed 32, 4 heads, 2 points, 2 layers, ``bn`` delayers with running
statistics) in eval and in training mode at dropout 0; ``jax.vjp`` against
autograd of the summed coordinates (parameters and features: the key-free
self-attention, the full ``inv`` of the extrinsics and the detached reference
joints); the batch-global normalisation of the reference pixels, which makes
the output depend on a padded view's camera, in both packages alike; and the
whole model at ``tests/test_aux_models.py``'s config (ResNet-18 GN, 64 px,
embed 32, 2 layers). Same numpy inputs and flax parameters at gain 0.5
(converted by ``convert.py``), TF32 off, JAX at "highest" matmul precision.

Tolerances (float32 sums in other orders): rays 1e-6; coordinates 2e-5 m for
the head and 1e-4 m for the whole model; MANO parameters 1e-4; gradients 1e-4
of the largest gradient of the same tensor, plus 1e-6 of the global peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (MVP_HEAD_KW as KW, MVP_LEVELS as LEVELS,
                                assert_grads_match, baseline_inputs, fill_params,
                                load_converted, look_at_cameras,
                                mvp_head_inputs as head_inputs, one_thread_no_tf32)

from poem_v2_tpu_torch.mano.layer import ManoLayer
from poem_v2_tpu_torch.models import mvp
from poem_v2_tpu_torch.utils.registry import HEAD, MODEL

HEAD_ATOL_M = 2e-5
MODEL_ATOL_M = 1e-4
MANO_ATOL = 1e-4


@pytest.fixture(autouse=True)
def cpu_settings():
    with one_thread_no_tf32():
        yield


def _heads(dropout, V=3):
    from poem_v2_tpu.mano import ManoLayer as JaxMano
    from poem_v2_tpu.models.mvp import MVPHead

    kw = dict(KW, dropout=dropout)
    jhead = MVPHead(**kw, mano_layer=JaxMano(center_idx=0))
    thead = mvp.MVPHead(**kw, mano_layer=ManoLayer(center_idx=0),
                        in_channels=tuple(c for _, c in LEVELS[::-1]), num_views=V)
    return jhead, thead


def _jax_head_run(jhead, feats, mask, intr, extr, variables=None):
    jargs = ([jnp.asarray(f) for f in feats], jnp.asarray(mask), jnp.asarray(intr),
             jnp.asarray(extr))
    if variables is None:
        shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), *jargs))
        variables = fill_params(shapes, gain=0.5)
    if id(jhead) not in _JITTED:  # the head is kept with its function: its id stays its own
        _JITTED[id(jhead)] = jhead, jax.jit(jhead.apply)
    with jax.default_matmul_precision("highest"):
        out = _JITTED[id(jhead)][1](variables, *jargs)
    return variables, {k: np.asarray(v) for k, v in out.items()}


_JITTED = {}


def _torch_head_run(thead, feats, mask, intr, extr):
    with torch.no_grad():
        out = thead([torch.from_numpy(f) for f in feats], torch.from_numpy(mask),
                    torch.from_numpy(intr), torch.from_numpy(extr))
    return {k: v.numpy() for k, v in out.items()}


def _hold(got, want, atol_m=HEAD_ATOL_M):
    assert got["all_coords_preds"].shape == want["all_coords_preds"].shape
    np.testing.assert_allclose(got["all_coords_preds"], want["all_coords_preds"], atol=atol_m,
                               rtol=0, err_msg="all_coords_preds")
    np.testing.assert_allclose(got["mano_pose_shape"], want["mano_pose_shape"], atol=MANO_ATOL,
                               rtol=0, err_msg="mano_pose_shape")


def test_camera_rays_match_jax():
    from poem_v2_tpu.models.mvp import get_camera_rays as jax_rays

    rs = np.random.RandomState(5)
    intr, extr = look_at_cameras(rs, 2, 3, 64)
    for H, W in ((4, 4), (8, 6)):
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jax_rays((64, 64), H, W, jnp.asarray(intr), jnp.asarray(extr)))
        got = mvp.get_camera_rays((64, 64), H, W, torch.from_numpy(intr), torch.from_numpy(extr))
        assert got.shape == want.shape == (2, 3, H, W, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_offset_bias_is_the_flax_initialiser():
    from poem_v2_tpu.models.mvp import _offset_bias_init

    want = np.asarray(_offset_bias_init(8, 1, 4)(None, (64,)))
    np.testing.assert_array_equal(mvp.offset_bias(8, 4), want)
    attn = mvp.ProjAttn(32, 8, 4)
    attn.reset_offsets()
    assert not attn.sampling_offsets.weight.detach().any()
    np.testing.assert_array_equal(attn.sampling_offsets.bias.detach().numpy(), want)


@pytest.fixture(scope="module")
def eval_heads():
    """Both heads at dropout 0.1 in eval with one set of filled parameters, and the
    JAX output on ``head_inputs()``."""
    args = head_inputs()
    jhead, thead = _heads(0.1)
    variables, want = _jax_head_run(jhead, *args)
    load_converted(thead, variables)
    return jhead, thead.eval(), variables, args, want


def test_head_matches_jax(eval_heads):
    """Eval; training mode at dropout 0 is held in the gradient test below."""
    _, thead, _, args, want = eval_heads
    got = _torch_head_run(thead, *args)
    assert got["all_coords_preds"].shape == (2, 2, 799, 3)
    _hold(got, want)
    norms = [m for m in thead.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(m.eps == 1e-5 for m in norms)


def test_padded_view_cameras_move_the_output_in_both_packages(eval_heads):
    """The reference pixels are divided by their maximum over the whole batch,
    padded views included: a padded view whose camera projects farther out
    changes every sample's output, the same way in both packages."""
    jhead, thead, variables, (feats, mask, intr, extr), want = eval_heads
    intr2 = intr.copy()
    intr2[1, -1, :2, 2] += 500.0  # the padded view's pixels become the batch's largest
    _, want2 = _jax_head_run(jhead, feats, mask, intr2, extr, variables)
    got2 = _torch_head_run(thead, feats, mask, intr2, extr)
    _hold(got2, want2)
    moved = np.abs(want2["all_coords_preds"] - want["all_coords_preds"])[:, 0].max()
    assert moved > 1e-4  # sample 0 has no padded view, and moved all the same


def test_head_gradients_match_jax():
    """Training mode at dropout 0: the forward, and d(sum of every level's
    coordinates) / d(parameters, the three feature levels); the detached reference
    joints leave the projection out of it."""
    feats, mask, intr, extr = head_inputs(3)
    jhead, thead = _heads(0.0)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), [
        jnp.asarray(f) for f in feats], *(jnp.asarray(a) for a in (mask, intr, extr))))
    variables = fill_params(shapes, gain=0.5)
    rest = (jnp.asarray(mask), jnp.asarray(intr), jnp.asarray(extr))

    def forward_and_grads(params, fs):
        out, vjp = jax.vjp(lambda p, f: jhead.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, f, *rest,
            deterministic=False)["all_coords_preds"], params, fs)
        return out, vjp(jnp.ones_like(out))

    with jax.default_matmul_precision("highest"):
        want, (g_params, g_feats) = jax.jit(forward_and_grads)(
            variables["params"], [jnp.asarray(f) for f in feats])
    load_converted(thead, variables)
    thead.train()
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    got = thead(tf, *(torch.from_numpy(a) for a in (mask, intr, extr)))["all_coords_preds"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEAD_ATOL_M, rtol=0)
    got.sum().backward()
    assert_grads_match(g_params, thead, [(f"features {i}", t.grad.numpy(), np.asarray(g))
                                         for i, (t, g) in enumerate(zip(tf, g_feats))])


def test_unsupported_options_raise():
    with pytest.raises(NotImplementedError, match="num_feature_levels"):
        mvp.ProjAttn(32, 4, 2, lin_levels=2)
    with pytest.raises(NotImplementedError, match="PCA"):
        mvp.MVPHead(mano_pose_ncomps=15)


def model_cfg():
    return {"BACKBONE": {"TYPE": "resnet18", "NORM": "gn"},
            "HEAD": {"TYPE": "MVPHead", "EMBED_DIMS": 32, "NUM_PREDS": 2, "NUM_POINTS": 2,
                     "CAMERA_NUM": 3},
            "DATA_PRESET": {"CENTER_IDX": 0, "NUM_JOINTS": 21}}


def test_whole_model_matches_jax():
    """``create_mvp_model`` against the JAX factory's model on one batch, with the
    port's outputs as tests/test_aux_models.py asserts them for JAX."""
    from poem_v2_tpu.models.mvp import create_mvp_model as jax_create
    from poem_v2_tpu.utils.config import Config

    cfg = model_cfg()
    jmodel, _ = jax_create(Config(cfg))
    args = baseline_inputs(4)
    jargs = [jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *jargs))
    variables = fill_params(shapes, gain=0.5)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a))(variables, *jargs)
    model, aux = mvp.create_mvp_model(cfg, device="cpu")
    load_converted(model, variables)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    for key in ("all_coords_preds", "pred_joints_3d", "pred_verts_3d", "pred_verts_3d_rel"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=MODEL_ATOL_M,
                                   rtol=0, err_msg=key)
    for key in ("pred_pose", "pred_shape"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=MANO_ATOL,
                                   rtol=0, err_msg=key)
    assert got["pred_verts_3d"].shape == (2, 778, 3) and got["pred_pose"].shape == (2, 16, 3)
    assert torch.isfinite(got["pred_verts_3d"]).all() and not model.training
    assert MODEL.get("MVP") is mvp.create_mvp_model and HEAD.get("MVPHead") is mvp.MVPHead
    assert aux["mano_layer"].center_idx is None


def test_factory_starts_offsets_at_the_compass_bias_and_targets_the_card(monkeypatch):
    model, _ = mvp.create_mvp_model(model_cfg(), device="cpu")
    want = torch.from_numpy(mvp.offset_bias(8, 2))
    for i in range(2):
        attn = getattr(model.head, f"layer_{i}").proj_attn
        assert torch.equal(attn.sampling_offsets.bias, want)
        assert not attn.attention_weights.weight.detach().any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mvp.create_mvp_model(model_cfg())


def test_mano_constants_first_copied_in_inference_mode_serve_a_later_backward():
    """The MANO layer copies its constants to a device once. A copy first made under
    ``inference_mode`` (an eval forward on the card) was an inference tensor, and
    a later training forward through the layer (MVP's per-layer surface) failed in
    autograd. The meta device stands in for the card: a CPU tensor is not copied
    to the CPU."""
    layer = ManoLayer(center_idx=0)
    with torch.inference_mode():
        layer(torch.zeros(1, 48, device="meta"), torch.zeros(1, 10, device="meta"))
    pose = torch.zeros(1, 48, device="meta", requires_grad=True)
    layer(pose, torch.zeros(1, 10, device="meta")).verts.sum().backward()
    assert pose.grad is not None and pose.grad.shape == (1, 48)
