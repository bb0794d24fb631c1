"""The port's whole train step against the JAX ``make_train_step`` math, on the CPU.

One step of the tiny HRNet POEM (``tiny_cfg``: width 8, embed 32, 256 BPS
points, 2 decoder blocks, K=8) on a synthetic batch whose samples use 3
and 1 of 3 views, with DROPOUT 0 on both sides. The backbone norm is
``frozen_bn``: flax's GroupNorm takes the variance as E[x^2] - E[x]^2
(``use_fast_variance``), and at these widths its float32 backward is off
the float64 one by up to 1e-2 of the largest gradient (measured on the
HRNet alone; torch's GroupNorm stays within 2e-6 at width 40), which would
swamp a 1e-4 comparison of the rest. Both FrozenBatchNorms keep their
statistics as parameters, which take gradients and Adam updates, and the
comparisons run over all of the port's parameters, those included. The JAX side runs the TPU
training path (``use_flash=True``: K3 + its Pallas backward, K6, K7) with
its Pallas kernels in interpret mode and ``remat=False`` (remat does not
change gradients, tests/test_model.py); the port runs its plain versions
with remat on. The port is fed the JAX reference-jitter draws. The JAX
value_and_grad costs about a minute on the CPU, so one module-scoped
fixture computes it once for every test here.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import fill_params, load_converted, pallas_interpret, tiny_cfg

from poem_v2_tpu_torch.convert import flax_to_state_dict
from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create
from poem_v2_tpu_torch.training.optim import Optimizer
from poem_v2_tpu_torch.training.trainer import Trainer, make_train_step

STEPS_PER_EPOCH = 100
# float32 on both sides through a 2-block decoder and an HRNet backward,
# summed in other orders: loss terms agree to ~1e-7 relative, gradients to
# ~1e-6 of each module's largest
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


class _RefDraws(fnn.Module):
    """The draws POEMNet's train forward takes: the first ``make_rng("noise")``
    of a top-level module, split in three (poem_v2_tpu/models/poem.py:86-97)."""

    @fnn.compact
    def __call__(self, batch):
        k1, k2, k3 = jax.random.split(self.make_rng("noise"), 3)
        return (jax.random.normal(k1, (batch, 21, 3)), jax.random.normal(k2, (1,)),
                jax.random.uniform(k3, (1,)))


def _cfg(parametric=False):
    cfg = tiny_cfg(norm="frozen_bn")
    cfg.HEAD.TRANSFORMER.DROPOUT = 0.0
    if parametric:
        cfg.HEAD.TRANSFORMER.PARAMETRIC_OUTPUT = True
        cfg.HEAD.TRANSFORMER.TRANSFORMER_CENTER_IDX = 9
        cfg.LOSS.POSE_LOSS_WEIGHT = 0.001
        cfg.LOSS.SHAPE_LOSS_WEIGHT = 0.0005
    return cfg


def _run_jax_step(cfg, tweak_params=None):
    """One JAX value_and_grad + optimiser update of ``cfg``'s model on the
    fixed batch; ``tweak_params(params)`` edits the filled parameters first."""
    from poem_v2_tpu.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu.models.losses import poem_loss
    from poem_v2_tpu.models.poem import create_poem_model
    from poem_v2_tpu.training.optim import build_optimizer

    batch = SyntheticMultiviewDataset(batch_size=2, view_max=3, view_range=(1, 3),
                                      image_size=64, seed=2).sample_batch()
    assert sorted(batch["view_mask"].sum(1)) == [1, 3]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model, aux = create_poem_model(cfg, use_flash=True, remat=False)
    rng = jax.random.PRNGKey(0)
    args = (jb["image"], jb["view_mask"], jb["cam_intr"], jb["cam_extr"], jb["master_joints_3d"])
    shapes = jax.eval_shape(lambda: model.init(
        {"params": rng, "noise": rng, "dropout": rng}, *args, train=False))
    variables = fill_params(shapes, gain=0.5)
    if tweak_params is not None:
        tweak_params(variables["params"])
    _, noise_rng, drop_rng = jax.random.split(jax.random.PRNGKey(1), 3)
    draws = _RefDraws().apply({}, 2, rngs={"noise": noise_rng})
    j_reg = aux["mano_layer"].j_regressor

    def compute(params):
        preds = model.apply({"params": params}, *args, train=True,
                            rngs={"noise": noise_rng, "dropout": drop_rng})
        loss, loss_dict = poem_loss(preds, jb, j_regressor=j_reg, loss_cfg=cfg.LOSS,
                                    transformer_center_idx=aux["transformer_center_idx"],
                                    parametric=aux.get("parametric_output", False))
        return loss, (loss_dict, preds["pred_ref_joints_3d"])

    with pallas_interpret(), jax.default_matmul_precision("highest"):
        (loss, (loss_dict, ref_joints)), grads = jax.jit(
            jax.value_and_grad(compute, has_aux=True))(variables["params"])
    tx = build_optimizer(cfg.TRAIN, STEPS_PER_EPOCH)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(cfg=cfg, batch=batch, variables=variables, draws=to_np(draws),
                loss=float(loss), loss_dict=to_np(loss_dict), ref_joints=np.asarray(ref_joints),
                grads=flax_to_state_dict({"params": to_np(grads)}),
                new_params=flax_to_state_dict({"params": to_np(new_params)}))


@pytest.fixture(scope="module")
def jax_step():
    return _run_jax_step(_cfg())


def _run_torch_step(jax_step):
    cfg = jax_step["cfg"]
    model, aux = torch_create(cfg, device="cpu")
    load_converted(model, jax_step["variables"])
    optimizer = Optimizer(model.parameters(), cfg.TRAIN, STEPS_PER_EPOCH)
    trainer = Trainer(model, aux, cfg.TRAIN, cfg.LOSS)
    step = make_train_step(model, trainer.loss_fn, optimizer)
    batch = trainer.to_device(jax_step["batch"])
    draws = tuple(torch.from_numpy(d) for d in jax_step["draws"])
    grads = {}
    hook = {n: p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
            for n, p in model.named_parameters()}
    metrics = step(batch, draws)
    for h in hook.values():
        h.remove()
    return dict(model=model, metrics=metrics, grads=grads,
                names=[n for n, _ in model.named_parameters()])


@pytest.fixture(scope="module")
def torch_step(jax_step):
    return _run_torch_step(jax_step)


def test_reference_draws_reproduce_the_jax_jitter(jax_step):
    """The draws fed to the port are the ones the JAX train forward took."""
    from poem_v2_tpu_torch.models.poem import jitter_reference_joints

    got = jitter_reference_joints(torch.from_numpy(jax_step["batch"]["master_joints_3d"]),
                                  tuple(torch.from_numpy(d) for d in jax_step["draws"]))
    np.testing.assert_allclose(got.numpy(), jax_step["ref_joints"], atol=1e-7, rtol=0)


def test_train_step_loss_terms_match_jax(jax_step, torch_step):
    _check_loss_terms(jax_step, torch_step)


def _check_loss_terms(jax_step, torch_step):
    metrics = torch_step["metrics"]
    assert set(metrics) == set(jax_step["loss_dict"]) | {"grad_norm"}
    for k, want in jax_step["loss_dict"].items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["loss"], rtol=LOSS_RTOL)
    want_norm = np.sqrt(sum(float((jax_step["grads"][n].astype(np.float64) ** 2).sum())
                            for n in torch_step["names"]))
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-4)


def _module(key):
    """Group of a parameter: backbone, each neck, each decoder block, the rest of the head."""
    parts = key.split(".")
    if parts[0] == "head" and parts[1] == "transformer":
        return ".".join(parts[:3])
    return parts[0]


def test_train_step_gradients_match_jax(jax_step, torch_step):
    """Every parameter's gradient (zeros where one side has none), per module:
    max |port - JAX| <= 1e-4 x the module's max |JAX gradient|."""
    _check_gradients(jax_step, torch_step)


def _check_gradients(jax_step, torch_step):
    got = torch_step["grads"]
    assert set(torch_step["names"]) <= set(jax_step["grads"])
    groups = {}
    for key in torch_step["names"]:
        w = jax_step["grads"][key]
        g = got[key].numpy() if key in got else np.zeros_like(w)
        err, scale = groups.get(_module(key), (0.0, 0.0))
        groups[_module(key)] = (max(err, float(np.abs(g - w).max())),
                                max(scale, float(np.abs(w).max())))
    assert len(groups) == 6  # backbone, feat_neck, uv_neck, head, 2 decoder blocks
    for name, (err, scale) in groups.items():
        assert scale > 0 and err <= GRAD_REL * scale, f"{name}: {err:.3e} vs max {scale:.3e}"


def test_train_step_updated_params_match_jax(jax_step, torch_step):
    """The parameters after the clip + Adam update. Adam's first update is
    -lr * g / (|g| + eps), +-lr wherever |g| >> eps, so an element whose
    gradient is float32 noise on both sides (fc_gamma's output bias has an
    exact gradient of 0) may move either way: elements whose JAX gradient
    exceeds 1e-3 of its tensor's largest take the same update to 1e-3 of lr,
    plus 2 float32 ulps of the parameter (p - update rounds once on each
    side); all elements agree to 2 lr. Per module, the parameters agree to
    1e-4 of the module's largest (measured: 8.5e-7, the backbone; no
    element's update flipped sign)."""
    _check_updated_params(jax_step, torch_step)


def _check_updated_params(jax_step, torch_step, firm_floor=0.0):
    lr = jax_step["cfg"].TRAIN.LR
    params = dict(torch_step["model"].named_parameters())
    groups = {}
    for key, got in params.items():
        want = jax_step["new_params"][key]
        got = got.detach().numpy()
        g = np.abs(jax_step["grads"][key])
        firm = g > max(1e-3 * g.max(), firm_floor) if g.max() > 0 else np.zeros_like(g, bool)
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr * (1 + 1e-3), key
        lim = 1e-3 * lr + 2 * np.spacing(np.abs(want[firm]).astype(np.float32))
        assert (diff[firm] <= lim).all(), f"{key}: {(diff[firm] - lim).max():.3e} over"
        err, scale = groups.get(_module(key), (0.0, 0.0))
        groups[_module(key)] = (max(err, float(diff.max())), max(scale, float(np.abs(want).max())))
    for name, (err, scale) in groups.items():
        assert err <= GRAD_REL * scale, f"{name}: {err:.3e} vs max {scale:.3e}"


# ---- the parametric (MANO pose and shape) train step --------------------------

@pytest.fixture(scope="module")
def jax_step_mano():
    return _run_jax_step(_cfg(parametric=True))


@pytest.fixture(scope="module")
def torch_step_mano(jax_step_mano):
    return _run_torch_step(jax_step_mano)


def test_parametric_train_step_loss_terms_match_jax(jax_step_mano, torch_step_mano):
    """A tiny ``PARAMETRIC_OUTPUT`` model: the same step with the MANO surface as
    the last block's coordinates, root-relative vertices and the pose / shape
    terms, all to the same 1e-5 relative (measured <= 4.3e-7; ``loss_pose``
    6.3e-8: its 1.88 is dominated by rotations far from the small ground-truth
    pose, so the ~3e-4 rad the two packages differ by where a regressed 6D row is
    short moves it little)."""
    assert {"loss_pose", "loss_shape"} <= set(jax_step_mano["loss_dict"])
    assert float(jax_step_mano["loss_dict"]["loss_pose"]) > 0.1
    _check_loss_terms(jax_step_mano, torch_step_mano)


def test_parametric_train_step_gradients_match_jax(jax_step_mano, torch_step_mano):
    """Gradients per module to 1e-4 of the module's largest, through the float32
    6D -> axis-angle -> MANO chain; the leaves only this head has take gradients
    that are not 0, and each agrees to 1e-4 of its own largest (measured <=
    4.9e-5, ``flat_verts.bias``, one number; the rest <= 5.9e-6). The name map of
    ``convert.py`` is the optimiser's too: the JAX gradients and the JAX-updated
    parameters are carried across by it leaf by leaf."""
    _check_gradients(jax_step_mano, torch_step_mano)
    block = "head.transformer.block_1."
    for leaf in ("flat_verts.weight", "flat_verts.bias", "mano_linear.weight",
                 "mano_linear.bias"):
        want = jax_step_mano["grads"][block + leaf]
        got = torch_step_mano["grads"][block + leaf].numpy()
        assert got.shape == want.shape and np.abs(want).max() > 0, leaf
        assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max(), leaf
    # only the final block regresses the MANO parameters
    assert "head.transformer.block_0.mano_linear.weight" not in torch_step_mano["names"]


def test_parametric_train_step_updated_params_match_jax(jax_step_mano, torch_step_mano):
    """As the test above, with "firm" also meaning |g| > 1e-5, 1e3 x Adam's eps:
    a multi-head attention's key bias shifts all logits of a query alike, so its
    exact gradient is 0 and the whole tensor is float32 noise of the size of eps,
    where the update is a fraction of lr that follows the noise (here 2e-3 lr
    apart). ``flat_verts`` and ``mano_linear`` are held as every other leaf."""
    _check_updated_params(jax_step_mano, torch_step_mano, firm_floor=1e-5)
    firm = [np.abs(jax_step_mano["grads"]["head.transformer.block_1." + leaf]).max() > 1e-5
            for leaf in ("flat_verts.weight", "mano_linear.weight", "mano_linear.bias")]
    assert all(firm)


def test_float32_params_with_bfloat16_compute():
    """create_poem_model(dtype=bf16, param_dtype=f32): the train step keeps float32
    parameters and gradients, runs the decoder's attention in bfloat16, and
    returns finite metrics."""
    from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset

    cfg = _cfg()
    model, aux = torch_create(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                              device="cpu")
    trainer = Trainer(model, aux, cfg.TRAIN, cfg.LOSS)
    seen = []
    model.head.transformer.block_0.attn.register_forward_hook(
        lambda m, inp, out: seen.append(inp[0].dtype))
    batch = SyntheticMultiviewDataset(batch_size=2, view_max=3, view_range=(1, 3),
                                      image_size=64, seed=2).sample_batch()
    metrics = trainer.step(batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert seen and set(seen) == {torch.bfloat16}  # the forward and its remat recompute
    for p in model.parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
