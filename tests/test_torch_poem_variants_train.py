"""One train step of POEM's PtEmbedTRv3 and PETR_EMBEDDING variants, the port against the
JAX package on the CPU.

The tiny HRNet model (PtEmbedTRv3's METRO stage at small widths,
``small_metro_stage``) with ``frozen_bn`` and DROPOUT 0 on the fixed batch and
reference jitter draws of ``test_torch_train_step.py``, JAX with
``use_flash=False`` and the port with ``use_flash_train=False``: both train
through the einsum attention and gathered KNN neighbourhoods selected by full
float32 distances (the kernels' train path is the flagship's, held in
``test_torch_train_step.py``; the variants differ from it in the head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_poem_variants import VARIANTS, _variant, small_tiny_model  # noqa: F401
from test_torch_train_step import (GRAD_REL, STEPS_PER_EPOCH, _RefDraws, _cfg, _check_loss_terms,
                                   _check_updated_params, _module)
from torch_port_helpers import fill_params, load_converted

from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create
from poem_v2_tpu_torch.training.optim import Optimizer
from poem_v2_tpu_torch.training.trainer import Trainer, make_train_step


def _jax_step(cfg):
    """One JAX value_and_grad + optimiser update (``use_flash=False``, no remat) on
    ``test_torch_train_step.py``'s fixed batch, its parameters at gain 0.5."""
    from poem_v2_tpu.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu.models.losses import poem_loss
    from poem_v2_tpu.models.poem import create_poem_model as jax_create
    from poem_v2_tpu.training.optim import build_optimizer
    from poem_v2_tpu_torch.convert import flax_to_state_dict

    batch = SyntheticMultiviewDataset(batch_size=2, view_max=3, view_range=(1, 3),
                                      image_size=64, seed=2).sample_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model, aux = jax_create(cfg, use_flash=False, remat=False)
    rng = jax.random.PRNGKey(0)
    args = (jb["image"], jb["view_mask"], jb["cam_intr"], jb["cam_extr"], jb["master_joints_3d"])
    shapes = jax.eval_shape(lambda: model.init(
        {"params": rng, "noise": rng, "dropout": rng}, *args, train=False))
    variables = fill_params(shapes, gain=0.5)
    _, noise_rng, drop_rng = jax.random.split(jax.random.PRNGKey(1), 3)
    draws = _RefDraws().apply({}, 2, rngs={"noise": noise_rng})

    def compute(params):
        preds = model.apply({"params": params}, *args, train=True,
                            rngs={"noise": noise_rng, "dropout": drop_rng})
        loss, loss_dict = poem_loss(preds, jb, j_regressor=aux["mano_layer"].j_regressor,
                                    loss_cfg=cfg.LOSS,
                                    transformer_center_idx=aux["transformer_center_idx"],
                                    parametric=False)
        return loss, (loss_dict, preds["all_coords_preds"])

    tx = build_optimizer(cfg.TRAIN, STEPS_PER_EPOCH)

    def update(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    with jax.default_matmul_precision("highest"):
        (loss, (loss_dict, coords)), grads = jax.jit(
            jax.value_and_grad(compute, has_aux=True))(variables["params"])
        new_params = jax.jit(update)(variables["params"], grads)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(cfg=cfg, batch=batch, variables=variables, loss=float(loss),
                loss_dict=to_np(loss_dict), n_coords=coords.shape[0],
                draws=[np.asarray(d) for d in draws],
                grads=flax_to_state_dict({"params": to_np(grads)}),
                new_params=flax_to_state_dict({"params": to_np(new_params)}))


def _torch_step(jax_step):
    cfg = jax_step["cfg"]
    model, aux = torch_create(cfg, device="cpu", use_flash_train=False)
    load_converted(model, jax_step["variables"])
    optimizer = Optimizer(model.parameters(), cfg.TRAIN, STEPS_PER_EPOCH)
    trainer = Trainer(model, aux, cfg.TRAIN, cfg.LOSS)
    step = make_train_step(model, trainer.loss_fn, optimizer)
    grads, coords = {}, []
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    hooks.append(model.head.register_forward_hook(
        lambda m, i, out: coords.append(out["all_coords_preds"].shape[0])))
    metrics = step(trainer.to_device(jax_step["batch"]),
                   tuple(torch.from_numpy(d.copy()) for d in jax_step["draws"]))
    for h in hooks:
        h.remove()
    return dict(model=model, metrics=metrics, grads=grads, n_coords=coords[0],
                names=[n for n, _ in model.named_parameters()])


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_train_step_matches_jax(name):
    """Loss terms to 1e-5 relative, every gradient per module (the backbone, each
    neck, each decoder submodule, the rest of the head) to 1e-4 of the module's
    largest, the updated parameters as ``test_torch_train_step.py`` holds the
    parametric step's (about a minute each, XLA's compile of the JAX step)."""
    jax_step = _jax_step(_variant(_cfg(), name))
    torch_step = _torch_step(jax_step)
    assert torch_step["n_coords"] == jax_step["n_coords"] == (3 if name == "v3" else 2)
    _check_loss_terms(jax_step, torch_step)
    groups = {}
    for key in torch_step["names"]:
        want = jax_step["grads"][key]
        got = torch_step["grads"][key].numpy() if key in torch_step["grads"] else 0 * want
        err, scale = groups.get(_module(key), (0.0, 0.0))
        groups[_module(key)] = (max(err, float(np.abs(got - want).max())),
                                max(scale, float(np.abs(want).max())))
    want_groups = {"v3": {"head.transformer.metro_block_0", "head.transformer.merge_branch",
                          "head.transformer.point_transformer"},
                   "petr": {"head.transformer.block_0", "head.transformer.block_1"}}[name]
    assert want_groups <= set(groups)
    for group, (err, scale) in groups.items():
        assert scale > 0 and err <= GRAD_REL * scale, f"{group}: {err:.3e} vs max {scale:.3e}"
    if name == "petr":
        assert np.abs(jax_step["grads"]["head.position_encoder.pe_conv1.weight"]).max() > 0
    # firm: |g| also over 1e-5, 1e3 x Adam's eps: an attention's key bias shifts all
    # of a query's logits alike, so its exact gradient is 0 and the tensor float32
    # noise, whose update follows the noise (the parametric test's rule)
    _check_updated_params(jax_step, torch_step, firm_floor=1e-5)
