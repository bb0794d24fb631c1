"""The port's losses, optimiser, reference jitter and synthetic data against
the JAX package's, on the CPU, from the same numpy inputs."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
from poem_v2_tpu_torch.geometry.camera import mano_to_openpose
from poem_v2_tpu_torch.mano.layer import ManoLayer
from poem_v2_tpu_torch.models.losses import poem_loss
from poem_v2_tpu_torch.models.poem import jitter_reference_joints
from poem_v2_tpu_torch.training.optim import Optimizer

LOSS_CFG = {"JOINTS_LOSS_TYPE": "l2", "VERTICES_LOSS_TYPE": "l1", "HEATMAP_JOINTS_WEIGHT": 10.0,
            "JOINTS_LOSS_WEIGHT": 1.0, "VERTICES_LOSS_WEIGHT": 1.0,
            "JOINTS_2D_LOSS_WEIGHT": 1.0, "VERTICES_2D_LOSS_WEIGHT": 0.5}


def _jax_batch(seed, B=2, V=3, size=64):
    from poem_v2_tpu.data.synthetic import SyntheticMultiviewDataset as JDataset

    return JDataset(batch_size=B, view_max=V, view_range=(1, V), image_size=size,
                    seed=seed).sample_batch()


@pytest.mark.parametrize("parametric", [False, True])
def test_poem_loss_terms_match_jax(parametric):
    """Every loss term, float32, against poem_loss on predictions that are the
    batch's ground truth plus noise (2D terms large enough to hit the clamp)."""
    from poem_v2_tpu.mano.layer import ManoLayer as JLayer
    from poem_v2_tpu.models.losses import poem_loss as jloss

    batch = _jax_batch(3)
    rs = np.random.RandomState(0)
    B, V = batch["view_mask"].shape
    gt = np.concatenate([batch["master_joints_3d"], batch["master_verts_3d"]], 1)
    preds = {
        "all_coords_preds": (gt[None] + 0.01 * rs.randn(2, *gt.shape)).astype(np.float32),
        "pred_joints_uv": (batch["target_joints_2d"]
                           + 40 * rs.randn(B, V, 21, 2)).astype(np.float32),
        "pred_pose": rs.randn(B, 16, 3).astype(np.float32),
        "pred_shape": rs.randn(B, 10).astype(np.float32),
    }
    j_reg = np.asarray(JLayer().j_regressor)
    with jax.default_matmul_precision("highest"):
        want_total, want = jloss({k: jnp.asarray(v) for k, v in preds.items()},
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 jnp.asarray(j_reg), LOSS_CFG, parametric=parametric)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    total, got = poem_loss({k: torch.from_numpy(v) for k, v in preds.items()}, tb,
                           ManoLayer().j_regressor, LOSS_CFG, parametric=parametric)
    assert set(got) == set(want)
    for k in want:  # float32 sums in other orders: 1e-5 relative
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)


def test_mano_to_openpose_matches_jax():
    from poem_v2_tpu.geometry.camera import mano_to_openpose as jm2o
    from poem_v2_tpu.mano.layer import ManoLayer as JLayer

    verts = np.random.RandomState(1).randn(2, 778, 3).astype(np.float32)
    want = jm2o(JLayer().j_regressor, jnp.asarray(verts))
    got = mano_to_openpose(ManoLayer().j_regressor, torch.from_numpy(verts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _jax_tx(train_cfg, steps_per_epoch):
    from poem_v2_tpu.training.optim import build_optimizer
    from poem_v2_tpu.utils.config import Config

    return build_optimizer(Config(copy.deepcopy(train_cfg)), steps_per_epoch)


BASE_TRAIN = {"OPTIMIZER": "adam", "LR": 1e-2, "SCHEDULER": "StepLR", "LR_DECAY_STEP": [2],
              "LR_DECAY_GAMMA": 0.1, "GRAD_CLIP_ENABLED": True,
              "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0}, "WEIGHT_DECAY": 0.0, "EPOCH": 3}


@pytest.mark.parametrize("change", [
    {},                                                        # adam, per-param clip, StepLR
    {"WEIGHT_DECAY": 0.05},                                    # adam + decay = adamw
    {"OPTIMIZER": "sgd", "MOMENTUM": 0.9},
    {"SCHEDULER": "cosine", "LR_MIN": 1e-3},
    {"GRAD_CLIP": {"TYPE": 2, "NORM": 1.0, "MODE": "global"}},
    {"GRAD_CLIP": {"TYPE": float("inf"), "NORM": 0.5}, "OPTIMIZER": "adamw",
     "WEIGHT_DECAY": 0.01},
])
def test_three_optimiser_steps_match_optax(change):
    """Three updates from the same gradients against build_optimizer's optax
    chain. With steps_per_epoch 1 the StepLR boundary at epoch 2 falls on the
    third update; the first tensor's gradient (norm ~ 18) is clipped, the
    second's (norm ~ 0.2) is not. Float32: 1e-6 relative to the parameters."""
    cfg = {**BASE_TRAIN, **change}
    rs = np.random.RandomState(5)
    params = [rs.randn(6, 7).astype(np.float32), rs.randn(5).astype(np.float32)]
    grads = [[(3.0 * rs.randn(6, 7)).astype(np.float32), (0.1 * rs.randn(5)).astype(np.float32)]
             for _ in range(3)]
    tx = _jax_tx(cfg, 1)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt = Optimizer(tp, cfg, steps_per_epoch=1)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    for p, q in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=0,
                                   atol=1e-6 * float(np.abs(np.asarray(q)).max()))


def test_reference_jitter_matches_jax_train_forward():
    """The train forward's reference jitter from the same three draws."""
    rs = np.random.RandomState(6)
    gt = rs.randn(2, 21, 3).astype(np.float32) * 0.05
    n1, n2, u = (rs.randn(2, 21, 3).astype(np.float32), rs.randn(1).astype(np.float32),
                 rs.rand(1).astype(np.float32))
    noise = 0.01 * (n1 + n2)
    ref = gt + noise
    root = ref[:, 0][:, None]
    want = (0.01 * (u * 2.0 - 1.0) + 1.0) * (ref - root) + root  # poem.py:86-97 in numpy
    got = jitter_reference_joints(torch.from_numpy(gt), tuple(map(torch.from_numpy, (n1, n2, u))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_match_jax(seed):
    """Two consecutive batches from the same seed: every draw equal, the MANO
    geometry to float32 skinning noise (1e-6 m), 2D joints to 1e-3 px."""
    from poem_v2_tpu.data.synthetic import SyntheticMultiviewDataset as JDataset

    kw = dict(batch_size=3, view_max=8, view_range=(1, 8), image_size=32, seed=seed)
    jd, td = JDataset(**kw), SyntheticMultiviewDataset(**kw)
    for _ in range(2):
        want, got = jd.sample_batch(), td.sample_batch()
        assert set(got) == set(want)
        for k in ("image", "view_mask", "cam_intr", "mano_pose", "mano_shape"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        for k, tol in (("master_joints_3d", 1e-6), ("master_verts_3d", 1e-6),
                       ("cam_extr", 1e-5), ("target_joints_2d", 1e-3)):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=tol, rtol=0,
                                       err_msg=k)
