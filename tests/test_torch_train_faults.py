"""Gradient accumulation and dropout seeding of the port's training, on the CPU.

``GRAD_ACCUM_STEPS`` is held call for call against the JAX
``build_optimizer`` chain, which wraps it in ``optax.MultiSteps``; the
Trainer's dropout is held to be a function of its seed.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import tiny_cfg

from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
from poem_v2_tpu_torch.models.poem import create_poem_model
from poem_v2_tpu_torch.training.optim import Optimizer
from poem_v2_tpu_torch.training.trainer import Trainer

BASE_TRAIN = {"OPTIMIZER": "adam", "LR": 1e-2, "SCHEDULER": "StepLR", "LR_DECAY_STEP": [1],
              "LR_DECAY_GAMMA": 0.1, "GRAD_CLIP_ENABLED": True,
              "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0}, "WEIGHT_DECAY": 0.0, "EPOCH": 3,
              "GRAD_ACCUM_STEPS": 2}


@pytest.mark.parametrize("change", [{}, {"OPTIMIZER": "sgd", "MOMENTUM": 0.9},
                                    {"GRAD_ACCUM_STEPS": 3, "WEIGHT_DECAY": 0.05}])
def test_grad_accumulation_matches_optax_multisteps(change):
    """Calls at k = GRAD_ACCUM_STEPS against build_optimizer's MultiSteps chain,
    parameters compared after every call: the k - 1 calls between updates leave
    them alone, the k-th applies clip + optimiser + schedule (a StepLR boundary
    at update 1) to the mean of the k gradients. Float32: 1e-6 of the parameters."""
    from poem_v2_tpu.training.optim import build_optimizer
    from poem_v2_tpu.utils.config import Config

    cfg = {**BASE_TRAIN, **change}
    k = cfg["GRAD_ACCUM_STEPS"]
    rs = np.random.RandomState(7)
    params = [rs.randn(6, 7).astype(np.float32), rs.randn(5).astype(np.float32)]
    grads = [[(3.0 * rs.randn(6, 7)).astype(np.float32), (0.1 * rs.randn(5)).astype(np.float32)]
             for _ in range(2 * k)]
    tx = build_optimizer(Config(copy.deepcopy(cfg)), 1)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt = Optimizer(tp, cfg, steps_per_epoch=1)
    for i, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        assert opt.count == (i + 1) // k
        for p, q, p0 in zip(tp, jp, params):
            q = np.asarray(q)
            np.testing.assert_allclose(p.detach().numpy(), q, rtol=0,
                                       atol=1e-6 * float(np.abs(q).max()))
            assert np.array_equal(q, p0) == ((i + 1) < k)  # untouched until the first update


def _losses(seed, global_seed, steps=2):
    cfg = tiny_cfg(norm="frozen_bn")
    cfg.HEAD.TRANSFORMER.DROPOUT = 0.3
    model, aux = create_poem_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, aux, cfg.TRAIN, cfg.LOSS, seed=seed)
    batch = SyntheticMultiviewDataset(batch_size=2, view_max=3, view_range=(1, 3), image_size=64,
                                      seed=2).sample_batch()
    torch.manual_seed(global_seed)  # what the caller's generators hold must not matter
    before = torch.get_rng_state()
    losses = [float(trainer.step(batch)["loss"]) for _ in range(steps)]
    assert torch.equal(torch.get_rng_state(), before)  # the step forks the global generator
    return losses


def test_trainer_dropout_is_a_function_of_its_seed():
    """Two Trainers of one seed read the same losses over two steps with
    dropout 0.3, whatever the global generators hold; another seed reads other
    losses."""
    a, b, c = _losses(1, 11), _losses(1, 22), _losses(2, 11)
    assert a == b
    assert a[0] != c[0] and a[1] != c[1]
