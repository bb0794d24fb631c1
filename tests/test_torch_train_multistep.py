"""Eight train steps of the parametric convergence gate's model, the port against the JAX
package on the CPU: what repeats across steps (Adam's moments and bias correction,
the learning-rate schedule, per-parameter clipping, the jitter draws).

``configs/synthetic_overfit_gate_mano.yaml``'s MODEL, TRAIN and LOSS as shipped
(ResNet-18, 2 blocks of width 64, K 8, 256 BPS points, PARAMETRIC_OUTPUT,
REF_NOISE 0.004, DROPOUT 0, Adam at 1e-3, StepLR, clipping each tensor to norm
1) with one change: ``BACKBONE.NORM`` ``frozen_bn`` for ``gn``, since flax's
GroupNorm float32 backward is off the float64 one by up to 1e-2 of the largest
gradient (``test_torch_train_step.py``). The gate's 8 steps an epoch; batches
of 2 samples with 1-3 of 3 views of 64 px (the gate renders 8 of 8 at 128 px:
data sizes, not the model's), a new batch each step. The JAX package's
``Trainer`` takes 8 steps from one set of weights (gain 0.5) with its own
key's reference-jitter draws; before each, the port loads the JAX state (the
parameters, Adam's moments, the update count) and takes the same step on the
same batch and draws through ``make_train_step`` with the Optimizer its
``Trainer`` builds from the config.

Both train through the einsum attention and gathered neighbourhoods selected
by full float32 distances (JAX ``use_flash=False``, the port
``use_flash_train=False``; the kernels' train path is held by
``test_torch_train_step.py``). Why the port is re-synchronised each step:
trajectories of float32 runs part. On K1's packed keys two runs part where a
distance lands on the other side of a key's rounding (at steps 3 and 6 of
these 8, moving the loss terms by up to 1%); the gradient through the 6D ->
axis-angle chain is ill-conditioned at some steps (below); and a free run of
the port parts from itself, one CPU thread against eight: Adam moves
float32-noise gradients by a whole learning rate, so the parameters are 2
rates apart after the first step and 9 after the eighth, the losses 1e-4 to
1e-3 apart from the second (``scripts/torch_train_drift.py``, the gate as
shipped).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_train_step import GRAD_REL, LOSS_RTOL, _RefDraws
from torch_port_helpers import fill_params, load_converted

from poem_v2_tpu_torch import configs
from poem_v2_tpu_torch.convert import convert_leaf, torch_key
from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create
from poem_v2_tpu_torch.training.optim import build_schedule
from poem_v2_tpu_torch.training.trainer import Trainer, make_train_step

STEPS = 8
STEPS_PER_EPOCH = 8  # 64 fixed samples at batch 8
CFG_PATH = "configs/synthetic_overfit_gate_mano.yaml"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port (the tier runs several files at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    from poem_v2_tpu.utils.config import Config

    with open(CFG_PATH) as f:
        cfg = Config(yaml.safe_load(f))
    cfg.MODEL.BACKBONE.NORM = "frozen_bn"
    return cfg


def test_schedules_match_optax_over_the_gates():
    """The learning rate of every step of both parametric gates (480 and 800
    epochs of 8 steps) equals optax's schedule, the decays included."""
    from poem_v2_tpu.training.optim import build_schedule as jax_schedule
    from poem_v2_tpu.utils.config import Config

    for name in ("synthetic_overfit_gate_mano", "synthetic_overfit_gate_mano_800"):
        train = configs.SYNTHETIC[name]["TRAIN"]
        ours, theirs = build_schedule(train, STEPS_PER_EPOCH), jax_schedule(Config(train),
                                                                            STEPS_PER_EPOCH)
        steps = np.arange(train["EPOCH"] * STEPS_PER_EPOCH)
        want = np.asarray(jax.vmap(theirs)(jnp.asarray(steps)))
        got = np.array([ours(int(n)) for n in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert len(np.unique(want)) == len(train["LR_DECAY_STEP"]) + 1


def _adam_state(opt_state):
    """The ScaleByAdamState inside an optax chain's state."""
    import optax

    return next(x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))


def _port_tree(tree):
    from poem_v2_tpu_torch.convert import flax_to_state_dict

    return flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, tree)})


def _flax_tree(like, port):
    """The port's tensors ``port`` (by state_dict key) in the layout of the flax tree ``like``."""
    def leaf(path, x):
        names = tuple(str(getattr(p, "key", p)) for p in path)
        t = port[torch_key(names[:-1], names[-1], np.ndim(x))].numpy()
        if t.ndim == 4 and convert_leaf(names[:-1], names[-1], np.zeros((1, 1, 1, 2))).shape[0] == 2:
            t = t.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif t.ndim == 2 and convert_leaf(names[:-1], names[-1], np.zeros((1, 2))).shape[0] == 2:
            t = t.T
        assert t.shape == np.shape(x), names
        return jnp.asarray(np.ascontiguousarray(t))

    return jax.tree_util.tree_map_with_path(leaf, like)


@pytest.fixture(scope="module")
def runs():
    from poem_v2_tpu.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu.models.poem import create_poem_model as jax_create
    from poem_v2_tpu.parallel.mesh import create_mesh
    from poem_v2_tpu.training.trainer import Trainer as JaxTrainer, TrainState
    import optax

    cfg = _cfg()
    data = SyntheticMultiviewDataset(batch_size=2, view_max=3, view_range=(1, 3), image_size=64,
                                     seed=11)
    batches = [data.sample_batch() for _ in range(STEPS)]
    jmodel, jaux = jax_create(cfg.MODEL, use_flash=False, remat=False)
    jtrainer = JaxTrainer(jmodel, jaux, cfg.TRAIN, cfg.MODEL.LOSS, mesh=create_mesh(data=1),
                          steps_per_epoch=STEPS_PER_EPOCH)
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": rng, "noise": rng, "dropout": rng}, b0["image"], b0["view_mask"],
        b0["cam_intr"], b0["cam_extr"], b0["master_joints_3d"], train=False))
    variables = fill_params(shapes, gain=0.5)
    state = TrainState.create(variables["params"], jtrainer.tx, jax.random.PRNGKey(5))
    tx_update = jax.jit(jtrainer.tx.update)

    tmodel, taux = torch_create(cfg.MODEL.to_dict(), device="cpu", use_flash_train=False)
    load_converted(tmodel, variables)
    ttrainer = Trainer(tmodel, taux, cfg.TRAIN.to_dict(), cfg.MODEL.LOSS.to_dict(),
                       steps_per_epoch=STEPS_PER_EPOCH)
    opt = ttrainer.optimizer
    tstep = make_train_step(tmodel, ttrainer.loss_fn, opt)
    names = [n for n, p in tmodel.named_parameters() if p.requires_grad]

    steps = []
    for batch in batches:
        # the port starts each step from the JAX state: its parameters, Adam's
        # moments and the update count
        params, adam = _port_tree(state.params), _adam_state(state.opt_state)
        mu, nu = _port_tree(adam.mu), _port_tree(adam.nu)
        tmodel.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
        opt.load_state_dict({"count": int(adam.count), "mini_step": 0, "acc": [],
                             "mu": [torch.from_numpy(np.array(mu[n])) for n in names],
                             "nu": [torch.from_numpy(np.array(nu[n])) for n in names]})
        # the draws the JAX step takes: its state's key split as make_train_step splits it
        _, noise_rng, _ = jax.random.split(state.rng, 3)
        draws = _RefDraws().apply({}, 2, rngs={"noise": noise_rng})
        # the step donates its state: keep copies of what optax starts from
        before = jax.tree_util.tree_map(lambda x: jnp.asarray(np.array(x)),
                                        (state.params, state.opt_state))
        with jax.default_matmul_precision("highest"):
            state, m = jtrainer.step(state, batch)
        got = tstep(ttrainer.to_device(batch), tuple(torch.from_numpy(np.array(d)) for d in draws))
        # the port's clipped gradient (the Optimizer clips .grad in place), and
        # what optax makes of it from the same state: the clip (a no-op on it up
        # to a factor 1 / (1 + 1e-6)), Adam and the schedule
        port_grads = {n: p.grad.detach().clone() for n, p in tmodel.named_parameters()
                      if p.requires_grad}
        updates, opt_state = tx_update(_flax_tree(before[0], port_grads), before[1], before[0])
        on_port_grads = _adam_state(opt_state)
        steps.append(dict(
            jax=jax.tree_util.tree_map(float, m), torch={k: float(v) for k, v in got.items()},
            optax_params=_port_tree(optax.apply_updates(before[0], updates)),
            optax_mu=_port_tree(on_port_grads.mu), optax_nu=_port_tree(on_port_grads.nu),
            model={n: p.detach().clone() for n, p in tmodel.named_parameters()},
            mu=[t.clone() for t in opt.mu], nu=[t.clone() for t in opt.nu], count=opt.count))
    return dict(cfg=cfg, steps=steps, names=names, jax_count=int(state.step))


def test_every_step_loss_terms_match_jax(runs):
    """From one state, each step's loss terms (the pose and shape terms among
    them) to 1e-4 relative (measured <= 2.3e-5, at step 3), the last step's to the
    one-step test's 1e-5 (measured <= 1e-6). The gradient norm is not held:
    through the 6D -> axis-angle chain of steps 3, 6 and 7 it is ill-conditioned
    (12.9886 / 12.988 at step 3, 3.279 / 3.718 at step 7, the loss terms equal
    to 1e-6 there); the one-step tests hold the gradients."""
    assert runs["jax_count"] == STEPS == runs["steps"][-1]["count"]
    for i, step in enumerate(runs["steps"]):
        want, got = step["jax"], step["torch"]
        assert set(got) == set(want) and {"loss_pose", "loss_shape"} <= set(got)
        for k, w in want.items():
            if k != "grad_norm":
                rtol = LOSS_RTOL if i == STEPS - 1 else 10 * LOSS_RTOL
                np.testing.assert_allclose(got[k], w, rtol=rtol, err_msg=f"step {i}: {k}")


@pytest.mark.parametrize("i", range(STEPS))
def test_step_optimizer_matches_optax(runs, i):
    """Step i's update from one state and one gradient (the port's, clipped): the
    port's Optimizer against the JAX package's optax chain, the bias correction
    of update i + 1 and the schedule's rate at step i in it. The parameters to 2
    float32 ulps plus 1e-4 of a step (a wrong rate, count or moment moves them
    by a good part of a step); Adam's moments to 1e-4
    of each tensor's largest (measured <= 2.3e-5: optax clips the clipped
    gradient again, by 1 / (norm + 1e-6) ~ 1 - 1e-6, and sums in another order)."""
    step = runs["steps"][i]
    lr = runs["cfg"].TRAIN.LR
    assert step["count"] == i + 1
    for n, mu, nu in zip(runs["names"], step["mu"], step["nu"]):
        for got, want in ((mu.numpy(), step["optax_mu"][n]), (nu.numpy(), step["optax_nu"][n])):
            np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * np.abs(want).max(),
                                       err_msg=n)
        want = step["optax_params"][n]
        lim = 2 * np.spacing(np.abs(want).astype(np.float32)) + 1e-4 * lr
        assert (np.abs(step["model"][n].numpy() - want) <= lim).all(), n
