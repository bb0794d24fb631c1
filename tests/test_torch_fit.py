"""The port's MANO fitter (``poem_v2_tpu_torch/fit``) against the JAX package, on the CPU.

Both sides fit the default (synthetic) MANO model to the same seeded targets.
Tolerances: loss values 1e-5 relative; gradients, silhouettes and parameters
after a step 1e-4 of the tensor's largest magnitude; the learning-rate schedule
exactly. The JAX side is jitted; one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import look_at_cameras, one_thread_no_tf32

from poem_v2_tpu.fit import frame_fit as jff, hand_loss as jhl, soft_raster as jsr
from poem_v2_tpu.mano import ManoLayer as JaxMano
from poem_v2_tpu_torch import fit as tfit
from poem_v2_tpu_torch.fit import frame_fit as tff, hand_loss as thl, soft_raster as tsr
from poem_v2_tpu_torch.mano.layer import ManoLayer

REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_no_tf32():
        yield


def _close(name, got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-30,
                               err_msg=name)


def test_exports():
    assert {"FitParams", "FitResult", "OneFrameFit", "anatomical_loss", "OneFrameFitSilh",
            "multiview_silhouette_loss", "soft_silhouette"} <= set(dir(tfit))
    assert tfit.anatomical_loss is tff.anatomical_loss


def _random_quats(rs, B, scale=0.4):
    q = rs.randn(B, 16, 4).astype(np.float32) * scale
    q[..., 0] += 1.0
    return q


def test_hand_loss_formulas():
    rs = np.random.RandomState(0)
    q16 = rs.randn(2, 16, 4).astype(np.float32)
    qn = q16 / np.linalg.norm(q16, axis=-1, keepdims=True)
    shape = rs.randn(2, 10).astype(np.float32)
    axes = rs.randn(3, 2, 15, 3).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    axis = rs.randn(2, 15, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = (np.abs(rs.randn(2, 15)) * 1.5).astype(np.float32)
    mask = (angle >= 0.5).astype(np.float32)
    init = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 15, 1))
    cases = [
        ("pose_quat_norm_loss", (q16,)), ("pose_reg_loss", (qn[:, 1:], init)),
        ("shape_reg_loss", (shape, np.zeros_like(shape))),
        ("joint_b_axis_loss", (axes[0], axis, mask)), ("joint_u_axis_loss", (axes[1], axis, mask)),
        ("joint_l_limit_loss", (axes[2], axis, mask)), ("rotation_angle_loss", (angle,)),
        ("quaternion_mul", (q16, qn)), ("quaternion_inv", (q16,)),
    ]
    for name, args in cases:
        want = jax.jit(getattr(jhl, name))(*(jnp.asarray(a) for a in args))
        got = getattr(thl, name)(*(torch.from_numpy(a) for a in args))
        _close(name, got, want, rel=1e-6)
    aa = rs.randn(3, 48).astype(np.float32)
    _close("cheap anatomical_loss", tff.anatomical_loss(torch.from_numpy(aa)),
           jax.jit(jff.anatomical_loss)(jnp.asarray(aa)), rel=1e-6)


@pytest.fixture(scope="module")
def manos():
    return JaxMano(), ManoLayer()


def test_hand_axes(manos):
    jm, tm = manos
    pose = np.random.RandomState(1).randn(2, 48).astype(np.float32) * 0.3
    jout = jm(jnp.asarray(pose), jnp.zeros((2, 10)))
    tout = tm(torch.from_numpy(pose), torch.zeros(2, 10))
    want = jax.jit(jhl.hand_axes)(jout.joints, jout.transforms)
    got = thl.hand_axes(torch.from_numpy(np.asarray(jout.joints)),
                        torch.from_numpy(np.asarray(jout.transforms)))
    for n, g, w in zip("bul", got, want):
        _close(n, g, w)
    _close("port MANO's axes", thl.hand_axes(tout.joints, tout.transforms)[0], want[0])


def _scenario(seed=0, B=2, V=3, image=256):
    """test_fit.py's scenario at B frames: a random pose and shape, translated
    0.55 m in front of view 0, seen by V cameras; the 2D targets are the exact
    projections."""
    rs = np.random.RandomState(seed)
    pose = rs.randn(B, 48).astype(np.float32) * 0.15
    betas = rs.randn(B, 10).astype(np.float32) * 0.2
    out = JaxMano()(jnp.asarray(pose), jnp.asarray(betas))
    joints = np.asarray(out.joints) + np.array([0.02, -0.01, 0.55], np.float32)
    intr, extr = look_at_cameras(rs, B, V, image, dist=0.55)
    m2c = np.linalg.inv(extr)
    j_cam = np.einsum("bvij,bnj->bvni", m2c[..., :3, :3], joints) + m2c[..., :3, 3][:, :, None]
    proj = np.einsum("bvni,bvji->bvnj", j_cam, intr)
    target_2d = (proj[..., :2] / proj[..., 2:]).astype(np.float32)
    mask = np.ones((B, V), bool)
    mask[-1, -1] = False
    return dict(target_2d=target_2d, cam_intr=intr, cam_extr=extr, view_mask=mask,
                target_joints_3d=joints.astype(np.float32))


def _fitters(manos, lr=5e-2, steps=5, silh=False, **kw):
    jm, tm = manos
    if silh:
        from poem_v2_tpu.fit import OneFrameFitSilh as J

        return J(jm, lr=lr, steps=steps, **kw), tfit.OneFrameFitSilh(tm, lr=lr, steps=steps,
                                                                      device="cpu", **kw)
    return (jff.OneFrameFit(jm, lr=lr, steps=steps, **kw),
            tff.OneFrameFit(tm, lr=lr, steps=steps, device="cpu", **kw))


def _states(sc, B):
    rs = np.random.RandomState(5)
    ident = np.asarray(jff._init_params(B).quat)
    tsl = sc["target_joints_3d"].mean(1)
    return {"identity": (ident, np.zeros((B, 10), np.float32), tsl),
            "random": (_random_quats(rs, B), (rs.randn(B, 10) * 0.3).astype(np.float32),
                       (tsl + rs.randn(B, 3) * 0.01).astype(np.float32))}


def _jax_value_and_grad(jfit, sc, with_3d=True):
    args = [jnp.asarray(sc[k]) for k in ("target_2d", "cam_intr", "cam_extr", "view_mask")]
    j3d = jnp.asarray(sc["target_joints_3d"]) if with_3d else None
    return jax.jit(jax.value_and_grad(lambda p: jfit.loss(p, *args, j3d)))


def _port_value_and_grad(tfitter, sc, state, with_3d=True):
    params = tff.FitParams(*(torch.tensor(a, requires_grad=True) for a in state))
    args = [torch.from_numpy(sc[k]) for k in ("target_2d", "cam_intr", "cam_extr", "view_mask")]
    j3d = torch.from_numpy(sc["target_joints_3d"]) if with_3d else None
    loss = tfitter.loss(params, *args, j3d)
    loss.backward()
    return loss, [p.grad for p in params]


@pytest.mark.parametrize("state", ["identity", "random"])
@pytest.mark.parametrize("silh", [False, True])
def test_loss_and_gradient(manos, state, silh):
    """The objective and its gradient: at the identity init (the singular point of
    quat_to_aa, where the gradient must be finite) and at a random state; with the
    silhouette term on a padded view too."""
    sc = _scenario()
    jfit, tfitter = _fitters(manos, w_joint3d=1.0, silh=silh,
                             **(dict(img_size=256) if silh else {}))
    if silh:
        masks = (np.random.RandomState(6).rand(2, 3, 16, 16) > 0.5).astype(np.float32)
        jfit._masks, tfitter._masks = jnp.asarray(masks), torch.from_numpy(masks)
    st = _states(sc, 2)[state]
    want_loss, want_grads = _jax_value_and_grad(jfit, sc)(jff.FitParams(
        *(jnp.asarray(a) for a in st)))
    loss, grads = _port_value_and_grad(tfitter, sc, st)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for name, g, w in zip(("quat", "shape", "tsl"), grads, want_grads):
        assert torch.isfinite(g).all(), name
        _close(f"d/d{name}", g, w)


@pytest.mark.parametrize("steps", [2, 9])
def test_schedule_is_optax(steps):
    sched = optax.exponential_decay(5e-2, steps // 3, 0.5, staircase=True)
    fitter = tff.OneFrameFit(ManoLayer(), lr=5e-2, steps=steps, device="cpu")
    for t in range(steps + 2):
        assert fitter.learning_rate(t) == pytest.approx(float(sched(t)), rel=1e-7), t
    if steps < 3:
        assert {fitter.learning_rate(t) for t in range(steps)} == {5e-2}


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def test_steps_from_the_jax_state(manos):
    """Five updates (the schedule halves the rate every step at steps = 5): before
    each, the port loads the JAX state (parameters, Adam's moments and count) and
    takes the same update; the loss, the gradients, the parameters and the
    moments after it against JAX's. The JAX stepping reproduces its own ``fit``'s
    losses (one scan)."""
    sc = _scenario(seed=3)
    jfit, tfitter = _fitters(manos, lr=5e-2, steps=5, w_joint3d=1.0)
    tx = optax.adam(optax.exponential_decay(5e-2, 5 // 3, 0.5, staircase=True))
    vg = _jax_value_and_grad(jfit, sc)

    @jax.jit
    def jax_step(p, s):
        loss, g = vg(p)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss, g

    p = jff.FitParams(*(jnp.asarray(a) for a in _states(sc, 2)["identity"]))
    s = tx.init(p)
    args = [torch.from_numpy(sc[k]) for k in ("target_2d", "cam_intr", "cam_extr", "view_mask")]
    j3d = torch.from_numpy(sc["target_joints_3d"])
    jax_losses = []
    for t in range(5):
        adam = _adam_state(s)
        params = tff.FitParams(*(torch.tensor(np.asarray(a), requires_grad=True) for a in p))
        opt = tfitter.make_optimizer(params)
        for prm, mu, nu in zip(params, adam.mu, adam.nu):
            opt.state[prm] = {"step": torch.tensor(float(adam.count)),
                              "exp_avg": torch.tensor(np.asarray(mu)),
                              "exp_avg_sq": torch.tensor(np.asarray(nu))}
        loss = tfitter.step(params, opt, int(adam.count),
                            lambda q: tfitter.loss(q, *args, j3d))
        p, s, want_loss, want_grads = jax_step(p, s)
        jax_losses.append(float(want_loss))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, err_msg=str(t))
        adam = _adam_state(s)
        for name, prm, w, g, mu in zip(("quat", "shape", "tsl"), params, p, want_grads, adam.mu):
            _close(f"step {t} d/d{name}", prm.grad, g)
            _close(f"step {t} {name}", prm, w)
            _close(f"step {t} {name} first moment", opt.state[prm]["exp_avg"], mu)
    scan = jfit.fit(*(jnp.asarray(sc[k]) for k in ("target_2d", "cam_intr", "cam_extr",
                                                    "view_mask", "target_joints_3d")))
    np.testing.assert_allclose(np.asarray(scan.losses), jax_losses, rtol=1e-5)


def test_fit_recovers_projected_joints(manos):
    """tests/test_fit.py's scenario on the port (one frame, three views, 400 steps
    at lr 5e-2 with the 3D term): the loss falls tenfold and the joints land within
    1.5 cm."""
    from scipy.spatial.transform import Rotation as R

    _, tm = manos
    rs = np.random.RandomState(0)
    pose = rs.randn(1, 48).astype(np.float32) * 0.15
    betas = rs.randn(1, 10).astype(np.float32) * 0.2
    out = tm(torch.from_numpy(pose), torch.from_numpy(betas))
    joints = out.joints.numpy() + np.array([[0.02, -0.01, 0.55]], np.float32)[:, None]
    V = 3
    extr = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    extr[0, 1, :3, :3] = R.from_rotvec([0, 0.4, 0]).as_matrix()
    extr[0, 1, :3, 3] = [0.25, 0, 0.05]
    extr[0, 2, :3, :3] = R.from_rotvec([0.3, -0.2, 0]).as_matrix()
    extr[0, 2, :3, 3] = [-0.18, 0.1, 0.02]
    intr = np.zeros((1, V, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = 500.0
    intr[..., 0, 2] = intr[..., 1, 2] = 128.0
    intr[..., 2, 2] = 1.0
    m2c = np.linalg.inv(extr)
    j_cam = np.einsum("bvij,bnj->bvni", m2c[..., :3, :3], joints) + m2c[..., :3, 3][:, :, None]
    proj = np.einsum("bvni,bvji->bvnj", j_cam, intr)
    target_2d = proj[..., :2] / proj[..., 2:]
    res = tff.OneFrameFit(tm, steps=400, lr=5e-2, w_joint3d=1.0, device="cpu").fit(
        target_2d, intr, extr, target_joints_3d=joints)
    losses = res.losses.numpy()
    final_err = np.linalg.norm(res.joints.numpy() - joints, axis=-1).mean()
    assert losses.shape == (400,) and losses[-1] < losses[0] * 0.1
    assert final_err < 0.015, f"fit error {final_err}"


def test_soft_silhouette_and_its_gradient(manos):
    jm, _ = manos
    faces = np.asarray(jm.faces, np.int32)
    rs = np.random.RandomState(7)
    v = (rs.rand(778, 2) * 20 + 2).astype(np.float32)
    want = jax.jit(lambda x: jsr.soft_silhouette(x, jnp.asarray(faces), size=24, sigma=1.0))(
        jnp.asarray(v))
    got = tsr.soft_silhouette(torch.from_numpy(v), torch.from_numpy(faces), size=24, sigma=1.0)
    _close("silhouette", got, want)
    tri = np.array([[2.0, 2.0], [30.0, 2.0], [2.0, 30.0]], np.float32)
    one = tsr.soft_silhouette(torch.from_numpy(tri), torch.tensor([[0, 1, 2]]), size=32,
                              sigma=0.5)
    assert float(one[8, 8]) > 0.9 and float(one[30, 30]) < 0.1
    target = (rs.rand(24, 24) > 0.5).astype(np.float32)

    def jloss(x):
        return jnp.mean(jnp.abs(jsr.soft_silhouette(x, jnp.asarray(faces), size=24) - target))

    gw = jax.jit(jax.grad(jloss))(jnp.asarray(v))
    vt = torch.tensor(v, requires_grad=True)
    (tsr.soft_silhouette(vt, torch.from_numpy(faces), size=24) - torch.from_numpy(target)
     ).abs().mean().backward()
    _close("silhouette gradient", vt.grad, gw)


def test_multiview_silhouette_loss_with_padded_views(manos):
    """Two frames of three views, one padded: the loss equals JAX's, and garbage in
    the padded view's target does not move it."""
    jm, _ = manos
    faces = np.asarray(jm.faces, np.int32)
    sc = _scenario(seed=8, image=64)
    out = jm(jnp.zeros((2, 48)), jnp.zeros((2, 10)))
    verts = np.asarray(out.verts) + sc["target_joints_3d"].mean(1, keepdims=True)
    masks = (np.random.RandomState(9).rand(2, 3, 16, 16) > 0.6).astype(np.float32)
    vm = sc["view_mask"]
    args = (sc["cam_intr"], sc["cam_extr"], verts)
    want = jax.jit(lambda i, e, v, m: jsr.multiview_silhouette_loss(
        i, e, v, m, jnp.asarray(faces), view_mask=jnp.asarray(vm), img_size=64))(
        *(jnp.asarray(a) for a in args), jnp.asarray(masks))
    t = [torch.from_numpy(a) for a in args]
    got = tsr.multiview_silhouette_loss(*t, torch.from_numpy(masks), torch.from_numpy(faces),
                                        view_mask=torch.from_numpy(vm), img_size=64)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    masks2 = masks.copy()
    masks2[-1, -1] = 1.0
    got2 = tsr.multiview_silhouette_loss(*t, torch.from_numpy(masks2), torch.from_numpy(faces),
                                         view_mask=torch.from_numpy(vm), img_size=64)
    assert float(got2) == float(got)


def test_silhouette_fit_improves_mask_overlap(manos):
    """tests/test_fit.py's silhouette scenario on the port, at S 16 and 20 steps for the
    CPU's time (JAX: S 24, 30 steps): the silhouette loss and the objective fall."""
    _, tm = manos
    faces = torch.as_tensor(np.asarray(tm.faces), dtype=torch.long)
    gt_pose = torch.from_numpy(np.random.RandomState(10).randn(1, 48).astype(np.float32) * 0.1)
    out = tm(gt_pose, torch.zeros(1, 10))
    tsl = torch.tensor([[0.0, 0.0, 0.4]])
    gt_verts, gt_joints = out.verts + tsl[:, None], out.joints + tsl[:, None]
    B, V, S = 1, 2, 16
    intr = torch.tensor([[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]]).expand(B, V, 3, 3)
    extr = torch.eye(4).expand(B, V, 4, 4)
    view_mask = torch.ones(B, V, dtype=torch.bool)
    masks = tsr.soft_silhouette(tsr.project_to_raster(gt_verts, intr, extr, 64, S), faces,
                                size=S, sigma=1.0)
    from poem_v2_tpu_torch.geometry.camera import (cam_extr_transf, cam_intr_projection,
                                                   invert_rigid)

    j2d = cam_intr_projection(intr, cam_extr_transf(invert_rigid(extr), gt_joints[:, None]))
    fitter = tfit.OneFrameFitSilh(tm, steps=20, lr=2e-2, img_size=64, w_silh=1.0, sigma=1.0,
                                  device="cpu")
    res = fitter.fit(j2d, intr, extr, view_mask, masks=masks, target_joints_3d=gt_joints)
    after = tsr.multiview_silhouette_loss(intr, extr, res.verts, masks, faces,
                                          view_mask=view_mask, img_size=64)
    init = tsr.multiview_silhouette_loss(intr, extr, torch.zeros_like(res.verts) + tsl[:, None],
                                         masks, faces, view_mask=view_mask, img_size=64)
    assert torch.isfinite(after) and float(after) < float(init)
    assert float(res.losses[-1]) < float(res.losses[0])


def test_fitter_targets_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tff.OneFrameFit(ManoLayer())
