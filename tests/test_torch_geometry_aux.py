"""The port's heatmap, camera and 6D-rotation helpers against the JAX package, on the CPU.

Both sides get the same seeded float32 inputs; the JAX side is jitted. Tolerance:
1e-4 of the output's largest magnitude (float32), over any leading batch shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu.geometry import camera as jcam, heatmap as jhm, rotations as jrot
from poem_v2_tpu_torch.geometry import camera as tcam, heatmap as thm, rotations as trot

REL = 1e-4


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * max(np.abs(want).max(), 1e-30))


def _both(jfn, tfn, *arrays, **kw):
    want = jax.jit(lambda *a: jfn(*a, **kw))(*(jnp.asarray(a) for a in arrays))
    got = tfn(*(torch.from_numpy(a) for a in arrays), **kw)
    _close(got, want)


def test_gaussian_heatmap2d():
    uv = np.random.RandomState(0).uniform(0, 1, (2, 3, 21, 2)).astype(np.float32)
    for size, sigma in ((32, 2.0), (17, 1.5)):
        _both(jhm.gaussian_heatmap2d, thm.gaussian_heatmap2d, uv, hm_size=size, sigma=sigma)


def test_integral_heatmap3d():
    rs = np.random.RandomState(1)
    hm = rs.uniform(0, 1, (2, 21, 8, 6, 5)).astype(np.float32)
    hm /= hm.sum((-3, -2, -1), keepdims=True)
    _both(jhm.integral_heatmap3d, thm.integral_heatmap3d, hm)


def _cameras(rs, lead):
    intr = np.zeros(lead + (3, 3), np.float32)
    intr[..., 0, 0] = rs.uniform(200, 600, lead)
    intr[..., 1, 1] = rs.uniform(200, 600, lead)
    intr[..., 0, 2] = rs.uniform(100, 150, lead)
    intr[..., 1, 2] = rs.uniform(100, 150, lead)
    intr[..., 2, 2] = 1.0
    return intr


def test_persp_project():
    rs = np.random.RandomState(2)
    pts = (rs.randn(2, 3, 21, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    _both(jcam.persp_project, tcam.persp_project, pts, _cameras(rs, (2, 3)))


@pytest.mark.parametrize("bone", [False, True])
def test_xyz_uvd_round_trip(bone):
    rs = np.random.RandomState(3)
    xyz = (rs.randn(4, 21, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    root = xyz[:, 9]
    intr = _cameras(rs, (4,))
    bl = np.array(jcam.ref_bone_len(jnp.asarray(xyz))) if bone else None
    kw = dict(inp_res=(256, 224))
    jb = None if bl is None else jnp.asarray(bl)
    tb = None if bl is None else torch.from_numpy(bl)
    want = jax.jit(lambda a, r, k: jcam.xyz_to_uvd(a, r, k, ref_bone_len=jb, **kw))(
        jnp.asarray(xyz), jnp.asarray(root), jnp.asarray(intr))
    got = tcam.xyz_to_uvd(torch.from_numpy(xyz), torch.from_numpy(root),
                          torch.from_numpy(intr), ref_bone_len=tb, **kw)
    _close(got, want)
    back_want = jax.jit(lambda a, r, k: jcam.uvd_to_xyz(a, r, k, ref_bone_len=jb, **kw))(
        want, jnp.asarray(root), jnp.asarray(intr))
    back = tcam.uvd_to_xyz(got, torch.from_numpy(root), torch.from_numpy(intr),
                           ref_bone_len=tb, **kw)
    _close(back, back_want)
    np.testing.assert_allclose(back.numpy(), xyz, atol=1e-5)


def test_ref_bone_len():
    joints = np.random.RandomState(4).randn(2, 5, 21, 3).astype(np.float32)
    for link in ((0, 9), (0, 5, 6, 7)):
        _both(jcam.ref_bone_len, tcam.ref_bone_len, joints, link=link)


@pytest.mark.parametrize("name,make", [
    ("aa_to_rot6d", lambda rs: rs.randn(3, 16, 3) * 1.2),
    ("quat_to_rot6d", lambda rs: rs.randn(3, 16, 4)),
    ("rot6d_to_quat", lambda rs: rs.randn(3, 16, 6)),
    ("rotmat_to_rot6d", lambda rs: np.asarray(jrot.aa_to_rotmat(jnp.asarray(rs.randn(3, 16, 3))))),
])
def test_rot6d_conversions(name, make):
    x = make(np.random.RandomState(5)).astype(np.float32)
    _both(getattr(jrot, name), getattr(trot, name), x)
