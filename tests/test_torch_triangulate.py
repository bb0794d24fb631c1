"""The DLT's model entry point ``triangulate_dlt_c2m``: the plain chain on the CPU,
the one-launch kernel (``csrc/triangulate.cu``) on the card, held against the
plain chain there. The card tests carry the ``cuda`` marker and skip without a
CUDA device; on the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_triangulate.py``. Imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.geometry.camera import invert_rigid, project_world_to_pixel
from poem_v2_tpu_torch.geometry.triangulation import triangulate_dlt
from poem_v2_tpu_torch.ops.triangulate import triangulate_dlt_c2m
from torch_cameras import look_at_cameras

J = 21


def rig_inputs(seed: int, B: int, V: int, size: int = 256):
    """Cameras on a ring (``look_at_cameras``), hand-sized joints seen with 1 px noise,
    and a mask whose rows keep 2..V views, one view, or none, as far as V allows."""
    rs = np.random.RandomState(seed)
    intr, extr = look_at_cameras(rs, B, V, size)
    joints = (rs.randn(B, J, 3) * 0.04 + [0.0, 0.0, 0.5]).astype(np.float32)
    intr, extr = torch.from_numpy(intr), torch.from_numpy(extr)
    kp = project_world_to_pixel(torch.from_numpy(joints), extr, intr)
    kp = kp + torch.from_numpy(rs.randn(B, V, J, 2).astype(np.float32))
    mask = torch.from_numpy(rs.rand(B, V) < 0.7)
    mask[:, :min(V, 2)] = True
    if B > 1:
        mask[1] = False                  # every view masked
        mask[B - 1] = False
        mask[B - 1, rs.randint(V)] = True  # one valid view
    return kp, intr, extr, mask


def plain(kp, intr, extr, mask):
    return triangulate_dlt(kp, intr, invert_rigid(extr), mask)


@pytest.mark.parametrize("B,V", [(1, 1), (3, 4), (2, 8)])
def test_c2m_on_the_cpu_is_the_plain_chain(B, V):
    kp, intr, extr, mask = rig_inputs(B * 10 + V, B, V)
    torch.testing.assert_close(triangulate_dlt_c2m(kp, intr, extr, mask),
                               plain(kp, intr, extr, mask), rtol=0, atol=0)


def test_c2m_refuses_unsupported_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused, never
    triangulated on the CPU."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        triangulate_dlt_c2m(torch.zeros(1, 2, J, 2, **meta), torch.zeros(1, 2, 3, 3, **meta),
                            torch.zeros(1, 2, 4, 4, **meta), torch.ones(1, 2, dtype=torch.bool,
                                                                        **meta))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, *ts):
    return tuple(t.to(dev) for t in ts)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("V", [1, 2, 4, 8])
def test_kernel_matches_the_plain_chain(cuda, B, V):
    """Rows of two or more valid views to 1e-5 m; rows with every view masked alike bit
    for bit; rows of one view (an ill-posed system: two null vectors, picked by
    rounding) finite. One launch a call."""
    kp, intr, extr, mask = _on(cuda, *rig_inputs(B * 100 + V, B, V))
    before = triangulate_dlt_c2m.launches
    with torch.no_grad():
        got = triangulate_dlt_c2m(kp, intr, extr, mask)
    assert triangulate_dlt_c2m.launches == before + 1
    want = plain(kp, intr, extr, mask)
    n = mask.sum(1)
    assert torch.isfinite(got).all()
    if (n >= 2).any():
        torch.testing.assert_close(got[n >= 2], want[n >= 2], rtol=0, atol=1e-5)
    assert torch.equal(got[n == 0], want[n == 0])


@pytest.mark.cuda
def test_kernel_takes_strided_inputs(cuda):
    """A non-contiguous kp2d (and cameras and mask) give the contiguous call's bits."""
    kp, intr, extr, mask = _on(cuda, *rig_inputs(7, 16, 8))
    wide = torch.zeros(16, 8, J, 5, device=cuda)
    wide[..., 1:5:2] = kp
    kp_s = wide[..., 1:5:2]
    extr_s = extr.transpose(0, 1).contiguous().transpose(0, 1)
    mask_s = mask.t().contiguous().t()
    assert not (kp_s.is_contiguous() or extr_s.is_contiguous() or mask_s.is_contiguous())
    want = triangulate_dlt_c2m(kp, intr, extr, mask)
    torch.testing.assert_close(triangulate_dlt_c2m(kp_s, intr, extr_s, mask_s), want,
                               rtol=0, atol=0)
    n = mask.sum(1) >= 2
    torch.testing.assert_close(want[n], plain(kp_s, intr, extr_s, mask)[n], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernel_on_tied_and_near_degenerate_systems(cuda):
    """Axis-aligned cameras on the principal point make A^T A = diag(n, n, 0, 0): tied
    eigenvalues, no rotation, the first least one picked, as the plain chain does.
    Parallel cameras 0.1 mm apart make a near-degenerate system (depth to centimetres):
    the points still reproject onto their keypoints, as the plain chain's do."""
    B, V = 4, 4
    intr = torch.eye(3).expand(B, V, 3, 3).contiguous()
    extr = torch.eye(4).expand(B, V, 4, 4).contiguous()
    kp = torch.zeros(B, V, J, 2)
    mask = torch.ones(B, V, dtype=torch.bool)
    mask[1, 2:] = False
    kp, intr, extr, mask = _on(cuda, kp, intr, extr, mask)
    got = triangulate_dlt_c2m(kp, intr, extr, mask)
    assert torch.equal(got, plain(kp, intr, extr, mask))
    assert torch.equal(got[..., :2], torch.zeros_like(got[..., :2]))

    rs = np.random.RandomState(3)
    intr = torch.tensor([[300.0, 0.0, 128.0], [0.0, 300.0, 128.0], [0.0, 0.0, 1.0]])
    intr = intr.expand(B, V, 3, 3).contiguous()
    extr = torch.eye(4).expand(B, V, 4, 4).contiguous()
    extr[:, :, :3, 3] = torch.from_numpy(rs.randn(B, V, 3).astype(np.float32) * 1e-4)
    joints = torch.from_numpy((rs.randn(B, J, 3) * 0.04 + [0.0, 0.0, 0.5]).astype(np.float32))
    kp = project_world_to_pixel(joints, extr, intr)
    kp, intr, extr, mask = _on(cuda, kp, intr, extr, torch.ones(B, V, dtype=torch.bool))

    def reprojection_px(points):
        return float((project_world_to_pixel(points, extr, intr) - kp).abs().max())

    got = triangulate_dlt_c2m(kp, intr, extr, mask)
    assert torch.isfinite(got).all()
    assert reprojection_px(plain(kp, intr, extr, mask)) <= 0.05
    assert reprojection_px(got) <= 0.05


@pytest.mark.cuda
def test_kernel_refuses_autograd_and_other_dtypes(cuda):
    kp, intr, extr, mask = _on(cuda, *rig_inputs(1, 2, 4))
    with pytest.raises(ValueError):
        triangulate_dlt_c2m(kp, intr, extr, mask.float())
    with pytest.raises(RuntimeError, match="no backward"):
        triangulate_dlt_c2m(kp.requires_grad_(), intr, extr, mask)


@pytest.mark.cuda
def test_an_eval_forward_takes_the_kernel_once(cuda):
    """One POEMNet eval forward of a mixed-view batch launches the kernel once, and its
    reference joints are the plain chain's on the forward's own 2D joints."""
    from test_torch_tracing import tiny_model_cfg

    from poem_v2_tpu_torch.models.poem import create_poem_model

    model, _ = create_poem_model(tiny_model_cfg(), device="cuda",
                                 generator=torch.Generator().manual_seed(5))
    model.eval()
    B, V = 2, 4
    rs = np.random.RandomState(0)
    intr, extr = look_at_cameras(rs, B, V, 64)
    images = torch.from_numpy(rs.rand(B, V, 64, 64, 3).astype(np.float32) - 0.5)
    mask = torch.tensor([[True] * 4, [True, True, True, False]])
    args = _on(cuda, images, mask, torch.from_numpy(intr), torch.from_numpy(extr))
    before = triangulate_dlt_c2m.launches
    with torch.no_grad():
        preds = model(*args)
    assert triangulate_dlt_c2m.launches == before + 1
    _, mask, intr, extr = args
    want = plain(preds["pred_joints_uv"], intr, extr, mask)
    torch.testing.assert_close(preds["pred_ref_joints_3d"], want, rtol=0, atol=1e-5)
