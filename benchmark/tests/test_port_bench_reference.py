"""The plain reference against the port's plain CPU path at a tiny size (float32)."""

import numpy as np
import pytest
import torch

from benchmark.generator import make_pool
from benchmark.reference import mano_ref
from benchmark.reference.poem_ref import Precision, Reference, load_constants
from benchmark.serving import gaps, reference_outputs
from benchmark.tests.tiny import tiny_cell
from benchmark.weights import load_into, make_weights


def tiny_model(cell, seed=5):
    from poem_v2_tpu_torch.models.poem import create_poem_model

    model, _ = create_poem_model(cell.config["MODEL"], dtype=torch.float32, device="cpu")
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    weights = make_weights(shapes, seed, "cpu")
    load_into(model, weights)
    return model, weights


def test_mano_copy_is_the_ports():
    from poem_v2_tpu_torch.mano.layer import ManoLayer
    from poem_v2_tpu_torch.mano.model import synthetic_mano

    mine, theirs = mano_ref.synthetic_mano(), synthetic_mano()
    for k, v in mine.items():
        assert np.array_equal(v, getattr(theirs, k)), k
    rs = np.random.RandomState(0)
    pose = torch.from_numpy(rs.randn(3, 48).astype(np.float32) * 0.3)
    betas = torch.from_numpy(rs.randn(3, 10).astype(np.float32) * 0.3)
    verts, joints = mano_ref.mano_forward(mine, pose, betas)
    out = ManoLayer()(pose, betas)
    assert torch.allclose(verts, out.verts, atol=1e-6) and torch.allclose(joints, out.joints, atol=1e-6)


def test_dlt_recovers_a_point():
    from benchmark.generator import ring_cameras

    intr, extr = ring_cameras(4, 256)
    X = np.array([0.01, -0.02, 0.52])
    m2c = np.linalg.inv(extr)
    cam = np.einsum("vij,j->vi", m2c[:, :3, :3], X) + m2c[:, :3, 3]
    uv = np.einsum("vij,vj->vi", intr, cam)
    uv = uv[:, :2] / uv[:, 2:]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)[None]
    got = Reference.dlt(t(uv[:, None]), t(intr), Reference.world_to_cam(t(extr)),
                        torch.ones(1, 4, dtype=torch.bool))
    assert np.allclose(got[0, 0].numpy(), X, atol=1e-5)


def test_reference_matches_the_ports_forward():
    from poem_v2_tpu_torch.serving.predictor import Predictor

    cell = tiny_cell("serve")
    model, weights = tiny_model(cell)
    pred = Predictor(model, view_bucket=cell.traffic["view_bucket"], image_size=64)
    ref = Reference(weights, cell.config["MODEL"], load_constants(cell.config["MODEL"], "cpu"),
                    Precision("float32"))
    for b in make_pool(cell.traffic, 11, "cpu"):
        g = gaps(pred(b["image"], b["cam_intr"], b["cam_extr"], b["view_mask"]),
                 reference_outputs(ref, b, "cpu", 2), b["view_mask"])
        assert g["uv_gap_px"] < 1e-4 and g["coords_rms_gap_m"] < 1e-4, g
        assert g["coords_gap_m"] < 2e-3, g  # a near-tie neighbour may differ in the widest


def test_control_rounds_every_product():
    x = torch.linspace(-3, 3, 101)
    assert torch.equal(Precision("float32").q(x), x)
    fp8 = Precision("fp8").q(x)
    assert 0 < (fp8 - x).abs().max() < 0.2 and (Precision("bfloat16").q(x) - x).abs().max() < 0.02
