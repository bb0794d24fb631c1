"""The port's whole serving slice against the JAX POEMNet on the CPU.

The JAX model runs with ``use_flash=True`` (the TPU serving path) and its
Pallas kernels in interpret mode; the fused bilinear kernel is swapped for
the package's f32 ``grid_sample_points_matmul`` so the comparison measures
the algorithm and not that kernel's bf16 tap weights. The batch mixes view
counts (3 and 2 valid views of 3), so the mixed-view scramble runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import (fill_params, load_converted, look_at_cameras, pallas_interpret,
                                tiny_cfg as _tiny_cfg)

from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create
from poem_v2_tpu_torch.serving.predictor import Predictor

# float32 on both sides, summed in different orders through a 2-block
# decoder: coordinates agree to ~3e-7 m; 2e-5 m (0.02 mm) leaves margin
# without hiding a wrong neighbour or a wrong scramble row (those move
# points by millimetres)
ATOL_M = 2e-5
# integral 2D joints in pixels on 64 x 64 crops
ATOL_PX = 1e-3


def _inputs(B=2, V=3, size=64, seed=0):
    rs = np.random.RandomState(seed)
    images = rs.uniform(-0.5, 0.5, (B, V, size, size, 3)).astype(np.float32)
    mask = np.ones((B, V), bool)
    mask[1, 2] = False
    intr, extr = look_at_cameras(rs, B, V, size)
    return images, mask, intr, extr


def test_slice_matches_jax_poemnet():
    from poem_v2_tpu.models.poem import create_poem_model as jax_create

    cfg = _tiny_cfg()
    images, mask, intr, extr = _inputs()
    jmodel, _ = jax_create(cfg, use_flash=True)
    rng = jax.random.PRNGKey(0)
    args = (jnp.asarray(images), jnp.asarray(mask), jnp.asarray(intr), jnp.asarray(extr))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": rng, "noise": rng, "dropout": rng}, *args, None, train=False))
    # gain 0.5 keeps the merge's cubic product and the Δxyz head near the
    # scale of a trained model; at unit gain queries drift metres from the
    # cloud, where neighbour distances all but tie and f32 noise decides
    variables = fill_params(shapes, gain=0.5)
    with pallas_interpret(exact_sampler=True), jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a, None, train=False))(variables, *args)
        want = jax.tree_util.tree_map(np.asarray, want)

    tmodel, _ = torch_create(cfg, device="cpu")
    load_converted(tmodel, variables)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (images, mask, intr, extr)))

    for key, tol in (("pred_joints_uv", ATOL_PX), ("pred_ref_joints_3d", ATOL_M),
                     ("all_coords_preds", ATOL_M), ("pred_joints_3d", ATOL_M),
                     ("pred_verts_3d", ATOL_M)):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=tol, rtol=0,
                                   err_msg=key)


def test_predictor_pads_ragged_request_like_the_model():
    """A ragged request (B=3, 2 of 4 views) through the Predictor equals the
    model on the batch padded by hand: views to the bucket with identity x
    100 intrinsics, the batch to bucket 4 with copies of row 0."""
    cfg = _tiny_cfg()
    model, _ = torch_create(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    pred = Predictor(model, view_bucket=4, image_size=64)
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (3, 2, 64, 64, 3)).astype(np.uint8)
    intr, extr = look_at_cameras(rs, 3, 2, 64)
    out = pred(images, intr, extr)

    img = images.astype(np.float32) / 255.0 - 0.5
    img = np.concatenate([img, np.zeros_like(img)], 1)
    mask = np.concatenate([np.ones((3, 2), bool), np.zeros((3, 2), bool)], 1)
    intr_p = np.concatenate([intr, np.broadcast_to(np.eye(3, dtype=np.float32) * 100,
                                                   (3, 2, 3, 3))], 1)
    extr_p = np.concatenate([extr, np.broadcast_to(np.eye(4, dtype=np.float32), (3, 2, 4, 4))], 1)
    rows = [0, 1, 2, 0]
    with torch.no_grad():
        ref = model(*(torch.from_numpy(np.ascontiguousarray(a[rows]))
                      for a in (img, mask, intr_p, extr_p)),
                    torch.zeros(4, 21, 3))
    assert out["joints_3d"].shape == (3, 21, 3) and out["verts_3d"].shape == (3, 778, 3)
    assert out["joints_uv"].shape == (3, 2, 21, 2)
    np.testing.assert_array_equal(out["joints_3d"], ref["pred_joints_3d"][:3].numpy())
    np.testing.assert_array_equal(out["verts_3d"], ref["pred_verts_3d"][:3].numpy())
    np.testing.assert_array_equal(out["joints_uv"], ref["pred_joints_uv"][:3, :2].numpy())
