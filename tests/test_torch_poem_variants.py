"""POEM's last two head options through ``create_poem_model``, the port against the JAX
package on the CPU: ``HEAD.TRANSFORMER.TYPE: PtEmbedTRv3`` and ``HEAD.PETR_EMBEDDING``.

The tiny HRNet model (``tiny_cfg``; PtEmbedTRv3's METRO stage at
``tests/test_baselines.py``'s small widths, ``small_metro_stage``), its eval
forward on a batch of 3 and 2 valid views of 3: JAX with ``use_flash=True`` (the TPU serving path; its
Pallas kernels in interpret mode, the fused bilinear sampler swapped for the
f32 matmul one as ``test_torch_slice.py`` does), the port with its kernels'
plain versions. The v3 decoder's PtEmbedTRv2 blocks run the gathered path: the
JAX blocks select by full float32 distances, K1's plain version by packed
keys, which tie distances within 2**-11 (``test_torch_decoder_v3.py``). One
train step of each: ``test_torch_poem_variants_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import ATOL_M, ATOL_PX, _inputs
from torch_port_helpers import (fill_params, load_converted, look_at_cameras, pallas_interpret,
                                small_metro_stage, tiny_cfg)

from poem_v2_tpu_torch.models.bricks.point_transformer import _VectorAttention
from poem_v2_tpu_torch.models.decoder_v3 import PtEmbedTRv3
from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create

VARIANTS = ["v3", "petr"]


@pytest.fixture(autouse=True)
def small_tiny_model(monkeypatch):
    """The tiny model's PtEmbedTRv3 with a small METRO stage, one intra-op thread
    (the tier runs several test files at once on the host's cores)."""
    small_metro_stage(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variant(cfg, name):
    if name == "v3":
        cfg.HEAD.TRANSFORMER.TYPE = "PtEmbedTRv3"
    else:
        cfg.HEAD.PETR_EMBEDDING = True
    return cfg


def _gathered_v2_blocks(model):
    """The v3 decoder's refinement blocks select by full distances, as the JAX ones."""
    for m in model.head.transformer.point_transformer.modules():
        if isinstance(m, _VectorAttention):
            m.use_fused_knn = False


def test_v3_with_parametric_output_raises():
    cfg = _variant(tiny_cfg(), "v3")
    cfg.HEAD.TRANSFORMER.PARAMETRIC_OUTPUT = True
    with pytest.raises(ValueError, match="PtEmbedTRv3"):
        torch_create(cfg, device="cpu")


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_eval_forward_matches_jax(name):
    from poem_v2_tpu.models.poem import create_poem_model as jax_create

    cfg = _variant(tiny_cfg(), name)
    images, mask, intr, extr = _inputs()
    jmodel, _ = jax_create(cfg, use_flash=True)
    rng = jax.random.PRNGKey(0)
    args = (jnp.asarray(images), jnp.asarray(mask), jnp.asarray(intr), jnp.asarray(extr))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": rng, "noise": rng, "dropout": rng}, *args, None, train=False))
    variables = fill_params(shapes, gain=0.5)
    with pallas_interpret(exact_sampler=True), jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a, None, train=False))(variables, *args)
        want = jax.tree_util.tree_map(np.asarray, want)

    tmodel, _ = torch_create(cfg, device="cpu")
    load_converted(tmodel, variables)
    if name == "v3":
        _gathered_v2_blocks(tmodel)
        assert isinstance(tmodel.head.transformer, PtEmbedTRv3)
        assert want["all_coords_preds"].shape[0] == 3  # the coarse mesh + 2 blocks
    else:
        assert hasattr(tmodel.head, "position_encoder")
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (images, mask, intr, extr)))
    for key, tol in (("pred_joints_uv", ATOL_PX), ("pred_ref_joints_3d", ATOL_M),
                     ("all_coords_preds", ATOL_M), ("pred_joints_3d", ATOL_M),
                     ("pred_verts_3d", ATOL_M)):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=tol, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_through_the_front_doors(name, tmp_path, monkeypatch):
    """The train CLI (one epoch of 2 steps, validation, a checkpoint), the eval CLI
    on that checkpoint and ``Predictor.from_config`` take either option on the
    synthetic configs' ResNet-18 model (float32 on the CPU)."""
    import yaml
    from test_torch_cli import BASE, _cfg as cli_cfg

    from poem_v2_tpu_torch.cli import eval as eval_cli, train as train_cli
    from poem_v2_tpu_torch.serving.predictor import Predictor

    monkeypatch.chdir(tmp_path)
    cfg = cli_cfg(epochs=1)
    head = cfg["MODEL"]["HEAD"]
    if name == "v3":
        head["TRANSFORMER"]["TYPE"] = "PtEmbedTRv3"
    else:
        head["PETR_EMBEDDING"] = True
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run = train_cli.main(["-c", str(path), *BASE])
    assert run["trainer"].global_step == 2 and all(np.isfinite(run["losses"]))
    ckpt = tmp_path / run["dump_path"] / "checkpoints" / "checkpoint.pt"
    results = eval_cli.main(["-c", str(path), *BASE, "--reload", str(ckpt)])
    assert np.isfinite(results["joints_3d_mepe"]) and np.isfinite(results["pa_mpvpe"])
    pred = Predictor.from_config(cfg, ckpt_path=str(ckpt), dtype=torch.float32, device="cpu")
    rs = np.random.RandomState(0)
    intr, extr = look_at_cameras(rs, 2, 2, 64)
    out = pred(rs.randint(0, 256, (2, 2, 64, 64, 3)).astype(np.uint8), intr, extr)
    assert out["verts_3d"].shape == (2, 778, 3) and np.isfinite(out["verts_3d"]).all()
