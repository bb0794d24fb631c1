"""The drawing path's front doors on the CPU (``--device cpu``, float32, the
synthetic configs' ResNet-18 model at ``TINY_MODEL_CFG``): ``Predictor.warmup``,
``cli/demo.py``, ``DrawingHandCallback`` through ``cli/eval.py --eval_extra draw``
and through the ``LifecycleAdapter``, and the train CLI's image summary, each
drawing held against the JAX package's viztools on the same arrays."""

import os

import numpy as np
import pytest
import torch

from helpers import TINY_MODEL_CFG

from poem_v2_tpu.viztools import draw as JD, renderer as JR
from poem_v2_tpu_torch.cli import demo as demo_cli, eval as eval_cli, train as train_cli
from poem_v2_tpu_torch.configs import SYNTHETIC_SMOKE
from poem_v2_tpu_torch.data.codec import decode_png
from poem_v2_tpu_torch.serving.predictor import Predictor
from poem_v2_tpu_torch.utils.config import dump_yaml


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tier runs several test files at once on the
    host's cores, and more threads a process only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(render=True):
    data = {"TYPE": "Synthetic", "VIEW_MAX": 2, "VIEW_RANGE": [1, 2], "IMAGE_SIZE": 64,
            "EPOCH_SIZE": 4, "FIXED_SET": True, "SEED": 7, "RENDER": render}
    return {
        "TRAIN": {"BATCH_SIZE": 2, "MANUAL_SEED": 1, "EPOCH": 1, "OPTIMIZER": "adam",
                  "LR": 1e-3, "SCHEDULER": "constant", "LOG_INTERVAL": 1,
                  "GRAD_CLIP_ENABLED": True, "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0}},
        "DATA_PRESET": {"CENTER_IDX": 0, "NUM_JOINTS": 21, "NUM_VERTS": 778,
                        "IMAGE_SIZE": [64, 64]},
        "DATASET": {"TRAIN": data, "TEST": dict(data, EPOCH_SIZE=2)},
        "MODEL": TINY_MODEL_CFG.to_dict(),
    }


def _write(tmp_path, cfg, name="cfg.yaml"):
    path = tmp_path / name
    path.write_text(dump_yaml(cfg))
    return str(path)


BASE = ["--exp_id", "default", "--view_max", "2", "--dtype", "fp32", "--device", "cpu"]


def test_warmup_runs_one_forward_of_the_bucket():
    pred = Predictor.from_config(_cfg(), dtype=torch.float32, device="cpu", view_bucket=2)
    seen = []
    pred.model.register_forward_hook(lambda m, a, out: seen.append(a[0].shape))
    assert pred.warmup(3) > 0
    assert seen == [torch.Size([4, 2, 64, 64, 3])]  # batch 3 runs in the bucket of 4
    pred.warmup()
    assert seen[-1] == torch.Size([1, 2, 64, 64, 3])


def test_demo_cli_on_cpu_draws_what_jax_draws(tmp_path):
    """tests/test_serving.py's demo run: a PNG per sample and finite outputs; its
    pixels are the JAX viztools' drawing of the same outputs."""
    from poem_v2_tpu.mano import ManoLayer

    cfg = {k: v for k, v in _cfg().items() if k in ("MODEL", "DATA_PRESET")}
    out = demo_cli.main(["-c", _write(tmp_path, cfg), "--out", str(tmp_path / "demo"),
                         "--batch", "2", "--views", "2", "--dtype", "fp32", "--device", "cpu"])
    assert np.isfinite(out["verts_3d"]).all() and out["verts_3d"].shape == (2, 778, 3)
    assert out["timing"]["warmup_s"] > 0 and out["timing"]["request_s"] > 0
    assert sorted(os.listdir(tmp_path / "demo")) == ["demo_0.png", "demo_1.png"]
    # the demo's request: the synthetic generator's first batch (seed 0, 2 views)
    from poem_v2_tpu_torch.data import SyntheticMultiviewDataset

    batch = SyntheticMultiviewDataset(batch_size=2, view_max=2, image_size=64, seed=0,
                                      random_views=False).sample_batch()
    images = JD.denormalize_image(batch["image"])
    overlays = JR.draw_batch_mesh_images(images, out["verts_3d"], batch["cam_intr"],
                                         batch["cam_extr"], np.asarray(ManoLayer().faces),
                                         view_mask=batch["view_mask"])
    for b in range(2):
        want = JD.tile_views(np.stack([JD.draw_joints_2d(overlays[b, v], out["joints_uv"][b, v])
                                       for v in range(2)]), cols=2)
        got = decode_png(open(tmp_path / "demo" / f"demo_{b}.png", "rb").read())
        np.testing.assert_array_equal(got, want)


def test_demo_raises_where_the_card_is_asked_for_and_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = {k: v for k, v in _cfg().items() if k in ("MODEL", "DATA_PRESET")}
    with pytest.raises((RuntimeError, AssertionError)):
        demo_cli.main(["-c", _write(tmp_path, cfg), "--out", str(tmp_path / "demo"),
                       "--batch", "1", "--views", "2"])
    assert not (tmp_path / "demo").exists()


def test_eval_cli_draws(tmp_path, monkeypatch):
    """--eval_extra draw: a grid per sample and a predicted and a ground-truth
    composite per valid view, PNGs, beside finite measures."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg()
    results = eval_cli.main(["-c", _write(tmp_path, cfg), *BASE, "--eval_extra", "draw"])
    assert all(np.isfinite(v) for v in results.values())
    evals = [d for d in os.listdir(tmp_path / "exp") if d.startswith("default_eval")]
    draws = tmp_path / "exp" / evals[0] / "draws"
    files = sorted(os.listdir(draws))
    grids = [f for f in files if f.startswith("step00000_s")]
    assert grids == ["step00000_s0.png", "step00000_s1.png"]  # one batch of 2 samples
    comps = [f for f in files if f not in grids]
    n_views = len([f for f in comps if not f.endswith("_GT.png")])
    assert 2 <= n_views <= 4 and len(comps) == 2 * n_views  # 1-2 valid views a sample
    img = decode_png(open(draws / grids[0], "rb").read())
    assert img.shape[0] == 64 and img.shape[1] in (64, 128)


def test_drawing_callback_through_the_lifecycle_adapter(tmp_path):
    """The reference's testing_step with the draw callback: the Evaluator's feed
    hands it the batch on the device and the predictions on the host."""
    from poem_v2_tpu_torch.data import batch_iterator, create_dataset
    from poem_v2_tpu_torch.models.model_abc import LifecycleAdapter
    from poem_v2_tpu_torch.models.poem import create_poem_model
    from poem_v2_tpu_torch.training.draw_callback import DrawingHandCallback
    from poem_v2_tpu_torch.training.evaluator import Evaluator
    from poem_v2_tpu_torch.utils.config import Config

    cfg = Config(_cfg())
    model, aux = create_poem_model(cfg.MODEL.to_dict(), device="cpu")
    adapter = LifecycleAdapter(model, aux, trainer=None, evaluator=Evaluator(model, aux))
    cb = DrawingHandCallback(str(tmp_path), max_samples=3, composites=False, render_mesh=True)
    batches = batch_iterator(create_dataset(cfg.DATASET.TEST), 2, 2, 2)
    for i, batch in enumerate(batches):
        measures = adapter.testing_step(batch, i, callback=cb)
        assert np.isfinite(measures["joints_3d_mepe"])
    assert sorted(os.listdir(tmp_path / "draws")) == ["step00000_s0.png", "step00000_s1.png"]


def test_train_cli_image_summary_is_jax_s_drawing(tmp_path, monkeypatch):
    """Every fifth log step the first view of the batch with its target skeleton, as
    the JAX CLI draws it, goes to TensorBoard under ``img/viz_joints_2d_train``."""
    monkeypatch.chdir(tmp_path)
    images = []

    class Capture(train_cli.SummaryWriter):
        def add_image(self, tag, img, step, dataformats="HWC"):
            images.append((tag, img, step))
            super().add_image(tag, img, step, dataformats)

    monkeypatch.setattr(train_cli, "SummaryWriter", Capture)
    cfg = _cfg()
    cfg["TRAIN"]["EPOCH"] = 2
    cfg["DATASET"]["TRAIN"]["EPOCH_SIZE"] = 12  # 6 steps an epoch: log 0 and 5 are summaries
    run = train_cli.main(["-c", _write(tmp_path, cfg), *BASE, "--eval_freq", "10"])
    assert [(t, s) for t, _, s in images] == [("img/viz_joints_2d_train", 0),
                                              ("img/viz_joints_2d_train", 5),
                                              ("img/viz_joints_2d_train", 6),
                                              ("img/viz_joints_2d_train", 11)]
    from poem_v2_tpu_torch.data import batch_iterator, create_dataset
    from poem_v2_tpu_torch.utils.config import Config

    first = next(iter(batch_iterator(create_dataset(Config(cfg).DATASET.TRAIN), 2, 2, 12)))
    want = JD.draw_joints_2d(JD.denormalize_image(first["image"][0, 0]),
                             first["target_joints_2d"][0, 0])
    np.testing.assert_array_equal(images[0][1], want)
    np.testing.assert_array_equal(
        train_cli.train_image_summary(run["trainer"].to_device(first)), want)


def test_render_synthetic_smoke_streams(tmp_path):
    """A streaming (not fixed) synthetic set with RENDER draws every sample anew."""
    from poem_v2_tpu_torch.data import create_dataset
    from poem_v2_tpu_torch.utils.config import Config

    data = dict(SYNTHETIC_SMOKE["DATASET"]["TRAIN"], RENDER=True, EPOCH_SIZE=2)
    a, b = list(create_dataset(Config(data)))
    assert a["image"].max() > 0.45 and b["image"].max() > 0.45
    assert not np.array_equal(a["target_joints_2d"][0], b["target_joints_2d"][0])
