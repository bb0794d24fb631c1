"""The synthetic dataset's ``RENDER`` option against the JAX package's, key for key,
and the four configs that set it (the convergence gates) read without PyYAML,
built, and the 800-epoch gate's schedule entered by ``--resume``."""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from poem_v2_tpu.data import SyntheticMultiviewDataset as JDataset
from poem_v2_tpu.data import create_dataset as jcreate
from poem_v2_tpu.utils.config import Config as JConfig
from poem_v2_tpu_torch import configs as tconfigs
from poem_v2_tpu_torch.data import SyntheticMultiviewDataset as TDataset
from poem_v2_tpu_torch.data import create_dataset as tcreate
from poem_v2_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER_CONFIGS = ["synthetic_overfit_render", "synthetic_overfit_gate",
                  "synthetic_overfit_gate_mano", "synthetic_overfit_gate_mano_800"]
# keys equal bit for bit, and keys that carry the MANO skinning's float32
# rounding (metres; pixels scale with the image)
EXACT = ("view_mask", "cam_intr", "mano_pose", "mano_shape")
METRES = ("master_joints_3d", "master_verts_3d", "cam_extr")


def _band(joints_2d, shape, radius):
    """Pixels within 2 px (Chebyshev) of the skeleton's outline: its bones and the
    rims of its joint discs, from the given joints."""
    import cv2

    from poem_v2_tpu_torch.viztools.draw import HAND_LINKS

    mask = np.zeros(shape[:2], np.uint8)
    p = np.round(joints_2d).astype(int)
    for a, b in HAND_LINKS:
        cv2.line(mask, tuple(map(int, p[a])), tuple(map(int, p[b])), 1)
    for q in p:
        cv2.circle(mask, tuple(map(int, q)), radius, 1, 1)
    return cv2.dilate(mask, np.ones((5, 5), np.uint8)) > 0


def _same_images(got, want, joints_2d, radius):
    """Identical outside the anti-aliasing band around each view's skeleton."""
    for idx in np.ndindex(got.shape[:-3]):
        outside = ~_band(joints_2d[idx], got.shape[-3:], radius)
        np.testing.assert_array_equal(got[idx][outside], want[idx][outside], err_msg=str(idx))


@pytest.mark.parametrize("size,random_views", [(64, True), (128, False)])
def test_render_batches_match_jax(size, random_views):
    kw = dict(batch_size=2, view_max=3, view_range=(1, 3), image_size=size, seed=3,
              random_views=random_views, render=True)
    jds, tds = JDataset(**kw), TDataset(**kw)
    for _ in range(2):
        want, got = jds.sample_batch(), tds.sample_batch()
        assert set(got) == set(want)
        for k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in METRES:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6, err_msg=k)
        np.testing.assert_allclose(got["target_joints_2d"], want["target_joints_2d"], rtol=0,
                                   atol=1e-3 * size / 64)  # pixels
        _same_images(got["image"], want["image"], want["target_joints_2d"], max(2, size // 64))
        # drawn, not noise: the skeleton is far brighter than the 0-40 background
        assert got["image"].max() > 0.45 and np.median(got["image"]) < 40 / 255 - 0.5


@pytest.mark.parametrize("name", RENDER_CONFIGS)
def test_render_configs_read_without_pyyaml_and_build(name, monkeypatch):
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    text = open(path).read()
    want = yaml.safe_load(text)
    assert tconfig.parse_yaml(text, path) == want == tconfigs.SYNTHETIC[name]
    assert want["DATASET"]["TRAIN"]["RENDER"] and want["DATASET"]["TEST"]["RENDER"]
    monkeypatch.setattr(tconfig, "_yaml", lambda: None)
    cfg = tconfig.get_config(path)
    assert cfg.to_dict() == tconfig.get_config(tconfigs.SYNTHETIC[name]).to_dict()
    # the fixed train set's first samples, drawn as the JAX package draws them
    data = dict(cfg.DATASET.TRAIN.to_dict(), EPOCH_SIZE=2)
    got = list(tcreate(tconfig.Config(data)))
    want = list(jcreate(JConfig(data)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        _same_images(g["image"], w["image"], w["target_joints_2d"],
                     max(2, data["IMAGE_SIZE"] // 64))
    from poem_v2_tpu_torch.models.poem import create_poem_model

    model, aux = create_poem_model(cfg.MODEL.to_dict(), device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 10_000_000  # ResNet-18 and the head
    assert bool(cfg.MODEL.HEAD.TRANSFORMER.get("PARAMETRIC_OUTPUT", False)) == ("mano" in name)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(name, epochs):
    """``name`` as shipped but for its size: 2 epochs of 1 step at B2, 2 views of
    64 px, 2 test samples."""
    cfg = copy.deepcopy(tconfigs.SYNTHETIC[name])
    cfg["TRAIN"]["EPOCH"] = epochs
    cfg["TRAIN"]["LOG_INTERVAL"] = 1
    cfg["DATA_PRESET"]["IMAGE_SIZE"] = [64, 64]
    for part in ("TRAIN", "TEST"):
        cfg["DATASET"][part].update(EPOCH_SIZE=2, IMAGE_SIZE=64, VIEW_MAX=2, VIEW_RANGE=[2, 2])
    return cfg


def test_gate_mano_800_enters_by_resume(tmp_path, monkeypatch, one_thread):
    """The 800-epoch parametric gate is the 480-epoch one resumed (exp_records'
    *_ext files): its run from the shorter schedule's checkpoint starts at the
    next epoch and keeps the step count."""
    from poem_v2_tpu_torch.cli import train as train_cli
    from poem_v2_tpu_torch.cli.opt import parse_exp_args

    monkeypatch.chdir(tmp_path)
    argv = ["-c", "<dict>", "--exp_id", "default", "--view_max", "2", "-b", "2", "--device",
            "cpu", "--dtype", "fp32", "--eval_freq", "100"]
    args = parse_exp_args(argv)
    first = train_cli.train(
        tconfig.get_config(_small("synthetic_overfit_gate_mano", 2), arg=args), args)
    assert first["trainer"].global_step == 2
    cfg800 = _small("synthetic_overfit_gate_mano_800", 3)
    assert cfg800["TRAIN"]["LR_DECAY_STEP"] == [280, 400, 640]
    args = parse_exp_args(argv + ["--resume", first["checkpoint"]["path"]])
    ext = train_cli.train(tconfig.get_config(cfg800, arg=args), args)
    assert ext["start_epoch"] == 2 and ext["trainer"].global_step == 3
    assert all(np.isfinite(ext["losses"])) and len(ext["losses"]) == 1
