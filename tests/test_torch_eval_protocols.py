"""The six ``eval_single`` protocols through the port on the CPU: fabricated raw
root -> the port's adapter -> the port's shard dumper (the reference tar layout)
-> the port's ``MultiviewWebDataset`` -> ``cli/eval.py:evaluate`` on
``cli/eval_single.py:build_eval_cfg``'s config with the protocol's pinned view
range and shard names, the model shrunk to ``tests/test_eval_protocols.py``'s
TINY_MODEL. Also: ``build_eval_cfg`` against the JAX one for every dataset and
tier, ``eval_single.main``'s wiring, and the LifecycleAdapter's train and test
steps against the Trainer and the Evaluator called directly."""

import os
import pickle
import re

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

from test_adapters import (  # noqa: E402
    make_arctic_root,
    make_dexycb_root,
    make_freihand_root,
    make_ho3d_root,
    make_interhand_root,
    make_oakink_root,
)
from test_eval_protocols import TINY_MODEL, _SingleViewAsMultiview  # noqa: E402

from poem_v2_tpu_torch.cli import eval_single  # noqa: E402
from poem_v2_tpu_torch.data import adapters as T  # noqa: E402

PROTOCOLS = ["DexYCB", "HO3D", "Interhand", "Oakink", "Arctic", "Freihand"]
TIERS = ["small", "medium", "large", "huge", "medium_MANO"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(name, root):
    """The protocol's multi-view adapter on a fabricated root (the port's classes)."""
    os.makedirs(root, exist_ok=True)
    if name == "DexYCB":
        make_dexycb_root(root, frames=3)
        return T.DexYCBMultiView(T.DexYCB(root, sequences=["20200709-subject-01/20200709_141754"]),
                                 master_system="as_constant_camera")
    if name == "HO3D":
        make_ho3d_root(root, frames=2)
        return T.HO3DMultiView(T.HO3DV3(root, "train"))
    if name == "Interhand":
        make_interhand_root(root, n_views=3, frames=2)
        return T.InterHandMultiView(T.InterHand(root, "train"))
    if name == "Oakink":
        make_oakink_root(root, frames=2)
        return T.OakInkMultiView(T.OakInk(root, "train+val"))
    if name == "Arctic":
        make_arctic_root(root, n_views=2, frames=2)
        return T.ArcticMultiView(T.Arctic(root, "train", "p1"))
    make_freihand_root(root, n=3)
    return _SingleViewAsMultiview(T.FreiHAND(root, "train"), n=3)


def _args(view_max, extra="auc"):
    from poem_v2_tpu_torch.cli.opt import parse_exp_args

    return parse_exp_args(["-c", "<dict>", "--exp_id", "default", "--eval_extra", extra,
                           "--view_max", str(view_max), "--device", "cpu", "--dtype", "fp32"])


def run_protocol(name, tmp_path, model_size="small"):
    from poem_v2_tpu_torch.cli.eval import evaluate
    from poem_v2_tpu_torch.data.dumper import dump_dataset
    from poem_v2_tpu_torch.utils.config import get_config

    meta = eval_single.DATASET_META[name]
    mv = _chain(name, str(tmp_path / name))
    prefix = re.match(r"(.+?)-(?:\{)?\d", os.path.basename(meta["urls"])).group(1)
    tar_dir = tmp_path / "tars" / name
    assert dump_dataset(mv, str(tar_dir), prefix, samples_per_shard=2) == len(mv)
    shards = sorted(os.listdir(tar_dir))
    assert all(re.fullmatch(rf"{re.escape(prefix)}-\d{{6}}\.tar", s) for s in shards)
    urls = (str(tar_dir / f"{prefix}-{{000000..{len(shards) - 1:06d}}}.tar") if len(shards) > 1
            else str(tar_dir / shards[0]))
    overrides = TINY_MODEL
    if model_size.endswith("_MANO"):  # keep the parametric branch the size table enables
        overrides = {**TINY_MODEL, "HEAD": {**TINY_MODEL["HEAD"], "TRANSFORMER": {
            **TINY_MODEL["HEAD"]["TRANSFORMER"], "PARAMETRIC_OUTPUT": True}}}
    cfg = eval_single.build_eval_cfg(name, model_size, reload_path="", urls=urls,
                                     epoch_size=len(mv), model_overrides=overrides)
    cfg.DATA_PRESET.IMAGE_SIZE = [64, 64]
    cfg.TRAIN.BATCH_SIZE = 2
    args = _args(meta["max_view"])
    results = evaluate(get_config(cfg.to_dict(), arg=args), args)
    for key in ("mpjpe", "mpvpe", "pa_mpjpe", "pa_mpvpe", "auc_j", "auc_v"):
        assert key in results and np.isfinite(results[key]), (name, key, results)
    dump = sorted((tmp_path / "exp").glob("default_eval_*"))[-1]
    assert re.search(r"auc_j 0\.\d+ auc_v 0\.\d+", (dump / "auc.txt").read_text())
    for pkl in ("res_auc_j.pkl", "res_auc_v.pkl"):
        with open(dump / pkl, "rb") as f:
            thr, pck = (np.asarray(a) for a in pickle.load(f))
        assert thr.shape == pck.shape == (20,)
    return results


@pytest.mark.parametrize("name", PROTOCOLS)
def test_eval_protocol_end_to_end(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_protocol(name, tmp_path)


def test_eval_protocol_parametric_mano(tmp_path, monkeypatch):
    """medium_MANO's parametric head, which the released protocol pairs with OakInk."""
    monkeypatch.chdir(tmp_path)
    run_protocol("Oakink", tmp_path, model_size="medium_MANO")


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", PROTOCOLS)
def test_build_eval_cfg_equals_jax(name, tier):
    from poem_v2_tpu.cli.eval_single import build_eval_cfg as jbuild

    got = eval_single.build_eval_cfg(name, tier, "ck.pt", view_range=[2, 3], urls="u.tar",
                                     epoch_size=5, model_overrides={"LOSS": {"X": 1}})
    want = jbuild(name, tier, "ck.pt", view_range=[2, 3], urls="u.tar", epoch_size=5,
                  model_overrides={"LOSS": {"X": 1}})
    assert got.to_dict() == want.to_dict()
    assert eval_single.build_eval_cfg(name, tier, "ck.pt").to_dict() == \
        jbuild(name, tier, "ck.pt").to_dict()


def test_eval_single_main_runs_evaluate_in_memory(monkeypatch):
    """``main`` hands ``evaluate`` the protocol's config (no YAML written) and the
    eval CLI's arguments; ``--approx_knn`` is accepted and changes nothing."""
    from poem_v2_tpu_torch.cli import eval as eval_cli

    seen = []
    monkeypatch.setattr(eval_cli, "evaluate", lambda cfg, args: seen.append((cfg, args)) or {})
    for extra in ([], ["--approx_knn"]):
        eval_single.main(["-d", "HO3D", "-m", "large", "--reload", "w.pt", "--view_min", "3",
                          "--device", "cpu", *extra])
    (cfg, args), (cfg2, _) = seen
    want = eval_single.build_eval_cfg("HO3D", "large", "w.pt", view_range=[3, 5])
    assert cfg.to_dict() == {**want.to_dict(), "TRAIN": {**cfg.TRAIN.to_dict(),
                                                         **want.TRAIN.to_dict()}}
    assert cfg.frozen and cfg2.to_dict() == cfg.to_dict()
    assert (args.exp_id, args.reload, args.view_max, args.device, args.dtype, args.eval_extra) \
        == ("eval_HO3D_large", "w.pt", 5, "cpu", "bf16", "auc")


def _tiny_model_and_batch(seed=3):
    from poem_v2_tpu_torch.data import batch_iterator, create_dataset
    from poem_v2_tpu_torch.models.poem import create_poem_model

    cfg = eval_single.build_eval_cfg("DexYCB", "small", "", model_overrides=TINY_MODEL)
    model, aux = create_poem_model(cfg.MODEL.to_dict(), dtype=torch.float32, device="cpu",
                                   generator=torch.Generator().manual_seed(seed))
    data = {"TYPE": "Synthetic", "VIEW_MAX": 2, "VIEW_RANGE": [1, 2], "IMAGE_SIZE": 64,
            "EPOCH_SIZE": 2, "SEED": 1}
    batch = next(iter(batch_iterator(create_dataset(data), 2, 2, 2)))
    return cfg, model, aux, batch


def test_lifecycle_adapter_steps_equal_trainer_and_evaluator(tmp_path, monkeypatch):
    from poem_v2_tpu_torch.models.model_abc import LifecycleAdapter
    from poem_v2_tpu_torch.training.evaluator import Evaluator
    from poem_v2_tpu_torch.training.trainer import Trainer
    from poem_v2_tpu_torch.utils.recorder import Recorder

    monkeypatch.chdir(tmp_path)
    runs = []
    for via_adapter in (True, False):
        cfg, model, aux, batch = _tiny_model_and_batch()
        trainer = Trainer(model, aux, train_cfg=cfg.TRAIN, loss_cfg=cfg.MODEL.LOSS)
        evaluator = Evaluator(model, aux)
        if via_adapter:
            adapter = LifecycleAdapter(model, aux, trainer, evaluator)
            adapter.setup(summary_writer=None)
            assert adapter.init(batch)["step"] == 0
            metrics = adapter.training_step(batch, 0)
            measures = adapter.testing_step(batch, 0)
            again = adapter.validation_step(batch, 1)  # the meters keep summing
            recorder = Recorder("default", root=str(tmp_path / "exp"))
            adapter.on_train_finished(recorder, 0)
            assert os.path.isfile(recorder.ckpt_path())
            val = adapter.on_val_finished(recorder, 0)
            assert set(val) >= {"mpjpe", "mpvpe", "pa_mpjpe"}
            assert evaluator.MPJPE.avg_meter.count == 0  # reset for the next validation
        else:
            metrics = trainer.step(batch)
            measures = evaluator.run([batch])
            again = evaluator.run([batch, batch])
        runs.append((metrics, measures, again, model.state_dict()))
    (m1, e1, a1, p1), (m2, e2, a2, p2) = runs
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    assert e1 == e2 and a1 == a2
    assert all(torch.equal(p1[k], p2[k]) for k in p2)
