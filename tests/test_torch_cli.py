"""The port's train and eval CLIs on the CPU (``--device cpu``, float32), on
``TINY_MODEL_CFG`` (the synthetic configs' ResNet-18 model) with synthetic data:
steps, checkpoints, ``--resume`` and the eval measures."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from helpers import TINY_MODEL_CFG

from poem_v2_tpu_torch.cli import eval as eval_cli, train as train_cli
from poem_v2_tpu_torch.cli.opt import parse_exp_args
from poem_v2_tpu_torch.models.poem import draw_ref_noise
from poem_v2_tpu_torch.utils.recorder import Recorder


def _cfg(epochs=2, fixed=True):
    data = {"TYPE": "Synthetic", "VIEW_MAX": 2, "IMAGE_SIZE": 64, "EPOCH_SIZE": 4}
    if fixed:
        data.update(FIXED_SET=True, SEED=7)
    return {
        "TRAIN": {"BATCH_SIZE": 2, "MANUAL_SEED": 1, "EPOCH": epochs, "OPTIMIZER": "adam",
                  "LR": 1e-3, "SCHEDULER": "constant", "LOG_INTERVAL": 1,
                  "GRAD_CLIP_ENABLED": True, "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0}},
        "DATA_PRESET": {"CENTER_IDX": 0, "NUM_JOINTS": 21, "NUM_VERTS": 778,
                        "IMAGE_SIZE": [64, 64]},
        "DATASET": {"TRAIN": data, "TEST": dict(data, EPOCH_SIZE=2)},
        "MODEL": TINY_MODEL_CFG.to_dict(),
    }


def _write(tmp_path, cfg, name="cfg.yaml"):
    path = tmp_path / name
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


BASE = ["--exp_id", "default", "--view_max", "2", "--dtype", "fp32", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tier runs several test files at once on the
    host's cores, and more threads a process only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_cli_checkpoints_and_resumes_like_an_uninterrupted_run(tmp_path, monkeypatch):
    """Two epochs of 2 steps with validation and a checkpoint each; a run resumed
    from the first epoch's snapshot restores the step, the epoch and the
    Trainer's generator, and takes the uninterrupted run's losses; the eval CLI
    reads the last checkpoint and reports finite measures in metres."""
    monkeypatch.chdir(tmp_path)
    path = _write(tmp_path, _cfg())
    run = train_cli.main(["-c", path, *BASE])
    assert run["trainer"].global_step == 4 and len(run["losses"]) == 4
    assert all(np.isfinite(run["losses"])) and len(run["val"]) == 2
    assert all(np.isfinite(v) for r in run["val"] for v in r.values())
    ckpts = os.path.join(run["dump_path"], "checkpoints")
    assert {"checkpoint.pt", "checkpoint_1.pt", "checkpoint_2.pt", "meta.json"} <= \
        set(os.listdir(ckpts))
    with open(os.path.join(ckpts, "meta.json")) as f:
        assert json.load(f) == {"epoch": 1, "step": 4}
    assert run["checkpoint"]["bytes"] == os.path.getsize(os.path.join(ckpts, "checkpoint.pt"))

    # the snapshot after epoch 0 holds step 2 and the generator after two steps'
    # draws (the jitter, then the dropout seed)
    snap = torch.load(os.path.join(ckpts, "checkpoint_1.pt"), weights_only=False)
    assert (snap["step"], snap["epoch"]) == (2, 0)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        draw_ref_noise(gen, 2)
        torch.randint(0, 2 ** 62, (), generator=gen)
    assert torch.equal(snap["generator"], gen.get_state())

    resumed = train_cli.main(["-c", path, *BASE, "--resume",
                              os.path.join(ckpts, "checkpoint_1.pt")])
    assert resumed["start_epoch"] == 1
    assert (resumed["resumed"]["step"], resumed["resumed"]["epoch"]) == (2, 0)
    assert resumed["trainer"].global_step == 4
    np.testing.assert_allclose(resumed["losses"], run["losses"][2:], rtol=1e-6)
    for name, p in resumed["trainer"].model.state_dict().items():
        torch.testing.assert_close(p, run["trainer"].model.state_dict()[name], rtol=1e-5,
                                   atol=1e-6, msg=name)

    results = eval_cli.main(["-c", path, *BASE, "--eval_extra", "auc", "--reload",
                             os.path.join(ckpts, "checkpoint.pt")])
    for key in ("joints_3d_mepe", "vertices_3d_mepe", "joints_3d_rel_mepe", "pa_mpjpe",
                "pa_mpvpe", "triangulate_joints_mepe", "auc_j", "auc_v"):
        assert np.isfinite(results[key]), key
    assert 0.0 < results["pa_mpjpe"] < 1.0 and 0.0 <= results["auc_j"] <= 1.0  # metres
    # the eval of the trained weights is the run's last validation (same model,
    # same fixed test set, meters restarted per run)
    for k, v in run["val"][-1].items():
        assert results[k] == pytest.approx(v, rel=1e-5), k
    evals = [d for d in os.listdir(tmp_path / "exp") if d.startswith("default_eval")]
    assert evals and os.path.exists(tmp_path / "exp" / evals[0] / "auc.txt")


def test_train_cli_streaming_feed_profiles_epoch_zero(tmp_path, monkeypatch):
    """A streaming (not fixed) set goes through the prefetch feed; ``--profile``
    writes a torch.profiler trace of epoch 0; ``--exact_knn`` is accepted."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(epochs=1, fixed=False)
    del cfg["DATASET"]["TEST"]
    run = train_cli.main(["-c", _write(tmp_path, cfg), *BASE, "--exact_knn",
                          "--profile", str(tmp_path / "prof")])
    assert run["trainer"].global_step == 2 and run["val"] == []
    assert os.listdir(tmp_path / "prof") == ["trace_epoch0.json"]


@pytest.mark.parametrize("flags,match", [
    (["--mesh_data", "2"], "data parallel"), (["--mesh_model", "2"], "data parallel"),
    (["--mesh_data", "1", "--mesh_model", "4"], "tensor parallel"),
    (["--multihost"], "multi-host"),
])
def test_flags_the_port_cannot_honour_raise(flags, match):
    """Outside torchrun (a world of one): more data-parallel ranks than the
    world, a model mesh, and --multihost without torchrun's environment."""
    with pytest.raises(NotImplementedError, match=match):
        parse_exp_args(["-c", "x.yaml", *flags])


def test_default_device_is_the_card_and_inert_flags_parse():
    args = parse_exp_args(["-c", "x.yaml", "--exact_knn", "--mesh_data", "1"])
    assert args.device == "cuda" and args.exact_knn and args.flash_train
    assert not parse_exp_args(["-c", "x.yaml", "--no-flash_train"]).flash_train


def test_what_waits_raises(tmp_path, monkeypatch):
    """--eval_extra draw no longer waits (it draws: tests/test_torch_demo.py holds
    its pixels); an orbax directory, as a checkpoint and as PRETRAINED_BACKBONE,
    names the export script."""
    monkeypatch.chdir(tmp_path)
    path = _write(tmp_path, _cfg())
    eval_cli.main(["-c", path, *BASE, "--eval_extra", "draw"])
    evals = [d for d in os.listdir(tmp_path / "exp") if d.startswith("default_eval")]
    assert any(f.endswith(".png") for f in os.listdir(tmp_path / "exp" / evals[0] / "draws"))
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="torch_export_checkpoint"):
        Recorder.load_params(str(orbax), torch.nn.Linear(1, 1))
    cfg = _cfg()
    cfg["MODEL"]["PRETRAINED_BACKBONE"] = str(orbax)
    with pytest.raises(NotImplementedError, match="torch_export_checkpoint"):
        train_cli.main(["-c", _write(tmp_path, cfg, "bb.yaml"), *BASE])
