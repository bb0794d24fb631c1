"""The port's front-door modules against the JAX package's on the CPU: the
synthetic configs as data, ``get_config``, collation and the synthetic
dataset, the metrics and the Evaluator's measures (the JAX Evaluator fed the
same predictions through a stub of its jitted step)."""

import argparse
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from poem_v2_tpu_torch import configs as tconfigs
from poem_v2_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC_YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "synthetic_*.yaml")))


@pytest.mark.parametrize("path", SYNTHETIC_YAMLS, ids=os.path.basename)
def test_synthetic_config_dicts_match_their_yaml(path):
    name = os.path.basename(path)[:-len(".yaml")]
    with open(path) as f:
        assert tconfigs.SYNTHETIC[name] == yaml.safe_load(f)


def test_all_synthetic_yamls_are_held():
    assert len(SYNTHETIC_YAMLS) == 7
    assert {os.path.basename(p)[:-5] for p in SYNTHETIC_YAMLS} == set(tconfigs.SYNTHETIC)


def _args(**kw):
    base = dict(batch_size=None, reload=None, val_batch_size=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("path", [os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
                                  os.path.join(REPO, "configs", "synthetic_overfit_gate.yaml"),
                                  os.path.join(REPO, "configs", "release", "train_medium.yaml")],
                         ids=os.path.basename)
@pytest.mark.parametrize("kw", [{}, {"batch_size": 3}, {"reload": "exp/x/checkpoint.pt"},
                                {"val_batch_size": 5, "batch_size": 2}],
                         ids=["none", "b", "reload", "val_b"])
def test_get_config_merges_like_jax(path, kw):
    from poem_v2_tpu.utils.config import get_config as jget

    want = jget(path, arg=_args(**kw), merge=True)
    got = tconfig.get_config(path, arg=_args(**kw), merge=True)
    assert got.to_dict() == want.to_dict()
    assert got.frozen
    with pytest.raises(AttributeError, match="frozen"):
        got.TRAIN.BATCH_SIZE = 1
    # merge=False leaves the file's values
    assert tconfig.get_config(path, arg=_args(**kw), merge=False).to_dict() == \
        jget(path, arg=_args(**kw), merge=False).to_dict()


def test_get_config_without_yaml_reads_known_configs(monkeypatch, tmp_path):
    """Without PyYAML a config file is read by the port's YAML subset reader (the
    same tree as PyYAML's); another file is read the same way, and text outside
    the subset raises with its line."""
    smoke = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
    medium = os.path.join(REPO, "configs", "release", "train_medium.yaml")
    with_yaml = tconfig.get_config(smoke, arg=_args(batch_size=2))
    monkeypatch.setattr(tconfig, "_yaml", lambda: None)
    assert tconfig.get_config(smoke, arg=_args(batch_size=2)).to_dict() == with_yaml.to_dict()
    got = tconfig.get_config(medium).to_dict()
    with open(medium) as f:
        file_cfg = yaml.safe_load(f)
    for section in ("TRAIN", "MODEL", "DATA_PRESET"):
        want = {**tconfig.DEFAULT_TRAIN, **file_cfg["TRAIN"]} if section == "TRAIN" \
            else file_cfg[section]
        assert got[section] == want, section
    other = tmp_path / "my_experiment.yaml"
    other.write_text("TRAIN: {BATCH_SIZE: 2}\n")
    assert tconfig.get_config(str(other)).TRAIN.BATCH_SIZE == 2
    other.write_text("TRAIN:\n  NOTE: |\n    text\n")
    with pytest.raises(tconfig.YAMLSubsetError, match="my_experiment.yaml:2: "):
        tconfig.get_config(str(other))
    # a dict is taken as the file's contents; the dump is YAML either way
    cfg = tconfig.get_config(tconfigs.SYNTHETIC_SMOKE)
    assert yaml.safe_load(cfg.dump()) == tconfig.parse_yaml(cfg.dump()) == cfg.to_dict()


def test_config_node_behaves_like_jax():
    from poem_v2_tpu.utils.config import Config as JConfig

    tree = {"A": {"B": [1, {"C": 2}], "D": None}, "E": (1, 2)}
    j, t = JConfig(tree), tconfig.Config(tree)
    assert t.to_dict() == j.to_dict()
    assert t.A.B[1].C == 2
    t.merge({"A": {"D": 3}, "F": {"G": 1}})
    j.merge({"A": {"D": 3}, "F": {"G": 1}})
    assert t.to_dict() == j.to_dict()
    c = t.clone().freeze()
    with pytest.raises(AttributeError):
        c.A.B[1].C = 5
    c.defrost()
    c.A.B[1].C = 5
    assert t.A.B[1].C == 2
    assert yaml.safe_load(t.dump()) == j.to_dict()


# ---- data ---------------------------------------------------------------------

def _samples(rs, n=3, view_max=4):
    out = []
    for _ in range(n):
        v = rs.randint(1, view_max + 2)  # one more than view_max: truncated
        out.append({"image": rs.rand(v, 8, 8, 3).astype(np.float32),
                    "target_cam_intr": rs.rand(v, 3, 3).astype(np.float32),
                    "target_cam_extr": rs.rand(v, 4, 4).astype(np.float32),
                    "target_joints_2d": rs.rand(v, 21, 2),
                    "master_joints_3d": rs.rand(21, 3), "master_verts_3d": rs.rand(778, 3),
                    "mano_pose": rs.rand(v, 16, 3), "mano_shape": rs.rand(v, 10)})
    return out


def _same_batches(got, want, atol=0.0):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            if atol:
                np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_collate_and_batch_iterator_match_jax():
    from poem_v2_tpu.data import collate as jc
    from poem_v2_tpu_torch.data import collate as tc

    rs = np.random.RandomState(0)
    samples = _samples(rs, n=7)
    for view_max in (2, 4):
        _same_batches([tc.collate_padded(samples, view_max)],
                      [jc.collate_padded(samples, view_max)])
        for bs, epoch in ((2, 0), (3, 5)):
            _same_batches(list(tc.batch_iterator(samples, bs, view_max, epoch)),
                          list(jc.batch_iterator(samples, bs, view_max, epoch)))
    a = rs.rand(3, 2)
    np.testing.assert_array_equal(tc.pad_views(a, 5), jc.pad_views(a, 5))


@pytest.mark.parametrize("name", ["synthetic_smoke", "synthetic_overfit_hires"])
def test_create_dataset_synthetic_matches_jax(name):
    """The same seed gives the same batches: the draws that do not pass through
    the hand (images, view masks, intrinsics, pose and shape) exactly; the MANO
    joints and vertices, and the cameras aimed at them and the projected joints,
    to float32 rounding (two skinning codes)."""
    from poem_v2_tpu.data import batch_iterator as jbatches, create_dataset as jcreate
    from poem_v2_tpu.utils.config import Config
    from poem_v2_tpu_torch.data import batch_iterator as tbatches, create_dataset as tcreate

    cfg = tconfigs.SYNTHETIC[name]
    data = dict(cfg["DATASET"]["TRAIN"], EPOCH_SIZE=6)
    vm = data["VIEW_MAX"]
    jds, tds = jcreate(Config(data)), tcreate(tconfig.Config(data))
    for _ in range(2):  # a fixed set replays its samples; a stream draws new ones
        want = list(jbatches(jds, 3, vm, 6))
        got = list(tbatches(tds, 3, vm, 6))
        pick = lambda bs, keys: [{k: v for k, v in b.items() if k in keys} for b in bs]
        exact = ("image", "view_mask", "cam_intr", "mano_pose", "mano_shape")
        _same_batches(pick(got, exact), pick(want, exact))
        metres = ("master_joints_3d", "master_verts_3d", "cam_extr")
        _same_batches(pick(got, metres), pick(want, metres), atol=2e-6)
        _same_batches(pick(got, ("target_joints_2d",)), pick(want, ("target_joints_2d",)),
                      atol=1e-3 * data["IMAGE_SIZE"] / 64)  # pixels
        assert set(got[0]) == set(want[0])


# the webdataset and adapter TYPEs route since the data layer was ported
# (tests/test_torch_data.py::test_create_dataset_routes_like_jax), and RENDER
# since ROADMAP queue 1's item 8 (tests/test_torch_render_data.py holds its pixels)
@pytest.mark.parametrize("changes,match", [({"RENDER": True}, "item 8")])
def test_create_dataset_raises_for_what_waits(changes, match):
    from poem_v2_tpu_torch.data import create_dataset

    data = dict(tconfigs.SYNTHETIC_SMOKE["DATASET"]["TEST"], EPOCH_SIZE=1, **changes)
    sample, = list(create_dataset(tconfig.Config(data)))
    assert sample["image"].max() > 0.45, f"{match}: RENDER draws the skeleton"


# ---- metrics ------------------------------------------------------------------

def _pred_gt(rs, B, N, noise=0.01):
    gt = rs.normal(0, 0.05, (B, N, 3)).astype(np.float32)
    gt[..., 2] += 0.5
    q = np.linalg.qr(rs.randn(3, 3))[0].astype(np.float32)
    pred = (gt @ q * 1.1 + 0.02 + rs.normal(0, noise, (B, N, 3))).astype(np.float32)
    return pred, gt


def test_loss_metric_and_mean_epe_match_jax():
    from poem_v2_tpu.metrics import LossMetric as JL, MeanEPE as JE
    from poem_v2_tpu_torch.metrics import LossMetric as TL, MeanEPE as TE

    rs = np.random.RandomState(1)
    jl, tl, je, te = JL(), TL(), JE("joints_3d"), TE("joints_3d")
    for bs in (2, 3, 5):
        d = {"loss": rs.rand(), "loss_3d_jts": rs.rand()}
        jl.feed(d, bs)
        tl.feed(d, bs)
        p, g = _pred_gt(rs, bs, 21)
        assert te.feed(p, g) == je.feed(p, g)
    assert tl.get_measures() == jl.get_measures() and str(tl) == str(jl)
    assert te.get_measures() == je.get_measures()
    tl.reset()
    assert tl.get_loss("loss") == 0.0


def test_align_w_scale_and_pa_match_jax():
    from poem_v2_tpu.geometry.procrustes import align_w_scale as jalign
    from poem_v2_tpu.metrics import PAEval as JPA
    from poem_v2_tpu_torch.geometry.procrustes import align_w_scale as talign
    from poem_v2_tpu_torch.metrics import PAEval as TPA

    rs = np.random.RandomState(2)
    p, g = _pred_gt(rs, 4, 778)
    got = talign(torch.from_numpy(g), torch.from_numpy(p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jalign(jnp.asarray(g), jnp.asarray(p))),
                               atol=2e-6, rtol=0)
    jpa, tpa = JPA(), TPA()
    for _ in range(2):
        pj, gj = _pred_gt(rs, 3, 21)
        pv, gv = _pred_gt(rs, 3, 778)
        jpa.feed(pj, gj, pv, gv)
        tpa.feed(torch.from_numpy(pj), torch.from_numpy(gj), pv, gv)  # tensors or arrays
    want = jpa.get_measures()
    for k, v in tpa.get_measures().items():
        assert v == pytest.approx(want[k], rel=1e-5, abs=1e-8), k


def test_pck_auc_matches_jax():
    from poem_v2_tpu.metrics import Joint3DPCK as JJ, Vert3DPCK as JV
    from poem_v2_tpu_torch.metrics import Joint3DPCK as TJ, Vert3DPCK as TV

    rs = np.random.RandomState(3)
    for jcls, tcls, n in ((JJ, TJ, 21), (JV, TV, 778)):
        j, t = jcls(val_max=0.02, steps=20), tcls(val_max=0.02, steps=20)
        for _ in range(2):
            _, g = _pred_gt(rs, 3, n)
            p = (g + rs.normal(0, 0.006, g.shape)).astype(np.float32)
            j.feed(p, g)
            t.feed(p, g)
        assert t.get_auc() == pytest.approx(j.get_auc(), abs=1e-12)
        assert 0.0 < t.get_auc() < 1.0
        for a, b in zip(t.pck_curve(), j.pck_curve()):
            np.testing.assert_array_equal(a, b)
        assert t.get_measures() == j.get_measures()


# ---- the Evaluator --------------------------------------------------------------

def _eval_batches(rs, n_batches=3, B=2, V=2):
    from poem_v2_tpu_torch.data import SyntheticMultiviewDataset

    ds = SyntheticMultiviewDataset(batch_size=B, view_max=V, view_range=(1, V), image_size=16,
                                   seed=4)
    batches = [ds.sample_batch() for _ in range(n_batches)]
    preds = []
    for b in batches:
        pv = (b["master_verts_3d"] + rs.normal(0, 0.01, b["master_verts_3d"].shape)
              ).astype(np.float32)
        pj = (b["master_joints_3d"] + rs.normal(0, 0.01, b["master_joints_3d"].shape)
              ).astype(np.float32)
        pr = (b["master_joints_3d"] + rs.normal(0, 0.02, b["master_joints_3d"].shape)
              ).astype(np.float32)
        preds.append((pj, pv, pr))
    return batches, preds


def test_evaluator_measures_match_jax():
    """The port's Evaluator and the JAX Evaluator on the same batches and the
    same predictions (each side's model step stubbed to return them): every
    measure, and the AUC callback's, to float32 rounding."""
    from helpers import TINY_MODEL_CFG
    from poem_v2_tpu.models.poem import create_poem_model as jcreate
    from poem_v2_tpu.training.evaluator import AUCCallback as JAUC, Evaluator as JEval
    from poem_v2_tpu_torch.mano.layer import ManoLayer
    from poem_v2_tpu_torch.training.evaluator import AUCCallback as TAUC, Evaluator as TEval

    batches, preds = _eval_batches(np.random.RandomState(5))
    jmodel, jaux = jcreate(TINY_MODEL_CFG, use_flash=False)
    jev = JEval(jmodel, jaux, center_idx=0)
    it = iter(preds)
    jev._eval_step = lambda *a: tuple(jnp.asarray(x) for x in next(it))
    jcb = JAUC()
    want = jev.run(None, batches, callback=jcb)

    tev = TEval(torch.nn.Linear(1, 1), {"j_regressor": ManoLayer().j_regressor}, center_idx=0)
    it2 = iter(preds)
    tev.predict = lambda batch: tuple(torch.from_numpy(x) for x in next(it2))
    tcb = TAUC()
    got = tev.run(batches, callback=tcb)

    assert set(got) == set(want)
    for k, v in want.items():
        assert np.isfinite(got[k]) and got[k] == pytest.approx(float(v), rel=1e-5), k
    assert tcb.auc_j == pytest.approx(jcb.pck_j.get_auc(), abs=1e-6)
    assert tcb.auc_v == pytest.approx(jcb.pck_v.get_auc(), abs=1e-6)
    # the meters restart on every run (the JAX Evaluator's keep summing)
    it2 = iter(preds)
    assert tev.run(batches) == got
