"""The port's dataset adapters against their JAX twins on the roots that
``tests/test_adapters.py:make_*_root`` fabricates: every sample's label array for
array and its image bit for bit, for the single-view readers and their
multi-view groupings. Labels derived from MANO (vertices through the MANO layer,
InterHand's camera-frame root rotation) come from float32 arithmetic in two
frameworks: they are held to MANO_ATOL metres (radians for the rotation)."""

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
    make_oakink2_root,
    make_oakink_root,
    make_yt3d_root,
)

from poem_v2_tpu.data import adapters as J  # noqa: E402
from poem_v2_tpu_torch.data import adapters as T  # noqa: E402

# float32 MANO in JAX and in PyTorch: the same arithmetic in other orders
MANO_ATOL = 2e-6
SEQ = ["20200709-subject-01/20200709_141754"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _roots(tmp_path):
    return {
        "FreiHAND": (make_freihand_root, lambda m, r: m.FreiHAND(r, "train"), None),
        "DexYCB": (lambda r: make_dexycb_root(r, frames=2),
                   lambda m, r: m.DexYCB(r, sequences=SEQ),
                   lambda m, b: m.DexYCBMultiView(b, master_system="as_constant_camera")),
        "DexYCB_test": (lambda r: make_dexycb_root(r, frames=2),
                        lambda m, r: m.DexYCB(r, data_split="test", sequences=SEQ),
                        lambda m, b: m.DexYCBMultiView(b, master_system="as_first_camera")),
        "HO3D": (make_ho3d_root, lambda m, r: m.HO3DV3(r, "train"),
                 lambda m, b: m.HO3DMultiView(b, const_cam_id=1)),
        "Interhand": (make_interhand_root, lambda m, r: m.InterHand(r, "train"),
                      lambda m, b: m.InterHandMultiView(b)),
        "Oakink": (make_oakink_root, lambda m, r: m.OakInk(r, "train+val"),
                   lambda m, b: m.OakInkMultiView(b)),
        "Arctic": (make_arctic_root, lambda m, r: m.Arctic(r, "train", "p1"),
                   lambda m, b: m.ArcticMultiView(b)),
        "OakInk2": (make_oakink2_root, lambda m, r: m.OakInk2Dev(r, "train"),
                    lambda m, b: m.OakInk2MultiView(b)),
    }


MANO_KEYS = {"DexYCB": ("verts_3d",), "DexYCB_test": ("verts_3d",), "HO3D": ("verts_3d",),
             "Interhand": ("verts_3d", "mano_pose"), "Arctic": ("verts_3d",)}


def _same(got, want, loose, path):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], loose, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, loose, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if path.split(".")[-1].split("[")[0] in loose:
            np.testing.assert_allclose(got, want, rtol=0, atol=MANO_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", ["FreiHAND", "DexYCB", "DexYCB_test", "HO3D", "Interhand",
                                  "Oakink", "Arctic", "OakInk2"])
def test_adapter_equals_jax(name, tmp_path):
    make, single, multi = _roots(tmp_path)[name]
    root = make(str(tmp_path))
    jds, tds = single(J, root), single(T, root)
    assert len(tds) == len(jds) > 0
    loose = MANO_KEYS.get(name, ())
    for i in range(len(jds)):
        _same(tds.get_label(i), jds.get_label(i), loose, f"{name}[{i}]")
        np.testing.assert_array_equal(tds.get_image(i), jds.get_image(i))
        assert tds.get_sample_identifier(i) == jds.get_sample_identifier(i)
    if multi is None:
        return
    jmv, tmv = multi(J, jds), multi(T, tds)
    assert len(tmv) == len(jmv) > 0
    for i in range(len(jmv)):
        assert tmv.views_of(i) == jmv.views_of(i)
        _same(tmv[i], jmv[i], loose, f"{name} multi-view [{i}]")


def test_yt3d_equals_jax(tmp_path):
    """YT3D labels are image-space (uvd): joints from the MANO regressor's rows."""
    root = make_yt3d_root(str(tmp_path))
    jds, tds = J.YT3D(root, "train"), T.YT3D(root, "train")
    assert len(tds) == len(jds) == 2
    for i in range(2):
        for getter in ("get_joints_uvd", "get_verts_uvd", "get_image", "get_cam_intr"):
            np.testing.assert_array_equal(getattr(tds, getter)(i), getattr(jds, getter)(i))
    with pytest.raises(NotImplementedError):
        tds.get_joints_3d(0)


def test_registered_datasets_match_jax(tmp_path, monkeypatch):
    from poem_v2_tpu.utils.config import Config as JConfig
    from poem_v2_tpu.utils.registry import DATASET as JDATASET
    from poem_v2_tpu_torch.utils.config import Config as TConfig
    from poem_v2_tpu_torch.utils.registry import DATASET as TDATASET

    assert set(TDATASET.keys()) == set(JDATASET.keys())
    root = make_interhand_root(str(tmp_path))
    cfg = {"DATA_ROOT": root, "DATA_SPLIT": "train", "N_VIEWS": 2}
    for kind in ("Interhand", "InterhandMultiView"):
        got = TDATASET.get(kind)(TConfig(cfg))
        want = JDATASET.get(kind)(JConfig(cfg))
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want)
    # the video variants: windows of one sequence, every key time-major
    monkeypatch.chdir(tmp_path)  # no assets/video_task index: derived from the grouping
    for kind, make, seq_len in (("DexYCBMultiView_Video", make_dexycb_root, 3),
                                ("HO3Dv3MultiView_Video", make_ho3d_root, 2)):
        root = make(str(tmp_path / kind), frames=4)
        cfg = {"DATA_ROOT": root, "DATA_SPLIT": "train", "SEQ_LEN": seq_len}
        got, want = TDATASET.get(kind)(TConfig(cfg)), JDATASET.get(kind)(JConfig(cfg))
        assert got.windows == want.windows and len(got) > 0, kind
        _same(got[0], want[0], MANO_KEYS["DexYCB"], kind)


def test_dexycb_without_pyyaml_raises_clearly(tmp_path, monkeypatch):
    """Without PyYAML (as on the card's machine) the adapter reads the dataset's .yml
    files with the port's YAML subset reader, to the same samples."""
    from poem_v2_tpu_torch.data.adapters import dexycb
    from poem_v2_tpu_torch.utils import config

    root = make_dexycb_root(str(tmp_path))
    want = dexycb.DexYCB(root, sequences=SEQ)
    monkeypatch.setattr(config, "_yaml", lambda: None)
    got = dexycb.DexYCB(root, sequences=SEQ)
    assert len(got) == len(want) > 0
    _same(got[0], want[0], MANO_KEYS["DexYCB"], "DexYCB without PyYAML")


def test_mano_verts_follow_flat_hand_mean():
    """``flat_hand_mean=False`` adds the model's mean finger pose, as the JAX layer does."""
    from poem_v2_tpu.data.adapters.common import mano_verts as jverts
    from poem_v2_tpu_torch.data.adapters.common import mano_verts as tverts

    rs = np.random.RandomState(0)
    pose, shape = (rs.randn(48) * 0.2).astype(np.float32), rs.randn(10).astype(np.float32)
    for flat in (False, True):
        np.testing.assert_allclose(tverts(pose, shape, flat), jverts(pose, shape, flat),
                                   rtol=0, atol=MANO_ATOL)
    assert not np.allclose(tverts(pose, shape, False), tverts(pose, shape, True))


def test_adapter_decodes_on_its_device(tmp_path):
    """An adapter's raw frames decode on its ``device``: nvJPEG on a CUDA device,
    which raises here without a card or a toolkit rather than decode another way."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke phase 7 holds nvJPEG")
    ds = T.FreiHAND(make_freihand_root(str(tmp_path)), "train")
    assert ds.get_image(0).shape == (32, 32, 3)  # OpenCV, on the CPU
    ds.device = "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        ds.get_image(0)

