"""The port's data layer against the JAX package's on the CPU: tar shards written
by ``tests/test_data.py:make_shard``, ``process_data_item`` sample for sample
(augmentation off and on, under the same seeds), every transform class, the
native warp, the thread and process pools, ``MixWebDataset``'s order, the
dumper's bytes and ``create_dataset``'s routing. Everything is exact: the same
OpenCV decode, ``native/warp.cc`` built with the same flags, the same RNG
streams."""

import os
import random

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_data import make_shard  # noqa: E402

from poem_v2_tpu.data import native_ops as jnative  # noqa: E402
from poem_v2_tpu.data import wds as jwds  # noqa: E402
from poem_v2_tpu.data.dumper import ShardDumper as JDumper  # noqa: E402
from poem_v2_tpu.utils.config import Config as JConfig  # noqa: E402
from poem_v2_tpu_torch.data import native_ops as tnative  # noqa: E402
from poem_v2_tpu_torch.data import wds as twds  # noqa: E402
from poem_v2_tpu_torch.data.dumper import ShardDumper as TDumper  # noqa: E402
from poem_v2_tpu_torch.utils.config import Config as TConfig  # noqa: E402

TRANSFORMS = ("SimpleTransform3DMultiView", "SimpleTransform2D", "SimpleTransformUVD",
              "SimpleTransform3D", "SimpleTransform3DMANO")
PRESET = {"IMAGE_SIZE": [64, 64], "CENTER_IDX": 0, "NUM_JOINTS": 21, "WITH_HEATMAP": True,
          "HEATMAP_SIZE": [16, 16]}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shards") / "Test_mv_train-000000.tar")
    return make_shard(path, n_samples=4, n_cams=3, img_size=96, seed=3)


def ds_cfg(urls, transform="SimpleTransform3DMultiView", aug=False, random_n_views=True,
           **extra):
    return {"URLS": urls, "DATA_SPLIT": "train", "RANDOM_N_VIEWS": random_n_views,
            "VIEW_RANGE": [1, 3], "TRANSFORM": {
                "TYPE": transform, "AUG": aug, "CENTER_JIT": 0.05, "SCALE_JIT": 0.06,
                "ROT_JIT": 5, "COLOR_JIT": 0.3, "ROT_PROB": 0.5, "OCCLUSION": aug,
                "OCCLUSION_PROB": 0.5}, **extra}


def datasets(cfg, is_train=True, preset=PRESET):
    return (jwds.MultiviewWebDataset(JConfig(cfg), data_preset=JConfig(preset), is_train=is_train),
            twds.MultiviewWebDataset(TConfig(cfg), data_preset=TConfig(preset), is_train=is_train))


def assert_same(got, want, path=""):
    """Equal value for value: arrays bit for bit, with the same dtype and shape."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def seeded(ds, seed):
    """The dataset's samples with the global generators (augmentation's draws) seeded."""
    np.random.seed(seed)
    random.seed(seed)
    return list(ds)


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_samples_equal_jax_for_every_transform(shard, transform, aug):
    jds, tds = datasets(ds_cfg(shard, transform, aug=aug))
    want, got = seeded(jds, 7), seeded(tds, 7)
    assert len(got) == len(want) == 4
    assert_same(got, want)
    if aug:  # the augmentation did draw: the crops differ from the un-augmented ones
        plain = seeded(datasets(ds_cfg(shard, transform))[1], 7)
        assert any(a["image"].shape != b["image"].shape or not np.array_equal(a["image"],
                   b["image"]) for a, b in zip(got, plain))


def test_eval_stream_equals_jax(shard):
    """The eval protocol's form: no augmentation, no shuffle buffer, random views."""
    jds, tds = datasets(ds_cfg(shard), is_train=False)
    assert_same(list(tds), list(jds))


def test_request_flip_equals_jax(tmp_path):
    """request_flip reflects each view about its principal point: the port's numpy
    warp gives cv2.warpAffine's pixels (principal points off the pixel grid too)."""
    import pickle
    import tarfile

    src = make_shard(str(tmp_path / "src.tar"), n_samples=2, n_cams=2, img_size=48, seed=5)
    out = str(tmp_path / "Test_mv_train-000000.tar")
    with tarfile.open(src) as tin, tarfile.open(out, "w") as tout:
        for m in tin.getmembers():
            data = tin.extractfile(m).read()
            if m.name.endswith("label.pyd"):
                label = pickle.loads(data)
                label["request_flip"] = True
                for k, intr in enumerate(label["cam_intr"]):
                    intr[0, 2] += 0.37 * (k + 1)
                data = pickle.dumps(label)
                m.size = len(data)
            tout.addfile(m, __import__("io").BytesIO(data))
    jds, tds = datasets(ds_cfg(out, random_n_views=False))
    assert_same(list(tds), list(jds))


@pytest.mark.parametrize("jitter", [False, True])
def test_native_warp_bitwise(jitter):
    assert jnative.get_lib() is not None, "the JAX package's native warp did not build"
    rs = np.random.RandomState(11)
    img = rs.randint(0, 256, (67, 91, 3)).astype(np.uint8)
    for rot in (0.0, 0.4):
        c, s = np.cos(rot), np.sin(rot)
        aff = np.array([[0.7 * c, -0.7 * s, 3.3], [0.7 * s, 0.7 * c, -5.1]], np.float32)
        cj = np.array([0.8, 1.1, 1.3], np.float32) if jitter else None
        want = jnative.warp_affine_normalize(img, aff, (40, 56), color_jitter=cj)
        got = tnative.warp_affine_normalize(img, aff, (40, 56), color_jitter=cj)
        assert got.dtype == np.float32 and got.shape == (40, 56, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,workers", [("thread", 3), ("process", 2)])
def test_pools_equal_serial(shard, mode, workers):
    """Both pools yield the serial path's samples in its order, random views
    included (each sample seeded from its position)."""
    serial = list(datasets(ds_cfg(shard, random_n_views=False))[1])
    pooled = list(datasets(ds_cfg(shard, random_n_views=False, WORKERS=workers,
                                  WORKERS_MODE=mode))[1])
    assert_same(pooled, serial)
    jds, tds = datasets(ds_cfg(shard, WORKERS=workers, WORKERS_MODE=mode))
    assert_same(list(tds), list(jds))


def test_mix_order_equals_jax(tmp_path):
    shards = [make_shard(str(tmp_path / f"{n}_mv_train-000000.tar"), n_samples=3, n_cams=2,
                         img_size=32, seed=k) for k, n in enumerate(("Aa", "Bb"))]
    mix = {"TYPE": "MixWebDataset", "DATASET_LIST": ["A", "B"],
           "A": {**ds_cfg(shards[0]), "MIX_RATIO": 0.7},
           "B": {**ds_cfg(shards[1]), "MIX_RATIO": 0.3}}
    from poem_v2_tpu.data import create_dataset as jcreate
    from poem_v2_tpu_torch.data import create_dataset as tcreate

    preset = {**PRESET, "IMAGE_SIZE": [32, 32]}
    want = list(jcreate(JConfig(mix), data_preset=JConfig(preset)))
    got = list(tcreate(TConfig(mix), data_preset=TConfig(preset)))
    assert [s["__key__"] for s in got] == [s["__key__"] for s in want]
    assert len(got) == 6
    assert_same(got, want)


def _dump(dumper_cls, out, rs):
    with dumper_cls(str(out), "Round_mv_test", samples_per_shard=2) as d:
        for s in range(3):
            imgs = [(rs.rand(24, 40, 3) * 255).astype(np.uint8) for _ in range(2)]
            d.add_sample(f"k.{s:06d}", imgs, {"joints_3d": [np.full((21, 3), s, np.float32)] * 2,
                                              "cam_serial": ["a", "b"]})
    return sorted(os.listdir(out))


def test_dumper_bytes_equal_jax(tmp_path):
    names_j = _dump(JDumper, tmp_path / "j", np.random.RandomState(0))
    names_t = _dump(TDumper, tmp_path / "t", np.random.RandomState(0))
    assert names_t == names_j == ["Round_mv_test-000000.tar", "Round_mv_test-000001.tar"]
    for n in names_j:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    # the dotted key was sanitised, and the port's reader decodes what it wrote
    samples = [twds.decode_sample(s) for s in twds.iter_tar_samples(str(tmp_path / "t" /
                                                                         names_t[0]))]
    assert [s["__key__"] for s in samples] == ["k_000000", "k_000001"]
    assert samples[0]["image_1.jpg"].shape == (24, 40, 3)


def test_create_dataset_routes_like_jax(tmp_path, shard):
    from test_adapters import make_freihand_root

    from poem_v2_tpu.data import create_dataset as jcreate
    from poem_v2_tpu_torch.data import adapters, create_dataset as tcreate

    for kind in ("MultiviewWebDataset", "WebDataset"):
        ds = tcreate(TConfig(ds_cfg(shard, TYPE=kind)), data_preset=TConfig(PRESET),
                     device="cpu")
        assert type(ds) is twds.MultiviewWebDataset and ds.device == "cpu"
    root = make_freihand_root(str(tmp_path))
    cfg = {"TYPE": "FreiHAND", "DATA_ROOT": root, "DATA_SPLIT": "train"}
    got, want = tcreate(TConfig(cfg)), jcreate(JConfig(cfg))
    assert type(got) is adapters.FreiHAND and len(got) == len(want) == 6
    assert got.device == "cpu"
    # an adapter decodes its raw frames on the caller's device, through the
    # multi-view wrapper to the dataset underneath
    from test_adapters import make_interhand_root

    assert tcreate(TConfig(cfg), device="cuda").device == "cuda"
    mv_cfg = {"TYPE": "InterhandMultiView", "DATA_ROOT": make_interhand_root(str(tmp_path)),
              "DATA_SPLIT": "train", "N_VIEWS": 2}
    mv = tcreate(TConfig(mv_cfg), device="cuda")
    assert type(mv) is adapters.InterHandMultiView
    assert mv.device == mv.base.device == "cuda"
    if not torch.cuda.is_available():  # nvJPEG, never OpenCV: raises without a card
        with pytest.raises((RuntimeError, AssertionError)):
            mv[0]
    with pytest.raises(ValueError, match="unknown dataset TYPE"):
        tcreate(TConfig({"TYPE": "NoSuchSet"}))


def test_decode_sample_on_the_card_takes_nvjpeg_without_a_card(shard):
    """A CUDA device never drops to OpenCV: without a card (or its nvJPEG) the
    decode raises rather than decode another way."""
    raw = next(twds.iter_tar_samples(shard))
    with pytest.raises((RuntimeError, AssertionError)):
        twds.decode_sample(raw, "cuda")


def test_dump_shards_script_equals_jax(tmp_path):
    """scripts/torch_dump_shards.py against scripts/dump_shards.py: the same tar
    members, the same JPEG bytes, the labels array for array (the synthetic
    generators' metres and pixels agree to float32 rounding: 1e-6 relative and
    2e-6 absolute), and shards the port streams."""
    import pickle
    import sys
    import tarfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts"))
    try:
        from dump_shards import main as jmain
        from torch_dump_shards import main as tmain
    finally:
        sys.path.pop(0)
    argv = ["--prefix", "Synth_mv_train", "--num", "3", "--views", "2", "--image-size", "32",
            "--per-shard", "2"]
    jmain(["--out", str(tmp_path / "j"), *argv])
    tmain(["--out", str(tmp_path / "t"), *argv, "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 2
    for n in names:
        with tarfile.open(tmp_path / "j" / n) as tj, tarfile.open(tmp_path / "t" / n) as tt:
            mj, mt = tj.getmembers(), tt.getmembers()
            assert [m.name for m in mt] == [m.name for m in mj]
            for a, b in zip(mt, mj):
                got, want = tt.extractfile(a).read(), tj.extractfile(b).read()
                if a.name.endswith(".jpg"):
                    assert got == want, a.name
                    continue
                got, want = pickle.loads(got), pickle.loads(want)
                assert set(got) == set(want)
                for k in want:
                    for g, w in zip(got[k], want[k]):
                        if isinstance(w, str):
                            assert g == w
                        else:
                            np.testing.assert_allclose(np.asarray(g, np.float64),
                                                       np.asarray(w, np.float64), rtol=1e-6,
                                                       atol=2e-6, err_msg=k)
    ds = twds.MultiviewWebDataset(
        TConfig({"URLS": str(tmp_path / "t" / "Synth_mv_train-{000000..000001}.tar"),
                 "RANDOM_N_VIEWS": False, "TRANSFORM": {"TYPE": "SimpleTransform3DMultiView"}}),
        data_preset=TConfig({"IMAGE_SIZE": [32, 32]}), is_train=False)
    assert len(list(ds)) == 3
