"""The port stands alone: no JAX, flax, optax, orbax, PyYAML or poem_v2_tpu anywhere in it,
and it draws without OpenCV, matplotlib, tqdm or open3d."""

import ast
import os
import subprocess
import sys

import pytest

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "poem_v2_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "poem_v2_tpu")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_import_in_sources():
    bad = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(root, f)
                bad += [(p, m) for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


# what the JAX package draws with; the card's machine has none of them. The one
# import of them in the port: OpenCV's JPEG codec on the CPU, inside a function of
# data/codec.py (a CUDA device decodes with nvJPEG; PNG is the port's own)
DRAWING_LIBS = ("cv2", "matplotlib", "tqdm", "open3d", "PIL")
ALLOWED = {(os.path.join("data", "codec.py"), "cv2")}


def test_no_drawing_library_import_in_sources():
    bad = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(root, f)
                rel = os.path.relpath(p, PKG)
                bad += [(rel, m) for m in _imported_roots(p)
                        if m in DRAWING_LIBS and (rel, m) not in ALLOWED]
    assert not bad, bad


_SCRIPT = r"""
import copy, importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %(forbidden)r:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import numpy as np, torch
import poem_v2_tpu_torch
for m in pkgutil.walk_packages(poem_v2_tpu_torch.__path__, "poem_v2_tpu_torch."):
    importlib.import_module(m.name)
from poem_v2_tpu_torch.configs import MEDIUM_MANO
from poem_v2_tpu_torch.serving.predictor import Predictor

cfg = copy.deepcopy(MEDIUM_MANO)  # the parametric head: rotations and the MANO layer run too
m = cfg["MODEL"]
m["BACKBONE"]["WIDTH"] = 8
h = m["HEAD"]
h.update(EMBED_DIMS=32, POINTS_FEAT_DIM=32, IN_CHANNELS=32, N_SAMPLE=256)
h["POSITIONAL_ENCODING"]["NUM_FEATS"] = 16
h["TRANSFORMER"].update(N_BLOCKS=2, INPUT_FEAT_DIM=32, N_NEIGHBOR=8, N_NEIGHBOR_QUERY=8)
pred = Predictor.from_config(cfg, dtype=torch.float32, device="cpu", view_bucket=2)
rs = np.random.RandomState(0)
images = rs.randint(0, 256, (2, 2, 64, 64, 3)).astype(np.uint8)
intr = np.tile((np.eye(3) * [80, 80, 1] + [[0, 0, 32], [0, 0, 32], [0, 0, 0]])[None, None], (2, 2, 1, 1))
extr = np.tile(np.eye(4)[None, None], (2, 2, 1, 1))
extr[:, 1, :3, 3] = [0.1, 0.0, 0.0]
mask = np.array([[True, True], [True, False]])  # mixed view counts: the scramble's gather runs
out = pred(images, intr.astype(np.float32), extr.astype(np.float32), mask)
assert out["verts_3d"].shape == (2, 778, 3) and np.isfinite(out["verts_3d"]).all()
leaked = [k for k in sys.modules if k.split(".")[0] in %(forbidden)r]
assert not leaked, leaked
print("ok")
"""


def test_cpu_forward_without_jax_or_yaml():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT % {"forbidden": FORBIDDEN}],
                          capture_output=True, text=True, env=env, timeout=300,
                          cwd=os.path.dirname(PKG))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


_NO_CV2_SCRIPT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %(blocked)r:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import numpy as np
import poem_v2_tpu_torch
for m in pkgutil.walk_packages(poem_v2_tpu_torch.__path__, "poem_v2_tpu_torch."):
    importlib.import_module(m.name)
from poem_v2_tpu_torch.data import codec

fixtures = "tests/torch_fixtures/codec/"
img = codec.decode_image(open(fixtures + "source.png", "rb").read())
assert (img == np.load(fixtures + "decodes.npz")["source"]).all()
try:
    codec.decode_image(open(fixtures + "q95_224x224.jpg", "rb").read(), "cpu")
except RuntimeError as e:
    assert "OpenCV" in str(e), e
else:
    raise AssertionError("JPEG decode on the CPU without OpenCV did not raise")
leaked = [k for k in sys.modules if k.split(".")[0] in %(blocked)r]
assert not leaked, leaked
print("ok")
"""


def test_every_module_imports_without_cv2_pil_or_yaml():
    """As on the card's machine: no OpenCV, PIL or PyYAML. Every module of the port
    imports, a PNG decodes, and a JPEG on the CPU raises, naming OpenCV."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    blocked = FORBIDDEN + ("cv2", "PIL")
    proc = subprocess.run([sys.executable, "-c", _NO_CV2_SCRIPT % {"blocked": blocked}],
                          capture_output=True, text=True, env=env, timeout=300,
                          cwd=os.path.dirname(PKG))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


_DRAW_SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %(blocked)r:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import numpy as np, torch
import poem_v2_tpu_torch
for m in pkgutil.walk_packages(poem_v2_tpu_torch.__path__, "poem_v2_tpu_torch."):
    importlib.import_module(m.name)
from poem_v2_tpu_torch import viztools
from poem_v2_tpu_torch.cli import demo
from poem_v2_tpu_torch.configs import SYNTHETIC
from poem_v2_tpu_torch.data import create_dataset
from poem_v2_tpu_torch.data.codec import decode_png
from poem_v2_tpu_torch.training.draw_callback import DrawingHandCallback
from poem_v2_tpu_torch.utils.config import Config, dump_yaml, get_config
from poem_v2_tpu_torch.utils.etqdm import etqdm

torch.set_num_threads(1)
tmp = tempfile.mkdtemp()
cfg = get_config(os.path.join("configs", "synthetic_overfit_gate.yaml"))  # the subset reader
data = dict(cfg.DATASET.TRAIN.to_dict(), EPOCH_SIZE=1, IMAGE_SIZE=64, VIEW_MAX=2,
            VIEW_RANGE=[2, 2])
sample, = list(etqdm(create_dataset(Config(data)), desc="render"))
img = viztools.denormalize_image(sample["image"][0])
drawn = viztools.draw_joints_2d(img, sample["target_joints_2d"][0])
intr = sample["target_cam_intr"][0]
faces = np.arange(776)[:, None] + np.arange(3)[None]
mesh = viztools.render_mesh_overlay(img, sample["master_verts_3d"], faces, intr)
viztools.draw_wireframe_hand_large(drawn, sample["target_joints_2d"][0])
cap = viztools.caption_combined_view(viztools.combine_view([drawn, mesh]), "gate")
ctx = viztools.VizContext(image_size=48, save_dir=tmp)
ctx.update_by_mesh("hand", sample["master_verts_3d"], np.array([[0, 1, 2], [2, 3, 4]]), "red")
ctx.run(n_steps=1)
cb = DrawingHandCallback(tmp, max_samples=1)
preds = {"pred_joints_3d": sample["master_joints_3d"][None],
         "pred_verts_3d": sample["master_verts_3d"][None]}
batch = {"image": sample["image"][None], "view_mask": np.ones((1, 2), bool),
         "cam_intr": sample["target_cam_intr"][None], "cam_extr": sample["target_cam_extr"][None],
         "master_joints_3d": sample["master_joints_3d"][None],
         "master_verts_3d": sample["master_verts_3d"][None]}
cb(preds, {k: torch.as_tensor(v) for k, v in batch.items()}, 0)
grid = decode_png(open(os.path.join(tmp, "draws", "step00000_s0.png"), "rb").read())
assert grid.shape == (64, 128, 3) and len(os.listdir(os.path.join(tmp, "draws"))) == 5
# the demo on the synthetic smoke model, its config read by the subset reader
path = os.path.join(tmp, "demo.yaml")
small = SYNTHETIC["synthetic_smoke"]
open(path, "w").write(dump_yaml({"MODEL": small["MODEL"], "DATA_PRESET": small["DATA_PRESET"]}))
out = demo.main(["-c", path, "--out", os.path.join(tmp, "demo"), "--batch", "1", "--views",
                 "2", "--dtype", "fp32", "--device", "cpu"])
assert np.isfinite(out["verts_3d"]).all() and os.path.exists(os.path.join(tmp, "demo",
                                                                          "demo_0.png"))
leaked = [k for k in sys.modules if k.split(".")[0] in %(blocked)r]
assert not leaked, leaked
print("ok")
"""


def test_drawing_path_runs_without_opencv_matplotlib_tqdm_open3d_or_yaml():
    """As on the card's machine: the RENDER dataset, the viztools, the draw callback
    and the demo run without OpenCV, matplotlib, open3d, PIL, PyYAML or JAX, and
    none of them is imported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    env["OMP_NUM_THREADS"] = "1"
    # tqdm stays importable: torch's own compiler stack imports it where it is
    # installed (the static check above holds the port to none)
    blocked = FORBIDDEN + tuple(m for m in DRAWING_LIBS if m != "tqdm")
    proc = subprocess.run([sys.executable, "-c", _DRAW_SCRIPT % {"blocked": blocked}],
                          capture_output=True, text=True, env=env, timeout=300,
                          cwd=os.path.dirname(PKG))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


_BASELINE_SCRIPT = r"""
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %(forbidden)r:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import torch
mod = importlib.import_module(%(module)r)
leaked = [k for k in sys.modules if k.split(".")[0] in %(forbidden)r]
assert not leaked, leaked
if %(factory)r and not torch.cuda.is_available():
    from poem_v2_tpu_torch.configs import BASELINES
    try:
        getattr(mod, %(factory)r)(BASELINES[%(cfg)r])
    except RuntimeError as e:
        assert "CUDA" in str(e) and 'device="cpu"' in str(e), e
    else:
        raise AssertionError("built on the default device without a card")
print("ok")
"""


@pytest.mark.parametrize("module,factory,cfg", [
    ("poem_v2_tpu_torch.models.bricks.transformer_layer", "", ""),
    ("poem_v2_tpu_torch.models.petr", "create_petr_model", "PETR"),
    ("poem_v2_tpu_torch.models.mvp", "create_mvp_model", "MVP"),
])
def test_baseline_modules_stand_alone(module, factory, cfg):
    """Each baseline module imports alone with JAX, flax, PyYAML and the JAX package
    blocked; its factory targets the card by default and, without one, raises."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    script = _BASELINE_SCRIPT % {"forbidden": FORBIDDEN, "module": module, "factory": factory,
                                 "cfg": cfg}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=300, cwd=os.path.dirname(PKG))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


_AUX_SCRIPT = r"""
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %(forbidden)r:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import torch
mod = importlib.import_module(%(module)r)
leaked = [k for k in sys.modules if k.split(".")[0] in %(forbidden)r]
assert not leaked, leaked
if %(call)r and not torch.cuda.is_available():
    try:
        eval(%(call)r, {"mod": mod})
    except RuntimeError as e:
        assert "CUDA" in str(e) and 'device="cpu"' in str(e), e
    else:
        raise AssertionError("built on the default device without a card")
print("ok")
"""


@pytest.mark.parametrize("module,call", [
    ("poem_v2_tpu_torch.models.cmr", "mod.create_cmr_model()"),
    ("poem_v2_tpu_torch.models.pose2d", "mod.create_integral_pose({'BACKBONE': {'TYPE': "
     "'resnet18'}, 'HEAD': {}})"),
    ("poem_v2_tpu_torch.models.pose2d", "mod.create_darkpose({'BACKBONE': {'TYPE': 'resnet18'}})"),
    ("poem_v2_tpu_torch.models.backbones.hourglass", ""),
    ("poem_v2_tpu_torch.fit", "mod.OneFrameFit()"),
    ("poem_v2_tpu_torch.fit", "mod.OneFrameFitSilh()"),
    ("poem_v2_tpu_torch.ops.points", ""),
    ("poem_v2_tpu_torch.geometry.camera", ""),
])
def test_aux_modules_stand_alone(module, call):
    """CMR, the pose models, the hourglass, the fitter and the bucketed KNN import
    alone with JAX, flax, optax, PyYAML and the JAX package blocked; the factories
    and fitters target the card by default and, without one, raise."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    script = _AUX_SCRIPT % {"forbidden": FORBIDDEN, "module": module, "call": call}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=300, cwd=os.path.dirname(PKG))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
