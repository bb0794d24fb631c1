"""Checkpoints into the port: the released PyTorch weights by their reference
names (``convert_reference.py``), the JAX package's orbax directories
(``scripts/torch_export_checkpoint.py``) and ImageNet HRNet weights
(``scripts/torch_prepare_hrnet.py``), held against the JAX converter and
readers on the CPU.

The reference state dicts are fabricated as ``tests/test_convert.py`` builds
them (its decoder-block and torchvision ResNet-18 fabricators; the HRNet,
neck and head keys from the flax parameter shapes), for the tiny ResNet-18
model of ``TINY_MODEL_CFG`` and the tiny HRNet of ``tiny_cfg``, both with
``NORM: frozen_bn``.
"""

import copy
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from helpers import TINY_MODEL_CFG
from test_convert import fabricate_torch_block, fabricate_torchvision_resnet18
from torch_port_helpers import (fill_params, flax_model_shapes, look_at_cameras, pallas_interpret,
                                tiny_cfg, to_numpy_tree, zeros_like_shapes)

from poem_v2_tpu_torch import convert_reference
from poem_v2_tpu_torch.cli.opt import parse_exp_args
from poem_v2_tpu_torch.cli.train import build_model
from poem_v2_tpu_torch.convert import flax_to_state_dict
from poem_v2_tpu_torch.models.poem import create_poem_model
from poem_v2_tpu_torch.serving.predictor import Predictor
from poem_v2_tpu_torch.utils.config import get_config
from poem_v2_tpu_torch.utils.recorder import Recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


def _cfg(arch):
    cfg = tiny_cfg(norm="frozen_bn") if arch == "HRNet" else copy.deepcopy(TINY_MODEL_CFG)
    cfg.BACKBONE.NORM = "frozen_bn"
    return cfg


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """``eval_shape`` of the JAX model's variables (a trace of ~10 s for the HRNet)."""
    return flax_model_shapes(_cfg(arch), 64)


def _jax_params(arch):
    """A zero-filled flax parameter tree of ``arch``'s model (plain nested dicts)."""
    return zeros_like_shapes(_shapes(arch))["params"]


@functools.lru_cache(maxsize=None)
def _reference_state(arch):
    """The fabricated reference state dict of ``arch``'s model (read only)."""
    return _fabricate(_jax_params(arch), arch)


def _fabricate(params, arch):
    """A reference-named state dict of every tensor the model of ``params`` holds."""
    g = torch.Generator().manual_seed(3)
    state = {}

    def conv(key, node):
        kh, kw, cin, cout = node["kernel"].shape
        state[f"{key}.weight"] = torch.randn(cout, cin, kh, kw, generator=g)

    def bn(key, node):
        c = node["scale"].shape[0]
        for t in ("weight", "bias", "running_mean"):
            state[f"{key}.{t}"] = torch.randn(c, generator=g)
        state[f"{key}.running_var"] = torch.rand(c, generator=g) + 0.5

    if arch == "HRNet":
        bb, p = params["backbone"], "img_backbone."
        conv(p + "conv1", bb["stem1"]), bn(p + "bn1", bb["stem1_norm"])
        conv(p + "conv2", bb["stem2"]), bn(p + "bn2", bb["stem2_norm"])
        for b in range(4):
            blk = bb[f"layer1_block{b}"]
            for ci in range(3):
                conv(f"{p}layer1.{b}.conv{ci + 1}", blk[f"Conv_{ci}"])
                bn(f"{p}layer1.{b}.bn{ci + 1}", blk[f"FrozenBatchNorm_{ci}"])
            if "Conv_3" in blk:
                conv(f"{p}layer1.{b}.downsample.0", blk["Conv_3"])
                bn(f"{p}layer1.{b}.downsample.1", blk["FrozenBatchNorm_3"])
        for tk, jn in (("transition1.0", "t1_b0"), ("transition1.1.0", "t1_b1"),
                       ("transition2.2.0", "t2_b2"), ("transition3.3.0", "t3_b3")):
            conv(f"{p}{tk}.0", bb[jn]), bn(f"{p}{tk}.1", bb[jn + "_norm"])
        for s_idx, n_mod in zip((2, 3, 4), (1, 4, 3)):
            for m in range(n_mod):
                mod, t = bb[f"stage{s_idx}_m{m}"], f"{p}stage{s_idx}.{m}."
                for i in range(s_idx):
                    for b in range(4):
                        blk = mod[f"branch{i}_block{b}"]
                        for ci in range(2):
                            conv(f"{t}branches.{i}.{b}.conv{ci + 1}", blk[f"Conv_{ci}"])
                            bn(f"{t}branches.{i}.{b}.bn{ci + 1}", blk[f"FrozenBatchNorm_{ci}"])
                for i in range(s_idx):
                    for j in range(s_idx):
                        if j > i:
                            conv(f"{t}fuse_layers.{i}.{j}.0", mod["fuse"][f"up_{j}_to_{i}_conv"])
                            bn(f"{t}fuse_layers.{i}.{j}.1", mod["fuse"][f"up_{j}_to_{i}_norm"])
                        for k in range(i - j):
                            conv(f"{t}fuse_layers.{i}.{j}.{k}.0",
                                 mod["fuse"][f"down_{j}_to_{i}_conv{k}"])
                            bn(f"{t}fuse_layers.{i}.{j}.{k}.1",
                               mod["fuse"][f"down_{j}_to_{i}_norm{k}"])
    else:
        state.update(fabricate_torchvision_resnet18())

    def conv_block(key, node):
        conv(f"{key}.conv", node["Conv_0"])
        state[f"{key}.conv.bias"] = torch.randn(node["Conv_0"]["bias"].shape[0], generator=g)
        if "FrozenBatchNorm_0" in node:
            bn(f"{key}.norm", node["FrozenBatchNorm_0"])
            state[f"{key}.norm.num_batches_tracked"] = torch.tensor(7)

    for i in range(3):
        conv_block(f"feat_delayer.{i}", params["feat_neck"][f"ConvBlock_{i}"])
        conv_block(f"uv_delayer.{i}", params["uv_neck"][f"ConvBlock_{i}"])
    conv_block("feat_in", params["feat_neck"]["feat_in"])
    conv_block("uv_out", params["uv_neck"]["uv_out"])
    conv_block("uv_in", params["uv_neck"]["uv_in"])
    head = params["head"]
    for name in ("input_proj", "adapt_pos3d"):
        conv(f"ptEmb_head.{name}", head[name])
        state[f"ptEmb_head.{name}.bias"] = torch.randn(head[name]["bias"].shape[0], generator=g)
    for i in range(2):
        for j in range(2):
            ci, co = head["merge_feature"][f"merge_net_{i}"][f"Dense_{j}"]["kernel"].shape
            state[f"ptEmb_head.merge_net_feature.{i}.{2 * j}.weight"] = torch.randn(co, ci,
                                                                                  generator=g)
            state[f"ptEmb_head.merge_net_feature.{i}.{2 * j}.bias"] = torch.randn(co, generator=g)
    nq, dq = head["query_feat_embedding"].shape
    state["ptEmb_head.query_feat_embedding.weight"] = torch.randn(nq, dq, generator=g)
    for i in range(len([b for b in head["transformer"] if b.startswith("block_")])):
        state.update(fabricate_torch_block(f"ptEmb_head.transformer.pt_metro_encoder.{i}.", dq))
    return state


ARCHS = ["resnet18", "HRNet"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_table_is_the_jax_converter(arch):
    """A complete fabricated reference state dict: the JAX ``convert_poem_checkpoint``
    + ``flax_to_state_dict`` and the port's table give the same arrays, bit for bit,
    under the same keys, every key of the port model; neither leaves a reference
    key over (the necks' ``num_batches_tracked`` consumed by both)."""
    from poem_v2_tpu.utils.torch_convert import convert_poem_checkpoint

    cfg = _cfg(arch)
    state = _reference_state(arch)
    jax_params, jax_left = convert_poem_checkpoint(state, _jax_params(arch), arch=arch)
    want = flax_to_state_dict({"params": jax_params})
    model, _ = create_poem_model(cfg, device="cpu")
    got, left = convert_reference.convert_poem_checkpoint(state, model.state_dict(), arch)
    assert jax_left == [] and left == []
    assert set(got) == set(want) == set(model.state_dict())
    for k, w in want.items():
        assert np.array_equal(np.asarray(got[k]), w), k
    # read backwards, the table gives the reference dict back
    back = convert_reference.to_reference({k: torch.as_tensor(v) for k, v in got.items()}, arch)
    assert set(back) == {k for k in state if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(back[k], state[k]) for k in back)


def test_reference_named_weights_give_the_jax_forward():
    """A JAX model's weights (gain 0.5) written under the reference names by the
    port's table: the JAX converter reads them back to the same flax tree, and the
    port loads them through the table; the eval forward of a batch with 3 and 2 of
    3 views agrees with JAX's to 1e-5 m (float32, sums in other orders). The
    ResNet-18 model: the HRNet's table is held bit for bit above, and its forward
    against JAX by test_torch_slice.py."""
    from poem_v2_tpu.models.poem import create_poem_model as jax_create
    from poem_v2_tpu.utils.torch_convert import convert_poem_checkpoint

    arch = "resnet18"
    cfg = _cfg(arch)
    variables = fill_params(_shapes(arch), gain=0.5)
    model, _ = create_poem_model(cfg, device="cpu")
    sd = flax_to_state_dict(to_numpy_tree(variables))
    ref = convert_reference.to_reference({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                                         arch)
    jax_params, left = convert_poem_checkpoint(ref, _jax_params(arch), arch=arch)
    assert left == []
    for k, v in flax_to_state_dict({"params": jax_params}).items():
        assert np.array_equal(v, sd[k]), k
    port_sd, left = convert_reference.convert_poem_checkpoint(ref, model.state_dict(), arch)
    assert left == []
    model.load_state_dict(port_sd)

    rs = np.random.RandomState(0)
    images = rs.uniform(-0.5, 0.5, (2, 3, 64, 64, 3)).astype(np.float32)
    mask = np.ones((2, 3), bool)
    mask[1, 2] = False
    intr, extr = look_at_cameras(rs, 2, 3, 64)
    jmodel, _ = jax_create(cfg, use_flash=True)
    args = tuple(jnp.asarray(a) for a in (images, mask, intr, extr))
    with pallas_interpret(exact_sampler=True), jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, None, train=False))(
            jax_params, *args)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (images, mask, intr, extr)))
    for key in ("pred_joints_3d", "pred_verts_3d"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0,
                                   err_msg=key)


def _write_cfg(tmp_path, cfg):
    path = tmp_path / "model.yaml"
    path.write_text(yaml.safe_dump({"MODEL": cfg.to_dict()}))
    return str(path)


def test_exported_orbax_checkpoints_load_through_every_reader(tmp_path, monkeypatch):
    """JAX ``Recorder.record_checkpoint`` of a tiny HRNet model's state
    (parameters, Adam state, step, key) and a ``prepare_hrnet``-style ``{backbone}``
    directory, each through ``scripts/torch_export_checkpoint.py``: the port's
    ``--reload``, ``Predictor.from_config(ckpt_path=)`` and ``PRETRAINED_BACKBONE``
    read the JAX values; an orbax directory itself raises, naming the script."""
    import optax
    import orbax.checkpoint as ocp

    from poem_v2_tpu.training.trainer import TrainState
    from poem_v2_tpu.utils.recorder import Recorder as JaxRecorder
    from torch_export_checkpoint import main as export

    monkeypatch.chdir(tmp_path)
    cfg = _cfg("HRNet")
    params = fill_params(_shapes("HRNet"), seed=5, gain=0.5)["params"]
    state = TrainState.create(params, optax.adam(1e-3), jax.random.PRNGKey(0))
    rec = JaxRecorder("default", root=str(tmp_path / "exp"))
    rec.record_checkpoint(state, epoch=0)
    ckpt = os.path.join(rec.dump_path, "checkpoints", "checkpoint")
    export([ckpt, "--out", str(tmp_path / "run.pt")])
    want = flax_to_state_dict({"params": to_numpy_tree(params)})

    def same(model, keys=None):
        sd = model.state_dict()
        for k in keys or want:
            assert np.array_equal(sd[k].numpy(), want[k]), k

    args = parse_exp_args(["-c", "x.yaml", "--device", "cpu", "--dtype", "fp32",
                           "--reload", str(tmp_path / "run.pt")])
    model, _ = build_model(get_config({"MODEL": cfg.to_dict()}, arg=args), args)
    same(model)
    pred = Predictor.from_config({"MODEL": cfg.to_dict()}, ckpt_path=str(tmp_path / "run.pt"),
                                 dtype=torch.float32, device="cpu")
    same(pred.model)

    bb = {"backbone": fill_params(_shapes("HRNet"), seed=6)["params"]["backbone"]}
    ckptr = ocp.StandardCheckpointer()  # as scripts/prepare_hrnet.py writes it
    ckptr.save(str(tmp_path / "hrnet_flax"), bb)
    ckptr.wait_until_finished()
    export([str(tmp_path / "hrnet_flax"), "--out", str(tmp_path / "hrnet.pt")])
    want = flax_to_state_dict({"params": to_numpy_tree(bb)})
    args = parse_exp_args(["-c", "x.yaml", "--device", "cpu", "--dtype", "fp32"])
    mcfg = cfg.to_dict()
    mcfg["PRETRAINED_BACKBONE"] = str(tmp_path / "hrnet.pt")
    model, _ = build_model(get_config({"MODEL": mcfg}, arg=args), args)
    same(model)
    assert all(k.startswith("backbone.") for k in want) and len(want) > 100

    with pytest.raises(NotImplementedError, match="torch_export_checkpoint"):
        Recorder.load_params(ckpt, model)


def test_convert_checkpoint_script(tmp_path):
    """``scripts/torch_convert_checkpoint.py`` on a fabricated released checkpoint
    (nested under ``state_dict`` with DDP's ``module.`` prefixes, one stray key):
    the file holds the table's values, reports the stray key, and loads with
    ``--reload`` into the config's ``frozen_bn`` model."""
    from torch_convert_checkpoint import main as convert

    cfg = _cfg("resnet18")
    state = _reference_state("resnet18")
    torch.save({"state_dict": {f"module.{k}": v for k, v in {**state, "stray.weight":
                                                            torch.zeros(1)}.items()},
                "epoch": 3}, tmp_path / "released.pth.tar")
    cfg_path = _write_cfg(tmp_path, cfg)
    out = convert(["-c", cfg_path, "--torch-ckpt", str(tmp_path / "released.pth.tar"),
                   "--out", str(tmp_path / "port.pt")])
    assert out["leftover"] == ["stray.weight"] and out["missing"] == []
    model, _ = create_poem_model(cfg, device="cpu")
    want, _ = convert_reference.convert_poem_checkpoint(state, model.state_dict(), "resnet18")
    Recorder.load_params(str(tmp_path / "port.pt"), model)
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_prepare_hrnet_script(tmp_path):
    """``scripts/torch_prepare_hrnet.py`` on fabricated ImageNet HRNet-W8 weights
    (the trunk's names without ``img_backbone.``, and a classifier): a
    ``backbone.*`` file whose values are the table's, the classifier left over;
    ``PRETRAINED_BACKBONE`` loads it into the tiny HRNet model."""
    from torch_prepare_hrnet import main as prepare

    cfg = _cfg("HRNet")
    state = {k[len("img_backbone."):]: v for k, v in _reference_state("HRNet").items()
             if k.startswith("img_backbone.")}
    state["classifier.weight"] = torch.zeros(10, 4)
    torch.save(state, tmp_path / "hrnet_w8.pth")
    out = prepare(["--torch-ckpt", str(tmp_path / "hrnet_w8.pth"), "--width", "8",
                   "--out", str(tmp_path / "hrnet.pt")])
    assert out["leftover"] == ["classifier.weight"] and out["missing"] == []
    args = parse_exp_args(["-c", "x.yaml", "--device", "cpu", "--dtype", "fp32"])
    mcfg = cfg.to_dict()
    mcfg["PRETRAINED_BACKBONE"] = str(tmp_path / "hrnet.pt")
    model, _ = build_model(get_config({"MODEL": mcfg}, arg=args), args)
    full = {f"img_backbone.{k}": v for k, v in state.items()}
    want, _ = convert_reference.convert_poem_checkpoint(full, model.state_dict(), "HRNet")
    assert len(want) == len(model.backbone.state_dict())
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
