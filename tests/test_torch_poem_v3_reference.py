"""POEM with the PtEmbedTRv3 decoder through ``create_poem_model`` against the
benchmark's plain float32 reference (``benchmark/reference/poem_v3_ref.py``), on
the CPU; and the configuration's stated METRO widths against the parameters the
factory builds at full size. Imports nothing of JAX.

The tiny model is the benchmark configuration ``poem-medium-v3`` at HRNet-W8 and
width 32 on 64 px crops, with a small METRO stage (hidden 64 / 32, outputs 32 / 3,
one layer a block; at full width its FFNs over 4,895 tokens would take the CPU
minutes) and 256 BPS points (the port's generated basis, handed to the reference
as its constant). Weights are ``benchmark/weights.make_weights``'s, float32 on both
sides; the batch mixes 2 and 3 valid views of 3. The port's vector attention runs
its gathered path (``use_fused_knn=False``), which selects neighbours by full
float32 distances as the reference does; its default, K1's packed keys, ties
distances within 2**-11.
"""

import copy
import re

import pytest
import torch

from benchmark import harness
from benchmark.generator import make_pool
from benchmark.reference.poem_ref import Precision, load_constants
from benchmark.reference.poem_v3_ref import V3Reference
from benchmark.weights import load_into, make_weights
import poem_v2_tpu_torch.models.decoder_v3 as decoder_v3
import poem_v2_tpu_torch.models.poem as poem
from poem_v2_tpu_torch.models.poem import create_poem_model

CONFIG = harness._load_json(f"{harness.BENCH_DIR}/configs/poem-medium-v3.json")
SMALL_METRO = dict(vt_hidden_dims=(64, 32), vt_output_dims=(32, 3), vt_num_layers=1)
# float32 on both sides, summed in other orders (closed-form against float64 camera
# inverses, matmul sampler against grid_sample, three coordinates' distances summed
# apart against at once) through the METRO stage and three refinements: every stage's
# points (metres, |x| ~ 0.5) agree to ~1.2e-7 m, 2D joints to ~1e-5 px. The bf16
# reference misses by 8-15 mm, the fp8 one by 16-42 mm (widest, by stage).
COORDS_MAX_M = 2e-6
COORDS_RMS_M = 5e-7
UV_MAX_PX = 1e-3


_FULL_V3 = decoder_v3.PtEmbedTRv3


def small_metro(**kw):
    return _FULL_V3(**{**SMALL_METRO, **kw})


def tiny_model_cfg() -> dict:
    cfg = copy.deepcopy(CONFIG["MODEL"])
    cfg["BACKBONE"]["WIDTH"] = 8
    head = cfg["HEAD"]
    head["EMBED_DIMS"] = head["POINTS_FEAT_DIM"] = head["TRANSFORMER"]["INPUT_FEAT_DIM"] = 32
    head["N_SAMPLE"] = 256
    return cfg


@pytest.fixture(scope="module")
def compared():
    """(port outputs, {precision: reference outputs}, batch) of one mixed-view batch."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = tiny_model_cfg()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decoder_v3, "PtEmbedTRv3", small_metro)
        model, aux = create_poem_model(cfg, dtype=torch.float32, device="cpu")
    for m in model.modules():
        if hasattr(m, "use_fused_knn"):
            m.use_fused_knn = False
    shapes = [(name, tuple(p.shape)) for name, p in model.named_parameters()]
    weights = make_weights(shapes, 5, "cpu")
    load_into(model, weights)
    traffic = dict(batch=2, view_bucket=3, image_size=64, pool=1, views=[2, 3], image="uint8",
                   cameras="sphere")
    b = make_pool(traffic, 2 ** 31 + 17, "cpu")[0]
    t = lambda k: torch.as_tensor(b[k])
    img = t("image").float() / 255.0 - 0.5
    with torch.no_grad():
        got = model(img, t("view_mask"), t("cam_intr"), t("cam_extr"), torch.zeros(2, 21, 3))
        # the reference's constants at the configured 4,096 points, with the port's basis
        consts = dict(load_constants(CONFIG["MODEL"], "cpu"),
                      bps=torch.from_numpy(aux["bps_basis"]))
        refs = {p: V3Reference(weights, cfg, consts, Precision(p)).forward(
            img, t("view_mask"), t("cam_intr"), t("cam_extr")) for p in ("float32", "fp8")}
    torch.set_num_threads(n)
    return got, refs, b


def gaps(coords, want):
    d = (coords - want).double().abs()
    return float(d.max()), float(d.pow(2).mean().sqrt())


@pytest.mark.parametrize("stage", range(4), ids=["coarse", "refine0", "refine1", "refine2"])
def test_each_stage_matches_the_reference(compared, stage):
    got, refs, _ = compared
    coords = got["all_coords_preds"]
    assert coords.shape == refs["float32"]["coords"].shape == (4, 2, 799, 3)
    widest, rms = gaps(coords[stage], refs["float32"]["coords"][stage])
    assert widest < COORDS_MAX_M and rms < COORDS_RMS_M, (widest, rms)


def test_2d_joints_match_the_reference(compared):
    got, refs, b = compared
    d = (got["pred_joints_uv"] - refs["float32"]["joints_uv"]).abs().amax((2, 3))
    assert float(d[torch.as_tensor(b["view_mask"])].max()) < UV_MAX_PX


def test_the_fp8_reference_fails_the_tolerances(compared):
    _, refs, _ = compared
    for stage in range(4):
        widest, rms = gaps(refs["fp8"]["coords"][stage], refs["float32"]["coords"][stage])
        assert widest > 100 * COORDS_MAX_M and rms > 100 * COORDS_RMS_M, (stage, widest, rms)


def test_the_stated_widths_are_the_built_parameters(monkeypatch):
    """``published``'s METRO widths, depth, heads and positions against the full-size
    model's parameters (built on the CPU without initialising them), and the
    reference's reading of its depth from them."""
    monkeypatch.setattr(poem, "init_parameters", lambda model, generator: None)
    model, _ = create_poem_model(CONFIG["MODEL"], device="cpu")
    pub = CONFIG["published"]
    tr = model.head.transformer
    assert type(tr).__name__ == "PtEmbedTRv3" and tr.n_metro == len(pub["metro_hidden"])
    params = dict(model.named_parameters())
    for i, (hidden, out, hd) in enumerate(zip(pub["metro_hidden"], pub["metro_output"],
                                             pub["metro_head_dims"])):
        n = f"head.transformer.metro_block_{i}"
        block = getattr(tr, f"metro_block_{i}")
        assert params[n + ".position_embeddings"].shape == (pub["metro_positions"], hidden)
        assert params[n + ".cls_head.weight"].shape == (out, hidden)
        layers = {int(m.group(1)) for m in map(re.compile(n + r"\.layer(\d+)_attn\.").match, params)
                  if m}
        assert layers == set(range(pub["metro_layers_per_block"]))
        for j in layers:
            attn = getattr(block, f"layer{j}_attn")
            assert params[f"{n}.layer{j}_attn.query.weight"].shape == (hidden, hidden)
            assert params[f"{n}.layer{j}_ffn.intermediate.weight"].shape == (4 * hidden, hidden)
            assert attn.num_heads == pub["metro_heads_per_block"] and hidden // attn.num_heads == hd
    assert pub["metro_positions"] == pub["queries"] + pub["bps_points"]
    assert tr.point_transformer.n_blocks == pub["refine_blocks"]
    assert params["head.transformer.merge_branch.merge_net_0.Dense_0.weight"].shape == \
        (pub["embed_dims"], pub["embed_dims"])
    ref = V3Reference(params, CONFIG["MODEL"], {"centre_idx": 9}, Precision("float32"))
    assert (ref.n_metro, ref.metro_layers, ref.metro_heads) == (
        len(pub["metro_hidden"]), pub["metro_layers_per_block"], pub["metro_heads_per_block"])
