"""The PtEmbedTRv3 serving cell on the CPU: a tiny rehearsal of ``serve_batches_v3``
end to end (the program at HRNet-W8, width 32, a small METRO stage, 64 px crops),
its check catching an altered answer, the METRO counts against hand counts, the v3
model's count, and the new readers finding nothing where a tree lacks the counter."""

import json
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.counts import metro
from benchmark.tests.tiny import run_module, tiny_config

RUN = run_module()
CELL = "medium-v3-serve-b16-4view"
SMALL_METRO = dict(vt_hidden_dims=(64, 32), vt_output_dims=(32, 3), vt_num_layers=1)


@pytest.fixture
def small_metro(monkeypatch):
    import poem_v2_tpu_torch.models.decoder_v3 as decoder_v3

    full = decoder_v3.PtEmbedTRv3
    monkeypatch.setattr(decoder_v3, "PtEmbedTRv3", lambda **kw: full(**{**SMALL_METRO, **kw}))


def tiny_v3_cell() -> harness.Cell:
    cell = harness.load_cell(CELL)
    cell.config = tiny_config("poem-medium-v3")
    cell.traffic = dict(cell.traffic, image_size=64, batch=2, view_bucket=3, views=[2, 3], pool=1)
    cell.workload = dict(cell.workload, warmup_calls=1, profile_steps=2, reference_chunk=2)
    return cell


def rehearse(trace=False, seed=2 ** 31 + 29):
    cell = tiny_v3_cell()
    return RUN.execute(cell, seed, 0.5, trace, "cpu", time.perf_counter()), cell


@pytest.mark.parametrize("trace", [False, True])
def test_v3_driver_prints_a_well_formed_line(small_metro, trace, capsys):
    (result, checks), cell = rehearse(trace)
    harness.emit(result, checks)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.workload["limits"])
    if not trace:
        assert set(line["metrics"]) == {"serve_samples_per_s", "setup_s"}
    else:  # no device trace on the CPU: every per-layer reader finds nothing
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {m["name"] for m in cell.per_layer} == {
        "metro_device_ms.v3serve", "metro_attn_roofline_pct.v3serve", "metro_host_ms.v3serve",
        "step_mfu.v3serve", "device_idle_pct.v3serve"}


def test_an_altered_v3_answer_is_caught(small_metro, monkeypatch):
    from poem_v2_tpu_torch.serving import predictor

    original = predictor.Predictor.__call__

    def altered(self, *a, **k):
        out = original(self, *a, **k)
        out["verts_3d"] = out["verts_3d"] + np.float32(0.02)  # 2 cm, where it is produced
        return out

    monkeypatch.setattr(predictor.Predictor, "__call__", altered)
    (result, _), _ = rehearse()
    assert result["correct"] is False


def test_metro_attention_hand_count():
    # B 1, N 3 tokens, H 4: four 4 x 4 products a token 4 x 2 x 3 x 16 = 384,
    # attention 4 x 3^2 x 4 = 144
    assert metro.attention_module_flops(1, 3, 4) == 384 + 144
    # bf16: tokens in and out 2 x 3 x 4, weights 4 x 16, biases and the norm 6 x 4
    assert metro.attention_module_bytes(1, 3, 4, 2) == 2 * (24 + 64 + 24)


def test_attention_widths_are_read_from_the_query_weights():
    shapes = [("head.transformer.metro_block_0.layer0_attn.query.weight", (8, 8)),
              ("head.transformer.metro_block_0.layer0_attn.key.weight", (8, 8)),
              ("head.transformer.metro_block_1.layer0_attn.query.weight", (4, 4)),
              ("head.transformer.block_0.attn.query.weight", (16, 16))]
    assert metro.attention_widths(shapes) == [8, 4]
    one = metro.attention_module_flops(2, 5, 8) / 989e12 * 1e3
    assert metro.metro_attention_least_ms(2, 5, [8]) == pytest.approx(max(
        one, metro.attention_module_bytes(2, 5, 8, 2) / 3.35e12 * 1e3))


def test_v3_model_count_is_linear_in_views(small_metro):
    import torch

    from benchmark.counts.model_v3 import forward_flops
    from poem_v2_tpu_torch.models.poem import create_poem_model

    cfg = tiny_config("poem-medium-v3")["MODEL"]
    model, _ = create_poem_model(cfg, dtype=torch.float32, device="cpu")
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    f = [forward_flops(cfg, shapes, v, 64) for v in (1, 2, 3)]
    assert f[2] - f[1] == pytest.approx(f[1] - f[0]) and f[1] > f[0]
    # at least the METRO stage's attention over 799 + 4096 tokens
    widths = metro.attention_widths(shapes)
    assert widths == [64, 32]
    assert f[0] > sum(metro.attention_module_flops(1, 799 + 4096, h) for h in widths)


def test_new_readers_find_nothing_without_the_counter_or_a_trace():
    from poem_v2_tpu_torch.utils import profiling

    profiling.reset()
    cell = harness.load_cell(CELL)
    trace = harness.Trace(window_s=1.0, busy_s=0.5, launches=10, device_ops=[], steps=2,
                          span_device_s={"metro_attention": 0.01, "metro": 0.02},
                          span_calls={"metro_attention": 24, "metro": 6}, idle_gaps=[])
    out = harness.Outcome(attempted=1, failed=0, setup_s=1.0, end_to_end={}, checks={},
                          memory_peak_bytes=0, trace=trace,
                          facts={"tail_steps": 3, "tail_seconds": 1.0, "tail_views": [],
                                 "param_shapes": []})
    read = lambda name, o: harness.load_module("metrics", name).read(o, cell)
    # a tree whose program records no metro_tokens (the ring holds no request roots)
    assert read("metro_attn_roofline_pct.v3serve", out) is None
    assert read("metro_host_ms.v3serve", out) is None
    assert read("metro_device_ms.v3serve", out) == pytest.approx(10.0)
    none = harness.Outcome(attempted=1, failed=0, setup_s=1.0, end_to_end={}, checks={},
                           memory_peak_bytes=0)
    for m in cell.per_layer:
        assert read(m["name"], none) is None


@pytest.mark.cuda
def test_v3_control_fails_the_check():
    """The v3 reference with fp8 products, in the program's place at the cell's own
    size, against the float32 one: the cell's check reads it not correct. Needs the
    card; ``benchmark/calibrate_v3.py`` reads it over more seeds."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from benchmark.generator import make_pool
    from benchmark.reference.poem_ref import Precision, float32_matmuls, load_constants
    from benchmark.reference.poem_v3_ref import V3Reference
    from benchmark.serving import DTYPES, gaps, reference_outputs, summarize
    from benchmark.weights import make_weights
    from poem_v2_tpu_torch.models.poem import create_poem_model

    cell = harness.load_cell(CELL)
    cfg, lim, dev, seed = cell.config, cell.workload["limits"], torch.device("cuda"), 2 ** 31 + 3
    model, _ = create_poem_model(cfg["MODEL"], device="cpu")
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model
    dt = DTYPES[cfg["serve_dtype"]]
    w = {k: v.to(dt).float() for k, v in make_weights(shapes, seed, dev).items()}
    consts = load_constants(cfg["MODEL"], dev)
    r32, r8 = (V3Reference(w, cfg["MODEL"], consts, Precision(p)) for p in ("float32", "fp8"))
    chunk = cell.workload["reference_chunk"]
    with float32_matmuls():
        got = summarize([gaps(reference_outputs(r8, b, dev, chunk),
                              reference_outputs(r32, b, dev, chunk), b["view_mask"])
                         for b in make_pool(cell.traffic, seed, dev)[:4]])
    assert all(got[k] > v for k, v in lim.items()), (got, lim)
