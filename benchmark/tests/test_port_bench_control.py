"""The control of each declared cell comes out not correct: the plain reference
with its products rounded to fp8 (the precision below the configuration's bf16
compute), in the program's place at the cell's own size, against the float32
reference. Needs the card; ``benchmark/calibrate.py`` reads it over more seeds."""

import pytest
import torch

from benchmark import harness
from benchmark.generator import make_pool
from benchmark.reference.poem_ref import Precision, Reference, float32_matmuls, load_constants
from benchmark.serving import DTYPES, gaps, reference_outputs, summarize
from benchmark.weights import make_weights

CELLS = [w["name"] for w in harness._load_json(f"{harness.ROOT}/BENCHMARK.json")["workloads"]]


def shapes_of(model_cfg):
    from poem_v2_tpu_torch.models.poem import create_poem_model

    model, _ = create_poem_model(model_cfg, device="cpu")
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    cell = harness.load_cell(name)
    cfg, lim, dev, seed = cell.config, cell.workload["limits"], torch.device("cuda"), 2 ** 31 + 3
    shapes = shapes_of(cfg["MODEL"])
    pool = make_pool(cell.traffic, seed, dev)
    w = {k: v.to(DTYPES[cfg["serve_dtype"]]).float() for k, v in make_weights(shapes, seed, dev).items()}
    consts = load_constants(cfg["MODEL"], dev)
    r32 = Reference(w, cfg["MODEL"], consts, Precision("float32"))
    r8 = Reference(w, cfg["MODEL"], consts, Precision("fp8"))
    chunk = cell.workload["reference_chunk"]
    with float32_matmuls():
        got = summarize([gaps(reference_outputs(r8, b, dev, chunk),
                              reference_outputs(r32, b, dev, chunk), b["view_mask"]) for b in pool])
    assert any(got[k] > v for k, v in lim.items()), (got, lim)
