"""A tiny cell of each driver for CPU rehearsals: the release model's structure at
a small width (HRNet-W8, width 32) on 64 px crops, in float32 (the plain
versions' dtype on the CPU), a short window."""

from __future__ import annotations

import copy

from benchmark import harness

def tiny_config(name: str = "poem-medium") -> dict:
    cfg = copy.deepcopy(harness._load_json(f"{harness.BENCH_DIR}/configs/{name}.json"))
    m = cfg["MODEL"]
    m["BACKBONE"]["WIDTH"] = 8
    head = m["HEAD"]
    head["EMBED_DIMS"] = head["POINTS_FEAT_DIM"] = head["TRANSFORMER"]["INPUT_FEAT_DIM"] = 32
    cfg["serve_dtype"] = "float32"
    return cfg


def tiny_cell(kind: str, **limits) -> harness.Cell:
    bench = harness._load_json(f"{harness.ROOT}/BENCHMARK.json")
    cell = harness.load_cell({"serve": "medium-serve-b16-mixed", "rig": "medium-rig-b1"}[kind],
                             bench)
    cell.config = tiny_config()
    cell.traffic = dict(cell.traffic, image_size=64, batch=2 if kind != "rig" else 1,
                        view_bucket=3, views=[2, 3] if kind != "rig" else [3, 3], pool=3)
    cell.workload = dict(cell.workload, warmup_calls=1, profile_steps=2, reference_chunk=1,
                         limits=dict(cell.workload["limits"], **limits))
    return cell


def run_module():
    """``benchmark/run.py`` as a module (it is a script, not a package member)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("benchmark_run", f"{harness.BENCH_DIR}/run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
