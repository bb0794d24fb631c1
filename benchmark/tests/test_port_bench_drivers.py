"""Tiny rehearsals of each driver on the CPU (the harness's look for a card
skipped), the refusal without a card or without the program, and the output
check catching a broken timed path."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.tiny import run_module, tiny_cell

RUN = run_module()


def rehearse(kind, trace=False, seconds=0.5, seed=2 ** 31 + 17):
    cell = tiny_cell(kind)
    return RUN.execute(cell, seed, seconds, trace, "cpu", time.perf_counter()), cell


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("kind", ["serve", "rig"])
def test_driver_prints_a_well_formed_line(kind, trace, capsys):
    (result, checks), cell = rehearse(kind, trace)
    harness.emit(result, checks)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.workload["limits"])
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:  # no device trace on the CPU: every per-layer reader finds nothing
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = RUN.main(["--workload", "medium-rig-b1", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "medium-rig-b1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_an_altered_answer_is_caught(monkeypatch):
    from poem_v2_tpu_torch.serving import predictor

    original = predictor.Predictor.__call__

    def altered(self, *a, **k):
        out = original(self, *a, **k)
        out["joints_3d"] = out["joints_3d"] + np.float32(0.05)  # 5 cm, where it is produced
        return out

    monkeypatch.setattr(predictor.Predictor, "__call__", altered)
    (result, checks), _ = rehearse("serve")
    assert result["correct"] is False
