"""Rehearsal of ``chip_smoke.py`` on the CPU: its phase 1 at tiny shapes, with
the wrappers' plain versions on both sides and the timer stubbed, so that a
wrong argument, shape or key shows here and not on the card."""

import json

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture
def on_cpu(monkeypatch):
    """Send chip_smoke's device copies to the CPU and stub its CUDA timer."""
    real_to = chip_smoke._to
    monkeypatch.setattr(chip_smoke, "_to", lambda x, device, dtype=None: real_to(x, "cpu", dtype))
    monkeypatch.setattr(chip_smoke, "time_cuda",
                        lambda fn, iters=1, warmup=0: (fn(), 1e-3)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_phase_kernels_rehearsal(on_cpu):
    results = {}
    chip_smoke.phase_kernels(results, B=2, M=19, D=32, K=8, N=64, V=4, wide=(48,))
    names = {case.split("/")[0] for case in results} - {"wide"}
    assert names == {k for k, n in chip_smoke.LAUNCHES_PER_MIXED_FORWARD.items() if n} | {
        "fused_vector_attention"}
    for case, by_dtype in results.items():
        assert set(by_dtype) == {"float32", "bfloat16"}, case
        for row in by_dtype.values():
            assert set(row) == {"max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by"}
            assert row["bound_by"] in ("bytes", "operations") and row["bound_ms"] > 0
            assert row["max_abs_err"] == 0.0  # the same plain version on both sides
    for case in ("dense_cross_attention", "grid_sample_points_fused", "scrambled_merge_gather"):
        assert results[case]["bfloat16"]["library_ms"] is not None, case
    json.dumps(results)  # what goes into the kernels line is serialisable


def test_bounds_at_the_batch4_shapes():
    """The bounds chip_smoke reckons for K5 and K8 at B=4, V=8, NS=4096, C=D=256,
    bfloat16: 67.1 MB read and as much written over 3.35 TB/s, and three
    (102272 x 256) x (256 x 256) products over 989 TFLOP/s."""
    ms, by = chip_smoke.bound_ms(2 * 4 * 8 * 4096 * 256 * 2, 0.0, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(0.0401, abs=1e-4)
    rows = 4 * 799 * 32
    ms, by = chip_smoke.bound_ms(2 * rows * 256 * 2, chip_smoke.attention_flops(rows, 256, 3),
                                 torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(0.0408, abs=1e-4)


def test_mixed_view_mask_mixes_counts():
    for seed in range(5):
        mask = chip_smoke.mixed_view_mask(np.random.RandomState(seed), 4)
        n = mask.sum(1)
        assert mask.shape == (4, 8) and n.min() >= 2 and n.max() == 8 and (n != 8).any()
        assert (mask == (np.arange(8)[None] < n[:, None])).all()  # valid views come first
