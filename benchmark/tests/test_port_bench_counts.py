"""The counting functions against hand counts, and the model's count."""

import pytest

from benchmark.counts import kernels
from benchmark.counts.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS


def test_k1_hand_count():
    # B 1, M 2 queries, K 2 neighbours, N 3 cloud points, D 4:
    # 4 rows x (3 products x 2 x 16 + the 3 -> 4 layer 2 x 12) = 480,
    # k / v projection 3 points x 2 x 2 x 16 = 192, distances 8 x 2 x 3 = 48
    assert kernels.knn_attention_flops(1, 2, 2, 3, 4) == 480 + 192 + 48


def test_k2_hand_count():
    # 4 rows (2 queries x 2 anchors) x 120 + 2 anchors x 2 x 2 x 16
    assert kernels.anchor_attention_flops(1, 2, 2, 4) == 480 + 128


def test_vector_block_bytes_hand_count():
    # bf16: queries in and out 2 x 2 x 4, cloud 3 x 4, weights 6 x 16, then the
    # float32 coordinates of the 2 queries and 3 cloud points
    assert kernels.vector_block_bytes(1, 2, 3, 4, 2) == 2 * (16 + 12 + 96) + 4 * 3 * 5


def test_bound_takes_the_larger_side():
    ms, by = kernels.bound_ms(PEAK_BYTES_PER_S, 1.0)
    assert by == "bytes" and ms == pytest.approx(1e3)
    ms, by = kernels.bound_ms(1.0, PEAK_FLOPS["bfloat16"])
    assert by == "operations" and ms == pytest.approx(1e3)


def test_model_count_is_linear_in_views():
    import torch

    from benchmark.counts.model import forward_flops
    from benchmark.tests.tiny import tiny_config
    from poem_v2_tpu_torch.models.poem import create_poem_model

    cfg = tiny_config()["MODEL"]
    model, _ = create_poem_model(cfg, dtype=torch.float32, device="cpu")
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    f = [forward_flops(cfg, shapes, v, 64) for v in (1, 2, 3)]
    assert f[0] > 0 and f[2] - f[1] == pytest.approx(f[1] - f[0])
    # one view's input projection alone: a 1 x 1 convolution 32 -> 32 over 2 x 2 cells
    assert f[1] - f[0] > 2 * 32 * 32 * 4
