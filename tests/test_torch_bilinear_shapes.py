"""K4, the BPS sampler, at the shapes its kernel cuts differently: the plain
version (what the kernel is held to, bit for bit, on the card) against the JAX
package's samplers, and the kernel's launch geometry
(``ops/bilinear.py:sampler_geometry``) at every tier's shape.

The JAX side: ``ops/sampling.py:grid_sample_points_matmul`` at the highest
matmul precision (the same float32 function), and the Pallas kernel
``pallas_bilinear.grid_sample_points_fused`` in interpret mode, within its
bf16 tap weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.configs import RELEASE
from poem_v2_tpu_torch.ops import bilinear

# a 256 x 256 crop's feature map as the head samples it
MAP_HW = (16, 16)
BPS_POINTS = 4096
VIEWS = 8


def _inputs(seed, B, H, W, C, N):
    """Features, and N points: uniform from -1.3 to 1.3 (off the map
    included) after eight at cell borders and corners, the centre and far
    outside."""
    rs = np.random.RandomState(seed)
    feat = rs.randn(B, H, W, C).astype(np.float32)
    fixed = np.array([[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0], [-2.0, 0.5],
                      [-1.0 + 2.0 / W, -1.0 + 4.0 / H],      # a cell border in x and y
                      [1.0 - 1.0 / W, -1.0 + 1.0 / H],      # a cell centre at the edge
                      [1.0 + 1.0 / W, 0.25], [0.5, -1.0 - 1.0 / H]], np.float32)
    coords = np.concatenate([np.repeat(fixed[None], B, 0),
                             rs.uniform(-1.3, 1.3, (B, N - len(fixed), 2))], axis=1)
    return feat, coords.astype(np.float32)


SHAPES = [  # (B, H, W, C, N): C of 8 / 24 / 128 / 1024, N a multiple of no chunk, H != W
    (2, 12, 20, 8, 257),
    (2, 12, 20, 24, 1000),
    (1, 16, 16, 128, 333),
    (1, 20, 12, 1024, 130),
]


@pytest.mark.parametrize("B,H,W,C,N", SHAPES)
def test_plain_sampler_matches_jax_matmul_sampler(B, H, W, C, N):
    from poem_v2_tpu.ops.sampling import grid_sample_points_matmul

    feat, coords = _inputs(C + N, B, H, W, C, N)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(grid_sample_points_matmul(jnp.asarray(feat), jnp.asarray(coords)))
    got = bilinear.plain_grid_sample_points(torch.from_numpy(feat), torch.from_numpy(coords))
    assert got.shape == (B, N, C) and got.dtype == torch.float32
    # float32 on both sides; the matmul sums the same four products in its order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # off the map everything is zero on both sides
    assert np.all(got.numpy()[:, 3] == 0) and np.all(want[:, 3] == 0)


@pytest.mark.parametrize("B,H,W,C,N", SHAPES[:3])
def test_plain_sampler_matches_pallas_within_its_bf16_taps(B, H, W, C, N):
    from poem_v2_tpu.ops.pallas_bilinear import grid_sample_points_fused

    feat, coords = _inputs(C + N + 1, B, H, W, C, N)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(grid_sample_points_fused(jnp.asarray(feat), jnp.asarray(coords),
                                                   block_n=128, interpret=True))
    got = bilinear.grid_sample_points(torch.from_numpy(feat), torch.from_numpy(coords))
    # the TPU kernel rounds its tap weights to bf16 (8 mantissa bits)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3 * np.abs(feat).max())


def test_plain_sampler_in_bf16_rounds_the_float32_result_once():
    """bf16 features: the plain version sums in float32 and rounds once, so it
    equals the float32 result on the same (bf16-exact) features, cast."""
    feat, coords = _inputs(7, 2, 12, 20, 24, 300)
    fb = torch.from_numpy(feat).to(torch.bfloat16)
    got = bilinear.plain_grid_sample_points(fb, torch.from_numpy(coords))
    want = bilinear.plain_grid_sample_points(fb.float(), torch.from_numpy(coords))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))


def _covered_once(g, units, N):
    """Every (channel unit, point) of a map lies in exactly one (slice, chunk)."""
    unit_hits = np.zeros(units, np.int64)
    for s in range(g.slices):
        lo = s * g.slice_units
        assert lo < units, "an empty slice"
        unit_hits[lo:min(units, lo + g.slice_units)] += 1
    point_hits = np.zeros(N, np.int64)
    for c in range(g.chunks):
        lo = c * g.chunk_points
        assert lo < N, "an empty chunk"
        point_hits[lo:min(N, lo + g.chunk_points)] += 1
    return bool((unit_hits == 1).all() and (point_hits == 1).all())


def _tier_shapes():
    widths = sorted({cfg["MODEL"]["HEAD"]["EMBED_DIMS"] for cfg in RELEASE.values()})
    assert widths == [128, 256, 512, 1024]
    for batch in (1, 4, 16):            # requests at B1 / B4, medium's B16
        for C in widths:
            yield batch * VIEWS, MAP_HW[0], MAP_HW[1], C, BPS_POINTS


@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_sampler_geometry_covers_every_element_once_within_shared_memory(elem_bytes):
    shapes = list(_tier_shapes()) + [(3, 12, 20, 24, 4099), (2, 16, 16, 6, 1000),
                                     (2, 128, 128, 64, 2000), (1, 1, 1, 8, 1),
                                     (2, 64, 64, 2048, 4097)]
    for B, H, W, C, N in shapes:
        for aligned in (True, False):
            g = bilinear.sampler_geometry(B, H, W, C, N, elem_bytes, aligned=aligned)
            vec = 16 // elem_bytes
            assert g.unit == (vec if aligned and C % vec == 0 else 1)
            units = C // g.unit
            assert units * g.unit == C
            assert _covered_once(g, units, N), (B, H, W, C, N, g)
            assert g.tx in (1, 2, 4, 8, 16, 32) and g.slices <= 65535
            assert g.smem_bytes <= bilinear.SMEM_LIMIT, (B, H, W, C, N, g)
            staged = 0 if g.direct else H * W * g.slice_units * g.unit * elem_bytes
            assert g.smem_bytes == bilinear.TABLE_BYTES + staged
            # a map is read directly only when one unit of every cell does not fit
            fits = bilinear.TABLE_BYTES + H * W * g.unit * elem_bytes <= bilinear.SMEM_LIMIT
            assert g.direct == (not fits), (B, H, W, C, N, g)


def test_sampler_geometry_at_the_serving_shapes():
    """At 16 x 16 maps a block stages 16 units a cell (64 KB) and serves two
    points a warp; at B4 the grid holds at least two blocks an SM."""
    for B in (4, 16):
        for C in (128, 256, 512, 1024):
            for eb in (2, 4):
                g = bilinear.sampler_geometry(B * VIEWS, *MAP_HW, C, BPS_POINTS, eb)
                assert not g.direct and g.slice_units == 16 and g.tx == 16
                assert g.smem_bytes == 72 * 1024
                blocks = g.chunks * g.slices * B * VIEWS
                assert blocks >= 2 * bilinear.SMS, (B, C, eb, g)


def test_sampler_wrapper_takes_the_plain_version_on_the_cpu():
    feat, coords = _inputs(3, 2, 12, 20, 24, 50)
    before = bilinear.grid_sample_points.launches
    got = bilinear.grid_sample_points(torch.from_numpy(feat), torch.from_numpy(coords))
    assert bilinear.grid_sample_points.launches == before
    assert torch.equal(got, bilinear.plain_grid_sample_points(torch.from_numpy(feat),
                                                              torch.from_numpy(coords)))


def test_kernel_signatures_match_the_c_entry_points():
    """Every ctypes signature in ops/_lib.py has as many arguments as its C
    entry point in csrc/ (a pointer passed where the C side reads an int, or
    one argument short, is a crash on the card, not an error)."""
    import os
    import re

    from poem_v2_tpu_torch.ops import _lib

    decls = {}
    for name in os.listdir(_lib.CSRC):
        if name.endswith(".cu"):
            src = open(os.path.join(_lib.CSRC, name)).read()
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
                decls[m.group(1)] = [a.strip() for a in m.group(2).split(",")]
    assert set(decls) == set(_lib._SIGNATURES)
    for fn, args in decls.items():
        types = _lib._SIGNATURES[fn]
        assert len(types) == len(args), fn
        for a, t in zip(args, types):
            assert ("*" in a) == (t is _lib._P), (fn, a)
