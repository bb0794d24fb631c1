"""K10, the K-th-key selection, at the shapes and keys its kernels treat
differently: rows whose keys all share a 20-bit prefix (radix8's lists stay
full length through five passes), rows of N 1, 33, 4095 (no 16-byte loads)
and 4096, and K 1, 32 and N. The five plain versions (what the kernels are
held to, with tolerance 0, on the card) against ``np.partition`` and the
one-hot count rule, and scan32 / radix8 against the benchmark script's Pallas
bodies in interpret mode (restated in ``tests/test_torch_select.py``).
"""

import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.ops import select
from test_torch_select import _radix8_body, _run_pallas, _scan32_body

BASES = [0x0, 0x3D5A3000, 0x7FFFF000]  # the least, a float's, the largest shared prefix
ROWS = (1, 2)                          # (B, M) of every case: plain versions loop K rounds


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: every tensor here is a few rows, and K = N runs
    ~4096 rounds of small ops, which several test workers each spreading over
    every core slow down by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk(k):
    """The largest chunk_j up to 16 that divides k."""
    return max(d for d in range(1, 17) if k % d == 0)


def _cases():
    for N in (1, 33, 4095, 4096):
        for k in sorted({1, min(32, N), N}):
            yield N, k


@pytest.mark.parametrize("base", BASES)
def test_prefix_keys_share_the_prefix_and_are_unique(base):
    keys = select.make_prefix_keys(5, 2, 3, 4096, base=base)
    assert keys.dtype == np.int32 and (keys >= 0).all()
    assert ((keys >> 12) == (base >> 12)).all()
    assert all(len(np.unique(r)) == 4096 for r in keys.reshape(-1, 4096))
    assert not all((np.sort(r) == r).all() for r in keys.reshape(-1, 4096))  # not in order
    with pytest.raises(ValueError):
        select.make_prefix_keys(0, 1, 1, 4097)
    with pytest.raises(ValueError):
        select.make_prefix_keys(0, 1, 1, 8, base=-4096)


@pytest.mark.parametrize("N,k", list(_cases()))
@pytest.mark.parametrize("kind", ["benchmark", "prefix"])
def test_five_plain_variants_against_partition(N, k, kind):
    B, M = ROWS
    keys_np = (select.make_keys(N + k, B, M, N) if kind == "benchmark"
               else select.make_prefix_keys(N + k, B, M, N, base=BASES[(N + k) % 3]))
    keys = torch.from_numpy(keys_np)
    kth = np.partition(keys_np, k - 1, axis=2)[..., k - 1:k]
    cj = _chunk(k)
    calls = select.variant_calls(keys, k, block_q=M, chunk_j=cj)  # CPU: the plain versions
    for name in ("scan32", "radix8"):
        got = calls[name]()
        assert got.dtype == torch.int32 and got.shape == (B, M, 1)
        assert np.array_equal(got.numpy(), kth), name                     # tolerance 0
    for name in ("cur", "bcast"):
        assert np.array_equal(calls[name]().numpy(), kth + k * M), name
    assert np.array_equal(calls["pass1"]().numpy(),
                          np.sum(keys_np, axis=-1, keepdims=True, dtype=np.int32))


@pytest.mark.parametrize("N,k", [(33, 1), (33, 32), (4095, 32), (4096, 4096)])
@pytest.mark.parametrize("base", BASES)
def test_scan32_and_radix8_against_the_pallas_bodies(N, k, base):
    keys_np = select.make_prefix_keys(N, 1, 8, N, base=base)
    keys = torch.from_numpy(keys_np)
    assert np.array_equal(select.kth_key_scan32(keys, k).numpy(),
                          _run_pallas(_scan32_body, keys_np, k, bq=8))
    assert np.array_equal(select.kth_key_radix8(keys, k).numpy(),
                          _run_pallas(_radix8_body, keys_np, k, bq=8))


def test_radix8_lists_on_the_benchmark_keys():
    """What the kernel's design rests on: after two radix passes only a few
    percent of a benchmark row still shares the prefix, while a prefix row
    keeps every key through pass 4."""
    keys_np = select.make_keys(0, 1, 16, 4096).astype(np.int64)
    kth = np.partition(keys_np, 31, axis=2)[..., 31:32]
    for passes, most in ((1, 0.6), (2, 0.06)):
        shift = 32 - 4 * passes
        share = ((keys_np >> shift) == (kth >> shift)).mean(-1)
        assert share.max() < most, (passes, share.max())
    prefix = select.make_prefix_keys(0, 1, 4, 4096).astype(np.int64)
    assert ((prefix >> 12) == (prefix[..., :1] >> 12)).all()
