"""The five K-th-key variants (K10): plain versions on the CPU against
``np.partition``, the one-hot count rule, and the benchmark script's two
selection kernel bodies in Pallas interpret mode.

``scripts/bench_radix_select.py`` keeps its kernel bodies as closures of its
``main``; ``scan32`` and ``radix8`` are restated here word for word (with K as
an argument) and run through ``pl.pallas_call(..., interpret=True)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from poem_v2_tpu_torch.ops import select

K = 8


def _ref(keys_np, k):
    return np.partition(keys_np, k - 1, axis=2)[..., k - 1:k]


def _scan32_body(keys_ref, out_ref, *, k):
    keys = keys_ref[0]
    int_max = jnp.int32(0x7FFFFFFF)

    def body(j, thr):
        return jnp.min(jnp.where(keys > thr, keys, int_max), axis=1, keepdims=True)

    thr = jax.lax.fori_loop(0, k, body, jnp.full((keys.shape[0], 1), jnp.int32(-(1 << 31))))
    out_ref[0] = thr


def _radix8_body(keys_ref, out_ref, *, k):
    keys = keys_ref[0]
    bq = keys.shape[0]

    def rpass(p, carry):
        prefix, kk = carry
        shift = 28 - 4 * p
        hi = jax.lax.shift_right_logical(keys, jnp.minimum(shift + 4, 31))
        active = (p == 0) | (hi == prefix)
        nib = jax.lax.shift_right_logical(keys, shift) & 0xF
        cnt = [jnp.sum(jnp.where(active & (nib < t), 1, 0), axis=1, keepdims=True)
               for t in range(1, 16)]
        nibble = sum((c < kk).astype(jnp.int32) for c in cnt)
        c_sel = jnp.zeros_like(kk)
        for t, c in enumerate(cnt):
            c_sel = jnp.where(nibble == (t + 1), c, c_sel)
        kk = kk - c_sel
        prefix = jax.lax.shift_left(prefix, 4) | nibble
        return prefix, kk

    prefix, _ = jax.lax.fori_loop(
        0, 8, rpass, (jnp.zeros((bq, 1), jnp.int32), jnp.full((bq, 1), jnp.int32(k))))
    out_ref[0] = prefix


def _run_pallas(body, keys_np, k, bq):
    B, M, N = keys_np.shape
    return np.asarray(pl.pallas_call(
        functools.partial(body, k=k),
        grid=(B, M // bq),
        in_specs=[pl.BlockSpec((1, bq, N), lambda b, i: (b, i, 0))],
        out_specs=pl.BlockSpec((1, bq, 1), lambda b, i: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((B, M, 1), jnp.int32),
        interpret=True,
    )(jnp.asarray(keys_np)))


@pytest.fixture(scope="module")
def keys_np():
    return select.make_keys(0, 2, 64, 512)


def test_make_keys_are_the_scripts():
    """make_keys(0, B, MP, N) repeats bench_radix_select.py:162-165 at any shape."""
    rs = np.random.RandomState(0)
    d2 = rs.rand(2, 64, 512).astype(np.float32) * 4.0
    want = (d2.view(np.int32) & ~0xFFF) | (np.arange(512, dtype=np.int32)[None, None] & 0xFFF)
    got = select.make_keys(0, 2, 64, 512)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (got >= 0).all() and all(len(np.unique(r)) == 512 for r in got.reshape(-1, 512))
    with pytest.raises(ValueError):
        select.make_keys(0, 1, 1, 4097)


@pytest.mark.parametrize("name", ["scan32", "radix8"])
def test_kth_key_matches_partition_and_pallas_body(keys_np, name):
    fn = {"scan32": select.kth_key_scan32, "radix8": select.kth_key_radix8}[name]
    body = {"scan32": _scan32_body, "radix8": _radix8_body}[name]
    got = fn(torch.from_numpy(keys_np), K)
    assert got.dtype == torch.int32 and got.shape == (2, 64, 1)
    assert np.array_equal(got.numpy(), _ref(keys_np, K))                      # tolerance 0
    assert np.array_equal(got.numpy(), _run_pallas(body, keys_np, K, bq=16))
    # another K, and the whole row
    for k in (1, 32, 512):
        assert np.array_equal(fn(torch.from_numpy(keys_np[:1, :4]), k).numpy(),
                              _ref(keys_np[:1, :4], k))


def test_key_row_sum_wraps_as_int32(keys_np):
    got = select.key_row_sum(torch.from_numpy(keys_np))
    want = keys_np.astype(np.int64).sum(-1, keepdims=True).astype(np.int32)  # wraps
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.sum(keys_np, axis=-1, keepdims=True, dtype=np.int32))
    assert (keys_np.astype(np.int64).sum(-1) > np.iinfo(np.int32).max).any(), "sums must wrap"


@pytest.mark.parametrize("name", ["cur", "bcast"])
@pytest.mark.parametrize("block_q, chunk_j", [(64, 8), (16, 4), (32, 1)])
def test_onehot_variants_add_k_times_block_q(keys_np, name, block_q, chunk_j):
    fn = {"cur": select.kth_key_cur, "bcast": select.kth_key_bcast}[name]
    got = fn(torch.from_numpy(keys_np), K, block_q=block_q, chunk_j=chunk_j)
    assert got.dtype == torch.int32 and got.shape == (2, 64, 1)
    assert np.array_equal(got.numpy(), _ref(keys_np, K) + K * block_q)


def test_onehot_count_follows_the_data_not_the_rule():
    """Keys whose low 12 bits name no column of the row score no hit in ``cur``
    (its one-hot compares the column with ``key & 0xFFF``), and still one in
    ``bcast`` (which masks by value): the count is built, not assumed."""
    keys_np = select.make_keys(3, 1, 4, 64)
    shifted = keys_np + 1024            # low bits 1024..1087: no such column among 64
    cur = select.kth_key_cur(torch.from_numpy(shifted), K, block_q=4, chunk_j=4)
    bcast = select.kth_key_bcast(torch.from_numpy(shifted), K, block_q=4, chunk_j=4)
    assert np.array_equal(cur.numpy(), _ref(shifted, K))
    assert np.array_equal(bcast.numpy(), _ref(shifted, K) + K * 4)


def test_all_variants_at_4096_columns():
    keys_np = select.make_keys(1, 1, 64, 4096)
    keys = torch.from_numpy(keys_np)
    ref = _ref(keys_np, 32)
    assert np.array_equal(select.kth_key_scan32(keys, 32).numpy(), ref)
    assert np.array_equal(select.kth_key_radix8(keys, 32).numpy(), ref)
    assert np.array_equal(select.kth_key_cur(keys, 32).numpy(), ref + 2048)
    assert np.array_equal(select.kth_key_bcast(keys, 32).numpy(), ref + 2048)
    assert np.array_equal(select.key_row_sum(keys).numpy(),
                          np.sum(keys_np, axis=-1, keepdims=True, dtype=np.int32))


def test_preconditions_are_checked(keys_np):
    keys = torch.from_numpy(keys_np)
    negative = keys.clone()
    negative[0, 0, 0] = -5
    for fn in (select.kth_key_scan32, select.kth_key_radix8, select.kth_key_cur,
               select.kth_key_bcast):
        with pytest.raises(ValueError, match="non-negative"):
            fn(negative, K)
        with pytest.raises(ValueError):
            fn(keys, 513)                      # K > N
        with pytest.raises(ValueError):
            fn(keys.to(torch.int64), K)
        with pytest.raises(ValueError, match="column"):    # 12 bits name 4096 columns
            fn(torch.zeros(1, 64, 4097, dtype=torch.int32), K)
    for fn in (select.kth_key_cur, select.kth_key_bcast):
        with pytest.raises(ValueError, match="block_q"):
            fn(keys, K, block_q=48)
        with pytest.raises(ValueError, match="chunk_j"):
            fn(keys, K, chunk_j=3)


def test_bench_kth_key_on_the_cpu():
    """The benchmark function end to end at a tiny shape (plain versions, host clock)."""
    lines = []
    res = select.bench_kth_key(B=2, M=32, N=256, k=8, block_q=16, chunk_j=4, device="cpu",
                               iters=1, log=lines.append)
    assert res["exact"] == {"scan32": True, "radix8": True, "cur": True, "bcast": True}
    assert set(res["ms"]) == set(select.VARIANTS) and res["key_bytes"] == 2 * 32 * 256 * 4
    assert "scan32 exact: True" in lines and "radix8 exact: True" in lines
    assert any(line.startswith("bcast: ") and line.endswith(" ms") for line in lines)
