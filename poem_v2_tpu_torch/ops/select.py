"""The exact K-th smallest packed key of every row, five ways (kernel K10).

Counterparts of the five Pallas kernel bodies of
``scripts/bench_radix_select.py``, a micro-benchmark of the selection inside
the fused KNN attention:

* :func:`kth_key_scan32` <- ``scan32_kernel``: K strict-threshold rounds;
* :func:`kth_key_radix8` <- ``radix8_kernel``: eight 4-bit passes from the
  top nibble down;
* :func:`key_row_sum` <- ``pass1_kernel``: the int32 wrap-around sum of a
  row, what one pass over the keys costs;
* :func:`kth_key_cur` <- ``cur_kernel``: the rounds of ``scan32`` plus the
  extraction: one one-hot row per round, summed per chunk of ``chunk_j``
  rounds over the ``block_q`` rows of a query block;
* :func:`kth_key_bcast` <- ``bcast_kernel``: ``chunk_j`` rounds for the
  chunk's threshold, then one extraction per chunk from a mask and the
  prefix sum of the mask.

Keys are (B, M, N) int32. The K-th-key functions require **non-negative**
keys (the radix order is the unsigned one; checked, ``ValueError``) and keys
that are **unique within a row** (a strict-threshold round skips equal keys;
the caller's contract, as in the fused attention, whose keys carry their
column in the low 12 bits; :func:`make_keys` builds such keys). ``cur`` and
``bcast`` return the K-th key plus the number of one-hot hits summed over the
row's query block: ``n_neighbor * block_q`` for such keys.

Each wrapper takes CPU tensors to its plain PyTorch version beside it and
CUDA tensors to the hand-written kernel in ``csrc/select.cu``; there is no
fallback from one to the other. ``<wrapper>.launches`` counts kernel launches.
:func:`bench_kth_key` is the benchmark itself: ``scripts/torch_bench_radix_select.py``
and ``chip_smoke.py`` both call it.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from . import _lib

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
MAX_COLUMNS = 4096  # the packed keys keep the column in 12 bits


def make_keys(seed: int, B: int, M: int, N: int) -> np.ndarray:
    """The benchmark's keys: (B, M, N) int32, ``(bits(d2) & ~0xFFF) | column``
    for uniform d2 in [0, 4): non-negative, unique within a row."""
    if N > MAX_COLUMNS:
        raise ValueError(f"a packed key holds a column below {MAX_COLUMNS}, got N={N}")
    rs = np.random.RandomState(seed)
    d2 = rs.rand(B, M, N).astype(np.float32) * 4.0
    col = np.arange(N, dtype=np.int32)[None, None]
    return (d2.view(np.int32) & ~0xFFF) | (col & 0xFFF)


def make_prefix_keys(seed: int, B: int, M: int, N: int, base: int = 0x3D5A3000) -> np.ndarray:
    """Adversarial keys: every key of a row shares the top 20 bits of ``base``,
    ``(base & ~0xFFF) | column`` with the columns in a random order a row, so
    radix8's first five passes keep the whole row active. Non-negative and
    unique within a row, as :func:`make_keys`."""
    if N > MAX_COLUMNS:
        raise ValueError(f"a packed key holds a column below {MAX_COLUMNS}, got N={N}")
    if not 0 <= base < (1 << 31):
        raise ValueError(f"base {base:#x} must be a non-negative int32")
    rs = np.random.RandomState(seed)
    cols = np.argsort(rs.rand(B, M, N), axis=-1).astype(np.int32)
    return np.int32(base & ~0xFFF) | cols


def _check_keys(keys: torch.Tensor, k: int, non_negative: bool = True) -> None:
    if keys.dim() != 3 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (B, M, N) int32, got {tuple(keys.shape)} {keys.dtype}")
    if keys.shape[-1] > MAX_COLUMNS:
        raise ValueError(f"a packed key holds a column below {MAX_COLUMNS}, got "
                         f"N={keys.shape[-1]}")
    if not 1 <= k <= keys.shape[-1]:
        raise ValueError(f"K={k} outside 1..N={keys.shape[-1]}")
    if non_negative and bool((keys < 0).any()):
        raise ValueError("the radix order requires non-negative keys")


def _check_chunks(keys: torch.Tensor, k: int, block_q: int, chunk_j: int) -> None:
    if keys.shape[1] % block_q:
        raise ValueError(f"M={keys.shape[1]} is not a multiple of block_q={block_q}")
    if k % chunk_j:
        raise ValueError(f"K={k} is not a multiple of chunk_j={chunk_j}")


def _next_key(keys: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """One threshold round: the smallest key above ``thr`` (B, M, 1) in every row."""
    big = torch.full_like(keys, INT32_MAX)
    return torch.where(keys > thr, keys, big).min(dim=-1, keepdim=True).values


def plain_kth_key_scan32(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`kth_key_scan32`."""
    thr = torch.full(keys.shape[:2] + (1,), INT32_MIN, dtype=torch.int32, device=keys.device)
    for _ in range(k):
        thr = _next_key(keys, thr)
    return thr


def plain_kth_key_radix8(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`kth_key_radix8`."""
    prefix = torch.zeros(keys.shape[:2] + (1,), dtype=torch.int32, device=keys.device)
    left = torch.full_like(prefix, k)  # rank still to find among the active keys
    for p in range(8):
        shift = 28 - 4 * p
        # keys are non-negative, so the arithmetic shift is the logical one;
        # pass 0 has no prefix yet and every key is active
        active = torch.ones_like(keys, dtype=torch.bool) if p == 0 else \
            (keys >> (shift + 4)) == prefix
        nib = (keys >> shift) & 0xF
        # c_t = #{active keys with nibble < t}, t = 1..15
        cnt = [(active & (nib < t)).sum(dim=-1, keepdim=True).to(torch.int32)
               for t in range(1, 16)]
        nibble = sum((c < left).to(torch.int32) for c in cnt)
        below = torch.zeros_like(left)
        for t, c in enumerate(cnt):
            below = torch.where(nibble == t + 1, c, below)
        left = left - below
        prefix = (prefix << 4) | nibble
    return prefix


def plain_key_row_sum(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`key_row_sum` (the int64 sum cut to int32 wraps)."""
    return keys.sum(dim=-1, keepdim=True).to(torch.int32)


def _block_total(hits: torch.Tensor, block_q: int) -> torch.Tensor:
    """(B, M) per-row hits -> (B, M, 1) int32: each row gets its query block's sum."""
    B, M = hits.shape
    total = hits.reshape(B, M // block_q, block_q).sum(-1, keepdim=True)
    return total.expand(B, M // block_q, block_q).reshape(B, M, 1).to(torch.int32)


def plain_kth_key_cur(keys: torch.Tensor, k: int, block_q: int = 64,
                      chunk_j: int = 16) -> torch.Tensor:
    """Plain PyTorch version of :func:`kth_key_cur`."""
    _check_chunks(keys, k, block_q, chunk_j)
    col = torch.arange(keys.shape[-1], dtype=torch.int32, device=keys.device)
    thr = torch.full(keys.shape[:2] + (1,), INT32_MIN, dtype=torch.int32, device=keys.device)
    hits = torch.zeros(keys.shape[:2], dtype=torch.int64, device=keys.device)
    for _ in range(k // chunk_j):
        for _ in range(chunk_j):
            thr = _next_key(keys, thr)
            one_hot = col == (thr & 0xFFF)  # (B, M, N): the round's one-hot rows
            hits += one_hot.sum(-1)
    return thr + _block_total(hits, block_q)


def plain_kth_key_bcast(keys: torch.Tensor, k: int, block_q: int = 64,
                        chunk_j: int = 16) -> torch.Tensor:
    """Plain PyTorch version of :func:`kth_key_bcast`."""
    _check_chunks(keys, k, block_q, chunk_j)
    thr = torch.full(keys.shape[:2] + (1,), INT32_MIN, dtype=torch.int32, device=keys.device)
    hits = torch.zeros(keys.shape[:2], dtype=torch.int64, device=keys.device)
    slots = torch.arange(chunk_j, device=keys.device)[:, None, None, None]
    for _ in range(k // chunk_j):
        lo = thr
        for _ in range(chunk_j):
            thr = _next_key(keys, thr)
        mask = (keys > lo) & (keys <= thr)  # chunk_j columns of a row with unique keys
        slot = torch.cumsum(mask, dim=-1) - 1
        one_hot = mask[None] & (slot[None] == slots)  # (chunk_j, B, M, N)
        hits += one_hot.sum(dim=(0, -1))
    return thr + _block_total(hits, block_q)


def _launch_rows(variant: int, keys: torch.Tensor, k: int) -> torch.Tensor:
    B, M, N = keys.shape
    keys = keys.contiguous()
    out = torch.empty((B, M, 1), dtype=torch.int32, device=keys.device)
    _lib.lib().call("poem_kth_key_rows", variant, keys.data_ptr(), out.data_ptr(), B * M, N, k,
                    _lib.stream_ptr(keys))
    return out


def _scan32_on_card(keys: torch.Tensor, k: int) -> torch.Tensor:
    out = _launch_rows(0, keys, k)
    kth_key_scan32.launches += 1
    return out


def kth_key_scan32(keys: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M, N) int32 keys -> (B, M, 1) int32, the K-th smallest key of every
    row by K rounds of "the smallest key above the last one"."""
    _check_keys(keys, k)
    if keys.device.type == "cpu":
        return plain_kth_key_scan32(keys, k)
    return _scan32_on_card(keys, k)


kth_key_scan32.launches = 0


def _radix8_on_card(keys: torch.Tensor, k: int) -> torch.Tensor:
    out = _launch_rows(1, keys, k)
    kth_key_radix8.launches += 1
    return out


def kth_key_radix8(keys: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M, N) int32 keys -> (B, M, 1) int32, the K-th smallest key of every
    row by eight 4-bit radix passes from the top nibble down."""
    _check_keys(keys, k)
    if keys.device.type == "cpu":
        return plain_kth_key_radix8(keys, k)
    return _radix8_on_card(keys, k)


kth_key_radix8.launches = 0


def key_row_sum(keys: torch.Tensor) -> torch.Tensor:
    """(B, M, N) int32 keys -> (B, M, 1) int32 wrap-around sums: one pass over the keys."""
    _check_keys(keys, 1, non_negative=False)
    if keys.device.type == "cpu":
        return plain_key_row_sum(keys)
    out = _launch_rows(2, keys, 1)
    key_row_sum.launches += 1
    return out


key_row_sum.launches = 0


def _launch_onehot(bcast: int, keys: torch.Tensor, k: int, block_q: int,
                   chunk_j: int) -> torch.Tensor:
    B, M, N = keys.shape
    # the block keeps a row's keys, chunk_j one-hot rows and block_q results on chip
    if 4 * N + chunk_j * ((N + 3) // 4 * 4) + 4 * block_q > 227 * 1024:
        raise ValueError(f"N={N} with chunk_j={chunk_j}, block_q={block_q} exceeds the "
                         "kernel's shared memory")
    keys = keys.contiguous()
    out = torch.empty((B, M, 1), dtype=torch.int32, device=keys.device)
    _lib.lib().call("poem_kth_key_onehot", bcast, keys.data_ptr(), out.data_ptr(), B, M, N, k,
                    block_q, chunk_j, _lib.stream_ptr(keys))
    return out


def _cur_on_card(keys: torch.Tensor, k: int, block_q: int, chunk_j: int) -> torch.Tensor:
    out = _launch_onehot(0, keys, k, block_q, chunk_j)
    kth_key_cur.launches += 1
    return out


def kth_key_cur(keys: torch.Tensor, k: int, block_q: int = 64, chunk_j: int = 16) -> torch.Tensor:
    """(B, M, N) int32 keys -> (B, M, 1) int32: the K-th smallest key of every
    row plus the one-hot hits of its query block. Every round writes the
    one-hot row of its key's column (``key & 0xFFF``); each chunk of
    ``chunk_j`` rounds sums its one-hot rows; a block of ``block_q`` rows
    shares the total (``k * block_q`` for packed unique keys)."""
    _check_keys(keys, k)
    _check_chunks(keys, k, block_q, chunk_j)
    if keys.device.type == "cpu":
        return plain_kth_key_cur(keys, k, block_q, chunk_j)
    return _cur_on_card(keys, k, block_q, chunk_j)


kth_key_cur.launches = 0


def _bcast_on_card(keys: torch.Tensor, k: int, block_q: int, chunk_j: int) -> torch.Tensor:
    out = _launch_onehot(1, keys, k, block_q, chunk_j)
    kth_key_bcast.launches += 1
    return out


def kth_key_bcast(keys: torch.Tensor, k: int, block_q: int = 64,
                  chunk_j: int = 16) -> torch.Tensor:
    """What :func:`kth_key_cur` returns, with one extraction per chunk: the
    chunk's ``chunk_j`` rounds find its threshold, the keys between the last
    threshold and this one are masked, each masked column's slot is the
    prefix sum of the mask, and the ``chunk_j`` one-hot rows follow from
    (mask, slot)."""
    _check_keys(keys, k)
    _check_chunks(keys, k, block_q, chunk_j)
    if keys.device.type == "cpu":
        return plain_kth_key_bcast(keys, k, block_q, chunk_j)
    return _bcast_on_card(keys, k, block_q, chunk_j)


kth_key_bcast.launches = 0

VARIANTS = ("pass1", "scan32", "radix8", "cur", "bcast")


def variant_calls(keys: torch.Tensor, k: int, block_q: int, chunk_j: int, plain: bool = False
                  ) -> Dict[str, Callable[[], torch.Tensor]]:
    """name -> call of each variant on ``keys``: the kernels for keys on the card
    (the plain versions with ``plain``, and for keys on the CPU). The wrappers'
    preconditions are checked here, once, so that a call timed on the card holds
    no device-to-host sync."""
    _check_keys(keys, k)
    _check_chunks(keys, k, block_q, chunk_j)
    if plain or keys.device.type == "cpu":
        return {
            "pass1": lambda: plain_key_row_sum(keys),
            "scan32": lambda: plain_kth_key_scan32(keys, k),
            "radix8": lambda: plain_kth_key_radix8(keys, k),
            "cur": lambda: plain_kth_key_cur(keys, k, block_q, chunk_j),
            "bcast": lambda: plain_kth_key_bcast(keys, k, block_q, chunk_j),
        }
    return {
        "pass1": lambda: key_row_sum(keys),
        "scan32": lambda: _scan32_on_card(keys, k),
        "radix8": lambda: _radix8_on_card(keys, k),
        "cur": lambda: _cur_on_card(keys, k, block_q, chunk_j),
        "bcast": lambda: _bcast_on_card(keys, k, block_q, chunk_j),
    }


def _time_ms(fn: Callable, device: torch.device, iters: int) -> float:
    """Mean milliseconds a call: CUDA events on the card, the host clock on the CPU."""
    import time

    fn()
    if device.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def bench_kth_key(B: int = 16, M: int = 832, N: int = 4096, k: int = 32, block_q: int = 64,
                  chunk_j: int = 16, seed: int = 0, device: str = "cuda", iters: int = 50,
                  log: Callable[[str], None] = print) -> dict:
    """The K-th-key benchmark: check, then time, the five variants.

    Builds :func:`make_keys`, asserts the keys' two preconditions on the
    host, holds ``scan32`` and ``radix8`` against ``np.partition`` and
    ``cur`` against ``bcast`` (and both against the K-th key plus
    ``k * block_q``), raises if any differs, then times every variant and
    logs ``name exact: True`` / ``name: x ms`` lines. Returns
    ``{"exact": {name: bool}, "ms": {name: float}, "key_bytes": int}``.
    The defaults are the shape of ``scripts/bench_radix_select.py``."""
    keys_np = make_keys(seed, B, M, N)
    if not (keys_np >= 0).all():
        raise AssertionError("radix order requires non-negative keys")
    if not all(len(np.unique(keys_np[b, m])) == N
               for b in range(0, B, 7) for m in range(0, M, 311)):
        raise AssertionError("threshold scans require per-row-unique keys")
    keys = torch.from_numpy(keys_np).to(device)
    calls = variant_calls(keys, k, block_q, chunk_j)
    ref = np.partition(keys_np, k - 1, axis=2)[..., k - 1:k]
    got = {name: calls[name]().cpu().numpy() for name in ("scan32", "radix8", "cur", "bcast")}
    exact = {
        "scan32": bool(np.array_equal(got["scan32"], ref)),
        "radix8": bool(np.array_equal(got["radix8"], ref)),
        "cur": bool(np.array_equal(got["cur"], ref + k * block_q)),
        "bcast": bool(np.array_equal(got["bcast"], got["cur"])),
    }
    log(f"scan32 exact: {exact['scan32']}")
    log(f"radix8 exact: {exact['radix8']}")
    log(f"cur == kth key + {k * block_q} one-hot hits: {exact['cur']}")
    log(f"cur == bcast (thr + onehot checksum): {exact['bcast']}")
    wrong = [name for name, ok in exact.items() if not ok]
    if wrong:
        raise AssertionError(f"K-th key variants that are not exact: {wrong}")
    ms = {}
    for name in VARIANTS:
        ms[name] = _time_ms(calls[name], keys.device, iters)
        log(f"{name}: {ms[name]:.3f} ms")
    return dict(exact=exact, ms=ms, key_bytes=keys_np.nbytes)
