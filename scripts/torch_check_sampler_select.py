"""K4 (the BPS sampler) and K10 (the K-th-key selection) alone on one CUDA card.

    env PYTHONPATH=. python3 scripts/torch_check_sampler_select.py [--time]

Builds the port's kernels, prints what ``ptxas -v`` said of the two kernels'
instances (registers, spills, shared memory), then holds them against their
plain versions on the card, both with tolerance 0:

* K4 (``ops/bilinear.py:grid_sample_points``), float32 and bfloat16: 32 maps
  of 16 x 16 at C 128 / 256 / 512 / 1024 and 128 maps at C 256, 4096 points
  from -1.2 to 1.2 (off the map included); a ragged case (12 x 20 map, C 24,
  4099 points with cell borders), a C of whole elements only (C 6), a map
  that is not 16-byte aligned, and a 128 x 128 map (its slice does not fit:
  the direct-read instance).
* K10 (``ops/select.py``), the five variants: the benchmark's keys (16, 832,
  4096) at K 32, keys that share a row-wide 20-bit prefix, and rows of N 1,
  33, 4095, 4096 at K 1, 32 and N; scan32 and radix8 also against
  ``np.partition``; radix8 also 50 launches each at N 33, 500 and 4096.

``--time`` adds CUDA-event times (mean of 20 launches after 3; K4 also
replayed from a CUDA graph, which leaves out the host's cost of a call) at
the serving shapes beside ``F.grid_sample``, K4 also with its taps read
from device memory instead of a staged slice, and the five K10 variants beside
``torch.kthvalue`` and ``torch.topk``, each with its byte bound. Exits
non-zero on any disagreement. Needs no JAX.

``--k4-times`` runs K4's call-by-call and CUDA-graph times alone, through
``grid_sample_points`` only, so that two trees of the port compare on one
card (the same script, ``PYTHONPATH`` set to each tree in turn)::

    env PYTHONPATH=<tree> python3 scripts/torch_check_sampler_select.py --k4-times
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from poem_v2_tpu_torch.ops import _lib, bilinear, select

PEAK_BYTES_PER_S = 3.35e12


def ptxas_report() -> None:
    lines = _lib.lib().ptxas_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and ("grid_sample" in line or "kth_key" in line
                                                   or "key_row_sum" in line):
            name = line.split("'")[1]
            used = next((l for l in lines[i + 1:i + 6] if "Used" in l), "")
            spill = next((l for l in lines[i + 1:i + 6] if "spill" in l), "")
            print(f"  {name[:80]}: {used.split(':', 1)[-1].strip()} | {spill.strip()}")


def time_cuda(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def time_graph(fn, iters=20) -> float:
    """Mean milliseconds a call replayed from a CUDA graph of ``iters`` calls:
    the kernel without the host's cost of a call."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_cuda(graph.replay, iters=3, warmup=1) / iters


def sampler_inputs(rs, B, H, W, C, N, dtype, borders=False):
    feat = torch.from_numpy(rs.randn(B, H, W, C).astype(np.float32)).to(dtype)
    coords = torch.from_numpy(rs.uniform(-1.2, 1.2, (B, N, 2)).astype(np.float32))
    if borders:  # cell borders and corners, the centre, far off the map
        coords[:, :6] = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0], [-2.0, 0.5],
                                      [1.0 - 1.0 / W, -1.0 + 3.0 / H], [0.5, 1.0]])
    return feat.cuda(), coords.cuda()


def check_sampler(name, feat, coords) -> None:
    got = bilinear.grid_sample_points(feat, coords)
    want = bilinear.plain_grid_sample_points(feat, coords)
    torch.cuda.synchronize()
    same = got.dtype == want.dtype and torch.equal(got, want)
    g = bilinear.sampler_geometry(*feat.shape, coords.shape[1], feat.element_size(),
                                  aligned=feat.data_ptr() % 16 == 0)
    print(f"  K4 {name} [{str(feat.dtype).split('.')[-1]}]: bit-identical {same} ({g})")
    if not same:
        err = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"K4 {name}: differs from its plain version by {err}")


def sampler_checks() -> None:
    rs = np.random.RandomState(0)
    for dtype in (torch.float32, torch.bfloat16):
        for B, C in ((32, 128), (32, 256), (32, 512), (32, 1024), (128, 256)):
            check_sampler(f"B{B} 16x16 C{C}", *sampler_inputs(rs, B, 16, 16, C, 4096, dtype))
        check_sampler("ragged 12x20 C24 N4099",
                      *sampler_inputs(rs, 3, 12, 20, 24, 4099, dtype, borders=True))
        check_sampler("whole elements C6", *sampler_inputs(rs, 2, 16, 16, 6, 1000, dtype,
                                                           borders=True))
        feat, coords = sampler_inputs(rs, 2, 16, 16, 64, 777, dtype, borders=True)
        flat = torch.empty(feat.numel() + 1, dtype=dtype, device=feat.device)
        shifted = flat[1:].view(feat.shape)  # contiguous, 2 or 4 bytes off 16
        shifted.copy_(feat)
        check_sampler("unaligned map", shifted, coords)
        feat, coords = sampler_inputs(rs, 2, 128, 128, 64, 2000, dtype, borders=True)
        g = bilinear.sampler_geometry(2, 128, 128, 64, 2000, feat.element_size())
        if not g.direct:
            raise AssertionError(f"a 128 x 128 map should read its taps directly: {g}")
        check_sampler("direct 128x128 C64", feat, coords)


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


SAMPLER_SHAPES = ((32, 256), (32, 128), (32, 512), (32, 1024), (128, 256))  # (maps, C)


def launch_direct(feat, coords, out) -> None:
    """The kernel's direct-read instance (taps from device memory) on a
    serving map, which ``sampler_geometry`` would stage: a timing experiment
    only, so it calls the library itself and counts no launch."""
    B, H, W, C = feat.shape
    N = coords.shape[1]
    g = bilinear.sampler_geometry(B, H, W, C, N, feat.element_size())
    _lib.lib().call("poem_grid_sample_points", _lib.dtype_code(feat), feat.data_ptr(),
                    coords.data_ptr(), out.data_ptr(), B, H, W, C, N, g.unit, g.slice_units,
                    g.chunk_points, g.tx, 1, _lib.stream_ptr(feat))


def sampler_times(direct: bool = True) -> None:
    """K4's wrapper call by call and replayed from a CUDA graph at the serving
    shapes, beside its byte bound and ``F.grid_sample``; with ``direct`` also
    the direct-read instance from a graph. Without ``direct`` it needs only
    ``grid_sample_points``, so it times any tree of the port (``PYTHONPATH``)."""
    rs = np.random.RandomState(1)
    print(f"K4 times, bf16, mean of 20 launches ({gpu_line()}; {bilinear.__file__})")
    rows = []
    for B, C in SAMPLER_SHAPES:
        feat, coords = sampler_inputs(rs, B, 16, 16, C, 4096, torch.bfloat16)
        nbytes = 2 * feat.numel() + 4 * coords.numel() + 2 * B * 4096 * C
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        nchw, grid = feat.permute(0, 3, 1, 2), coords[:, :, None, :].to(feat.dtype)
        lib_ms = time_cuda(lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                                 padding_mode="zeros", align_corners=False))
        call_ms = time_cuda(lambda: bilinear.grid_sample_points(feat, coords))
        graph_ms = time_graph(lambda: bilinear.grid_sample_points(feat, coords))
        row = dict(maps=B, C=C, bound_ms=bound, call_ms=call_ms, graph_ms=graph_ms,
                   library_ms=lib_ms)
        line = (f"  B{B} C{C}: bound {bound:.4f} ms; F.grid_sample {lib_ms:.4f} ms; kernel call "
                f"by call {call_ms:.4f} ms ({bound / call_ms:.0%}), from a CUDA graph "
                f"{graph_ms:.4f} ms ({bound / graph_ms:.0%})")
        if direct:
            out = torch.empty((B, 4096, C), dtype=feat.dtype, device=feat.device)
            row["direct_graph_ms"] = time_graph(lambda: launch_direct(feat, coords, out))
            line += f"; taps read directly, from a CUDA graph {row['direct_graph_ms']:.4f} ms"
        print(line)
        rows.append(row)
    print(json.dumps({"k4_times": rows, "gpu": gpu_line()}))


def select_case(name, keys_np, k, block_q=None, chunk_j=None) -> None:
    B, M, N = keys_np.shape
    block_q = block_q or M
    chunk_j = chunk_j or (k if k <= 32 else 1)
    keys = torch.from_numpy(keys_np).cuda()
    calls = select.variant_calls(keys, k, block_q, chunk_j)
    plains = select.variant_calls(keys, k, block_q, chunk_j, plain=True)
    kth = np.partition(keys_np, k - 1, axis=2)[..., k - 1:k]
    for v in select.VARIANTS:
        got = calls[v]().cpu()
        if not torch.equal(got, plains[v]().cpu()):
            raise AssertionError(f"K10 {v} {name} K{k}: differs from its plain version")
        if v in ("scan32", "radix8") and not np.array_equal(got.numpy(), kth):
            raise AssertionError(f"K10 {v} {name} K{k}: differs from np.partition")
    print(f"  K10 {name} K{k}: five variants equal their plain versions (scan32, radix8 "
          "np.partition)")


def select_checks() -> None:
    select_case("benchmark keys (16, 832, 4096)", select.make_keys(1, 16, 832, 4096), 32,
                block_q=64, chunk_j=16)
    select_case("shared 20-bit prefix (4, 64, 4096)", select.make_prefix_keys(2, 4, 64, 4096), 32,
                block_q=64, chunk_j=16)
    for N in (1, 33, 4095, 4096):
        for k in sorted({1, min(32, N), N}):
            for maker in (select.make_keys, select.make_prefix_keys):
                select_case(f"{maker.__name__} (2, 8, {N})", maker(N, 2, 8, N), k)
    radix8_repeats()


def radix8_repeats(repeats: int = 50) -> None:
    """radix8 relaunched on rows that compact at once (N 33 and 500: no
    register pass), on the benchmark's keys (two register passes) and on
    prefix keys (five): every launch equal to the plain version, so a
    shared-memory race between its passes would have to miss them all."""
    for maker, (B, M, N) in ((select.make_keys, (4, 832, 33)), (select.make_keys, (4, 832, 500)),
                             (select.make_keys, (16, 832, 4096)),
                             (select.make_prefix_keys, (16, 832, 4096))):
        keys = torch.from_numpy(maker(3, B, M, N)).cuda()
        want = select.variant_calls(keys, 32, M, 16, plain=True)["radix8"]()
        call = select.variant_calls(keys, 32, M, 16)["radix8"]
        bad = sum(not torch.equal(call(), want) for _ in range(repeats))
        if bad:
            raise AssertionError(f"K10 radix8 {maker.__name__} {(B, M, N)}: {bad} of {repeats} "
                                 "launches differ from the plain version")
        print(f"  K10 radix8 {maker.__name__} {(B, M, N)} K32: {repeats} launches, all equal "
              "to the plain version")


def select_times() -> None:
    gpu = gpu_line()
    for maker in (select.make_keys, select.make_prefix_keys):
        keys = torch.from_numpy(maker(1, 16, 832, 4096)).cuda()
        calls = select.variant_calls(keys, 32, 64, 16)
        bound = (keys.numel() * 4 + 16 * 832 * 4) / PEAK_BYTES_PER_S * 1e3
        ms = {v: time_cuda(calls[v]) for v in select.VARIANTS}
        kth = time_cuda(lambda: torch.kthvalue(keys, 32, dim=-1, keepdim=True))
        topk = time_cuda(lambda: torch.topk(keys, 32, dim=-1, largest=False, sorted=True))
        print(f"K10 times, {maker.__name__} (16, 832, 4096), K 32 ({gpu}): bound {bound:.4f} ms; "
              + ", ".join(f"{v} {t:.4f} ({bound / t:.0%})" for v, t in ms.items())
              + f"; torch.kthvalue {kth:.4f}, torch.topk {topk:.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--k4-times", action="store_true",
                    help="only K4's call-by-call and CUDA-graph times (any tree of the port)")
    args = ap.parse_args()
    if args.k4_times:
        sampler_times(direct=False)
        return 0
    ptxas_report()
    sampler_checks()
    select_checks()
    if args.time:
        sampler_times()
        select_times()
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
