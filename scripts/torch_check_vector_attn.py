"""Check the vector-attention core (K1, K2, K8) and the scatter-add (K7) on one CUDA card.

    env PYTHONPATH=. python3 scripts/torch_check_vector_attn.py [--time] [--quick]

Builds the kernels, prints what ptxas reports for ``knn_attn.cu`` and
``scatter.cu`` (registers, spills), then holds each kernel against its plain
PyTorch version on the card: K1 (cross and self, its indices identical, and
fed with its own indices: the same bits), K2 and K8 at D = 128, 256, 512,
1024, at K = 8, 24, 32, 48 and at M = 1 and 65, in float32 and bfloat16;
K7 at D = 128 .. 1024 bit-identical on repeat. ``--time`` times, at the
serving path's batch-4 shapes (799 queries, 4096 points, K = 32), each
kernel call by call and replayed from a CUDA graph, beside the plain
version, the selection alone and, for K7, ``index_add_`` from a graph.
Exits non-zero on any disagreement. Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys

import numpy as np
import torch

from poem_v2_tpu_torch.ops import _lib, knn_attn, scatter, vector_attn

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def mk(rs, *s, scale=1.0):
    return torch.from_numpy((rs.randn(*s) * scale).astype(np.float32)).cuda()


def mlps(rs, D):
    s = 1 / math.sqrt(D)
    return ([mk(rs, 3, D), mk(rs, D, scale=0.1), mk(rs, D, D, scale=s), mk(rs, D, scale=0.1)],
            [mk(rs, D, D, scale=s), mk(rs, D, scale=0.1), mk(rs, D, D, scale=s),
             mk(rs, D, scale=0.1)])


def ball(rs, B, n):
    x = rs.randn(n, 3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = x * rs.rand(n, 1) ** (1 / 3)
    return torch.from_numpy(x.astype(np.float32))[None].expand(B, n, 3).contiguous().cuda()


def held(name, got, want, dtype):
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or not finite")
    err = float((got - want).abs().max())
    tol = TOL[dtype] * float(want.abs().max())
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e}) {'ok' if err <= tol else 'FAIL'}",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: {err} > {tol}")
    return err


def cases(rs, B, M, N, D, K):
    """(name, kernel call, plain call) of K1 cross, K1 with its own indices, K2 and K8."""
    q, qxyz = mk(rs, B, M, D), mk(rs, B, M, 3, scale=0.4)
    cloud, xf = ball(rs, B, N), mk(rs, B, N, D)
    wk, wv = mk(rs, D, D, scale=1 / math.sqrt(D)), mk(rs, D, D, scale=1 / math.sqrt(D))
    fcd, fcg = mlps(rs, D)
    ka, va, axyz = mk(rs, B, K, D), mk(rs, B, K, D), ball(rs, 1, K)[0]
    kg, vg, dg = mk(rs, B, M, K, D), mk(rs, B, M, K, D), mk(rs, B, M, K, 3, scale=0.4)
    return {
        "K1": ((q, qxyz, cloud, xf, wk, wv, fcd, fcg), dict(n_neighbor=K, return_idx=True),
               knn_attn.fused_knn_vector_attention, knn_attn.plain_fused_knn_vector_attention),
        "K2": ((q, qxyz, ka, va, axyz, fcd, fcg), {}, knn_attn.fused_anchor_vector_attention,
               knn_attn.plain_fused_anchor_vector_attention),
        "K8": ((q, kg, vg, dg, fcd, fcg), {}, vector_attn.fused_vector_attention,
               vector_attn.plain_fused_vector_attention),
    }


KEEP_F32 = {"K1": (1, 2), "K2": (1, 4), "K8": ()}


def cast(args, dtype, keep):
    def c(t, i):
        if i in keep or not isinstance(t, torch.Tensor):
            return [x.to(dtype) for x in t] if isinstance(t, list) else t
        return t.to(dtype)
    return tuple(c(t, i) for i, t in enumerate(args))


def check_core(shapes, dtypes):
    print("core: kernels vs plain versions on the card", flush=True)
    for B, M, N, D, K in shapes:
        rs = np.random.RandomState(D + K + M)
        for name, (args, kw, fn, plain) in cases(rs, B, M, N, D, K).items():
            for dtype in dtypes:
                a = cast(args, dtype, KEEP_F32[name])
                with torch.no_grad():
                    got, want = fn(*a, **kw), plain(*a, **kw)
                    torch.cuda.synchronize()
                    tag = f"{name} B{B} M{M} N{N} D{D} K{K} [{str(dtype)[6:]}]"
                    if name == "K1":
                        (got, gidx), (want, widx) = got, want
                        if not torch.equal(gidx, widx):
                            raise AssertionError(f"{tag}: {int((gidx != widx).sum())} indices differ")
                        again = fn(*a, n_neighbor=K, neighbor_idx=gidx)
                        if not torch.equal(again, got):
                            raise AssertionError(f"{tag}: neighbor_idx gives other bits")
                    held(tag, got, want, dtype)


def check_scatter(widths):
    print("K7: scatter_add_rows vs index_add_, bit-identical on repeat", flush=True)
    rs = np.random.RandomState(5)
    B, M, K = 4, 799, 32
    for D in widths:
        g = mk(rs, B, M, K, D)
        for n_rows, step in ((M, 1), (4096, 16), (5000, 1)):
            idx = torch.from_numpy((rs.randint(-3, n_rows // step + 3, (B, M, K)) * step)
                                   .astype(np.int32)).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                gd = g.to(dtype)
                got, again = (scatter.scatter_add_rows(gd, idx, n_rows) for _ in range(2))
                want = scatter.plain_scatter_add_rows(gd, idx, n_rows)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K7 D{D} n_rows {n_rows}: two launches differ")
                err = float((got - want).abs().max())
                tol = 1e-5 * float(want.abs().max())
                print(f"  K7 D{D} n_rows {n_rows} [{str(dtype)[6:]}]: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}), repeat bit-identical", flush=True)
                if err > tol:
                    raise AssertionError("K7 disagrees")


def t_events(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def t_graph(fn, iters=20):
    """ms a call of ``fn`` replayed from a CUDA graph of ``iters`` calls."""
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
    return t_events(graph.replay, iters=3, warmup=1) / iters


def time_all(widths):
    print(f"times, bf16, B4, 799 queries, 4096 points, K = 32 [{gpu_line()}]", flush=True)
    B, M, N, K = 4, 799, 4096, 32
    out = {}
    for D in widths:
        rs = np.random.RandomState(D)
        for name, (args, kw, fn, plain) in cases(rs, B, M, N, D, K).items():
            a = cast(args, torch.bfloat16, KEEP_F32[name])
            kw = {k: v for k, v in kw.items() if k != "return_idx"}
            with torch.no_grad():
                call = lambda: fn(*a, **kw)
                row = dict(ms=t_events(call), graph_ms=t_graph(call),
                           plain_ms=t_events(lambda: plain(*a, **kw), iters=3, warmup=1))
                if name == "K1":
                    sel = lambda: knn_attn.knn_select(a[1], a[2], K)
                    row["select_ms"] = t_events(sel)
                    row["select_graph_ms"] = t_graph(sel)
                    nb = knn_attn.fused_knn_vector_attention(*a, n_neighbor=K, return_idx=True)[1]
                    row["from_idx_graph_ms"] = t_graph(lambda: fn(*a, n_neighbor=K,
                                                                  neighbor_idx=nb))
            out[f"{name} D{D}"] = row
            print(f"  {name} D{D}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
                  flush=True)
        # K7 at the train path's shapes: self (799 rows) and cross (4096)
        g = mk(rs, B, M, K, D).bfloat16()
        for case, n_rows in (("self", M), ("cross", N)):
            idx = torch.from_numpy(rs.randint(0, n_rows, (B, M, K)).astype(np.int32)).cuda()
            rows = (torch.arange(B, device="cuda")[:, None] * n_rows + idx.reshape(B, -1).long()
                    ).reshape(-1)
            src = g.reshape(-1, D).float()
            sink = torch.empty((B * n_rows, D), dtype=torch.float32, device="cuda")
            call = lambda: scatter.scatter_add_rows(g, idx, n_rows)
            lib_call = lambda: sink.zero_().index_add_(0, rows, src)
            row = dict(ms=t_events(call), graph_ms=t_graph(call), library_ms=t_events(lib_call),
                       library_graph_ms=t_graph(lib_call))
            out[f"K7 {case} D{D}"] = row
            print(f"  K7 {case} D{D}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
                  flush=True)
    return out


def profile_core(widths):
    """Device time by kernel name of 10 calls each of K1 (cross), K2 and K8 and
    of K7 (cross), bf16, batch-4 shapes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    B, M, N, K = 4, 799, 4096, 32
    for D in widths:
        rs = np.random.RandomState(D)
        for name, (args, kw, fn, _) in cases(rs, B, M, N, D, K).items():
            a = cast(args, torch.bfloat16, KEEP_F32[name])
            kw = {k: v for k, v in kw.items() if k != "return_idx"}
            with torch.no_grad():
                for _ in range(3):
                    fn(*a, **kw)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn(*a, **kw)
                    torch.cuda.synchronize()
            dev = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    dev[e.name] = dev.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e4
            print(f"  profile {name} D{D} (ms a call): " + "; ".join(
                f"{k[:48]} {v:.4f}" for k, v in sorted(dev.items(), key=lambda kv: -kv[1])),
                flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--quick", action="store_true", help="D 256 and 1024 only, fewer shapes")
    ap.add_argument("--profile", action="store_true",
                    help="only the device time by kernel of the core (no checks)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _lib.lib()
    for line in lib.ptxas_log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line) and \
                ("core" in line or "scatter" in line or "vector_attn" in line or "spill" in line):
            print("ptxas:", line.strip())
    widths = (256, 1024) if a.quick else (128, 256, 512, 1024)
    if a.profile:
        profile_core(widths)
        print(gpu_line())
        return 0
    shapes = [(2, 799, 4096, D, 32) for D in widths]
    shapes += [(2, M, 600, D, K) for D in (256,) for K in (8, 24, 48) for M in (1, 65)]
    shapes += [(2, 65, 600, 1024, 24), (1, 33, 400, 64, 200), (2, 40, 300, 32, 3)]
    check_core(shapes, (torch.float32, torch.bfloat16))
    check_scatter(widths)
    if a.time:
        time_all(widths)
    print(gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
