"""K1's and K9's neighbour selections alone on one CUDA card.

    env PYTHONPATH=<tree> python3 scripts/torch_check_knn_select.py [--times]

Without options: builds the port's kernels, prints what ``ptxas -v`` said of
the selection kernels, and runs ``chip_smoke.py``'s phase 1a selections
(``phase_selection_shapes``): ``knn_select`` (K1's selection) and
``knn_select_bucketed`` (K9's) against their plain versions on the card with
``torch.equal``, K1 at M 1 / 65, N 1 / 33 / 799 / 4096 / 5000 / 7000, K 1 /
32 / 48 / N, with and without every point twice; K9 up to 32 768 candidates a
block, ragged last blocks, every bucket a candidate, bucket sizes that are no
multiple of 32; two launches the same bits.

``--times``: bfloat16 / float32 times at B 4, 799 queries, CUDA events, call
by call and replayed from a CUDA graph, through functions that every tree of
the port has (``knn_select``, ``fused_knn_vector_attention``,
``fused_knn_vector_attention_bucketed``), so that two trees compare on one
card: K1's selection (cross: 4096 BPS points, self: the 799 queries), K1
cross whole at D 256, K9 whole at ``n_cand`` 8 on the BPS cloud, and
``torch.topk`` of a precomputed d2 as a yardstick (not the same function: it
does not promise the lowest index among ties). Prints one JSON line.
Exits non-zero on any disagreement. Needs no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import numpy as np
import torch

from poem_v2_tpu_torch.ops import _lib, knn_attn, points

# the card's float32 rate outside the tensor cores (NVIDIA H100 SXM data sheet)
PEAK_F32 = 67e12
# float32 operations a (query, point) pair: 13 for d2, one compare
OPS_PER_PAIR = 14


def ptxas_report() -> None:
    lines = _lib.lib().ptxas_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and ("select" in line or "margin" in line):
            name = line.split("'")[1]
            used = next((l for l in lines[i + 1:i + 6] if "Used" in l), "")
            spill = next((l for l in lines[i + 1:i + 6] if "spill" in l), "")
            print(f"  {name[:70]}: {used.split(':', 1)[-1].strip()} | {spill.strip()}")


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    """Mean ms per call replayed from a CUDA graph of ``iters`` calls."""
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


def ball(rs, n) -> torch.Tensor:
    x = rs.randn(n, 3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy((x * rs.rand(n, 1) ** (1 / 3)).astype(np.float32))


def bps_bucketed(rs, B=4, M=799, N=4096, D=256, SB=128, dtype=torch.bfloat16):
    """K9's inputs as the decoder would give them: the released BPS cloud in
    k-d buckets, a posed MANO hand's joints and vertices as queries, over the
    ball's radius (as ``chip_smoke.py`` phase 1c builds them)."""
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.mano.layer import ManoLayer
    from poem_v2_tpu_torch.models.poem import load_static_assets

    head = MEDIUM["MODEL"]["HEAD"]
    radius = head["RADIUS_SAMPLE"]
    bps = load_static_assets(head, N, radius)[0] / radius
    perm, lo, hi = points.build_balanced_buckets(bps, SB)
    cloud = torch.from_numpy(bps[perm])[None].expand(B, N, 3).contiguous()
    pose = torch.from_numpy((rs.randn(B, 48) * 0.2).astype(np.float32))
    betas = torch.from_numpy((rs.randn(B, 10) * 0.3).astype(np.float32))
    hand = ManoLayer(center_idx=9)(pose, betas)
    qxyz = (torch.cat([hand.joints, hand.verts], 1) / radius)[:, :M].contiguous()
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    s = 1 / math.sqrt(D)
    mlp = lambda d_in: [f(d_in, D) / math.sqrt(d_in), f(D) * 0.1, f(D, D) * s, f(D) * 0.1]
    feats = [f(B, M, D).to(dtype), qxyz, cloud, f(B, N, D).to(dtype), torch.from_numpy(lo),
             torch.from_numpy(hi), (f(D, D) * s).to(dtype), (f(D, D) * s).to(dtype)]
    fcd = [t.to(dtype) for t in mlp(3)]
    fcg = [t.to(dtype) for t in mlp(D)]
    return [t.cuda() for t in feats], [t.cuda() for t in fcd], [t.cuda() for t in fcg]


def times(B=4, M=799, N=4096, K=32, D=256) -> dict:
    rs = np.random.RandomState(10)
    qxyz = (torch.from_numpy(rs.randn(B, M, 3).astype(np.float32)) * 0.4).cuda()
    cloud = ball(rs, N)[None].expand(B, N, 3).contiguous().cuda()
    bf = torch.bfloat16
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(bf).cuda()
    s = 1 / math.sqrt(D)
    mlp = lambda d_in: [f(d_in, D) / math.sqrt(d_in), f(D) * 0.1, f(D, D) * s, f(D) * 0.1]
    k1 = (f(B, M, D), qxyz, cloud, f(B, N, D), f(D, D) * s, f(D, D) * s, mlp(3), mlp(D))
    d2_cross = knn_attn.square_distance_rn(qxyz, cloud)
    d2_self = knn_attn.square_distance_rn(qxyz, qxyz)
    k9, fcd9, fcg9 = bps_bucketed(np.random.RandomState(8), B, M, N, D)
    calls = {
        "knn_select/cross": (lambda: knn_attn.knn_select(qxyz, cloud, K), B * M * N),
        "knn_select/self": (lambda: knn_attn.knn_select(qxyz, qxyz, K), B * M * M),
        "torch.topk of d2/cross": (
            lambda: torch.topk(d2_cross, K, dim=-1, largest=False, sorted=True), None),
        "torch.topk of d2/self": (
            lambda: torch.topk(d2_self, K, dim=-1, largest=False, sorted=True), None),
        "fused_knn_vector_attention/cross": (
            lambda: knn_attn.fused_knn_vector_attention(*k1, n_neighbor=K), None),
        "fused_knn_vector_attention_bucketed/n_cand8": (
            lambda: knn_attn.fused_knn_vector_attention_bucketed(*k9, fcd9, fcg9, n_neighbor=K),
            None),
    }
    if hasattr(knn_attn, "knn_select_bucketed"):
        lo, hi = k9[4], k9[5]
        cand = knn_attn.select_candidate_buckets(knn_attn._pad_queries_edge(k9[1], 32), lo, hi,
                                                 32, 8)
        calls["select_candidate_buckets/n_cand8"] = (
            lambda: knn_attn.select_candidate_buckets(knn_attn._pad_queries_edge(k9[1], 32), lo,
                                                      hi, 32, 8), None)
        calls["knn_select_bucketed/n_cand8"] = (
            lambda: knn_attn.knn_select_bucketed(k9[1], k9[2], lo, hi, cand, K, 32, 8, 128),
            B * M * 8 * 128)
    out = {}
    with torch.inference_mode():
        for name, (fn, pairs) in calls.items():
            row = dict(ms=time_cuda(fn), graph_ms=time_graph(fn))
            if pairs is not None:
                row["bound_ms"] = OPS_PER_PAIR * pairs / PEAK_F32 * 1e3
            out[name] = row
            print(f"  {name}: call by call {row['ms']:.4f} ms, from a CUDA graph "
                  f"{row['graph_ms']:.4f} ms" + (f", bound {row['bound_ms']:.4f} ms (operations)"
                                                 if "bound_ms" in row else ""), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--label", default="", help="a name for the tree, printed in the JSON line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _lib.lib()
    print(f"library {lib.path}; {gpu_line()}", flush=True)
    if args.times:
        print(json.dumps({"label": args.label, "gpu": gpu_line(), "times": times()}), flush=True)
        return 0
    ptxas_report()
    # the shapes of chip_smoke.py's phase 1a (this tree's: only --times runs on
    # other trees)
    import chip_smoke

    results = {}
    chip_smoke.phase_selection_shapes(results)
    print(f"  identical to the plain versions, two launches alike: {results['selection_shapes']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
