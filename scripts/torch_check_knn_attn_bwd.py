"""Check K6b, the backward of the trainable KNN vector attention, on one CUDA card.

    env PYTHONPATH=. python3 scripts/torch_check_knn_attn_bwd.py [--time] [--profile]
    env PYTHONPATH=<tree> python3 scripts/torch_check_knn_attn_bwd.py --fwd-bwd

Builds the kernels, holds K6b against its plain version at the forward's
indices as ``chip_smoke.py`` does (float32 to 1e-4 of each gradient's peak;
bfloat16 against a float32 autograd of K6's plain forward, within the larger
of the bfloat16 recompute's error and 2e-2 of the peak; two launches
bit-identical) at D = 128 .. 1024 and widths no multiple of 128, K = 8 to
200 (K > 128 spans tiles), one query, self and cross.
``--time``: at the train path's batch-4 shapes (799 queries, 4096 points,
K = 32), self and cross, at D = 128, 256, 512, 1024, K6b call by call and
replayed from a CUDA graph, K6's forward + backward from a graph and the
plain backward (autograd through the recompute). ``--profile``: device time
of one K6b call by kernel (its passes, K7, cuBLAS, the rest) at D 256 and
1024. Last, what ptxas reports for ``knn_attn_bwd.cu``'s kernels (registers,
spills). ``--fwd-bwd`` alone times K6's forward + backward (the train path's
call) call by call and from a CUDA graph at those shapes and nothing else,
through the public functions only, so that it times any tree of the port
(``PYTHONPATH`` at its root), also one from before K6b. Exits non-zero on any
disagreement; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

import chip_smoke as cs
from poem_v2_tpu_torch.ops import _lib, knn_attn

B4, M4, N4, K4 = 4, 799, 4096, 32  # the train path's batch-4 shapes
SHAPES = [  # B, M, N, D, K, self attention
    (2, 65, 600, 256, 24, False), (2, 1, 600, 256, 8, False), (2, 65, 600, 128, 48, False),
    (2, 65, 600, 256, 32, True), (2, 9, 400, 256, 200, False), (2, 40, 300, 96, 16, False),
    (2, 65, 600, 1024, 24, False), (2, 150, 500, 512, 130, True)]
PASSES = ("KV", "POS", "H", "SMB", "DA", "DX", "DT1")


def inputs(rs, B, M, N, D, self_attn):
    """K6's 14 bf16-path inputs on the card (features bf16, xyz and weights
    float32) and a bf16 cotangent, as chip_smoke.py's phase 1e makes them."""
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    qxyz = f(B, M, 3) * 0.4
    pxyz, n = (qxyz, M) if self_attn else (cs._ball(rs, N)[None].expand(B, N, 3).contiguous(), N)
    fcd, fcg = cs._mlps(f, D)
    s = 1 / D ** 0.5
    ts = [f(B, M, D).bfloat16(), qxyz, pxyz, f(B, n, D).bfloat16(), f(D, D) * s, f(D, D) * s,
          *fcd, *fcg]
    return [t.cuda() for t in ts], f(B, M, D).bfloat16().cuda()


def fwd_bwd_call(ts, dout, K):
    """K6's forward + backward, what a train step runs."""
    leaves = [t.detach().requires_grad_() for t in ts]

    def fwd_bwd():
        out = knn_attn.knn_vector_attention_trainable(*leaves[:6], leaves[6:10], leaves[10:],
                                                      n_neighbor=K)
        return torch.autograd.grad(out, leaves, dout)

    return fwd_bwd


def bwd_call(ts, idx, dout):
    """K6b alone."""
    def bwd():
        with torch.no_grad():
            return cs._k6b(knn_attn.knn_vector_attention_trainable_bwd, ts, idx, dout)

    return bwd


def neighbours(ts, K):
    with torch.no_grad():
        return knn_attn.fused_knn_vector_attention(*ts[:6], ts[6:10], ts[10:], n_neighbor=K,
                                                   return_idx=True)[1]


def kernel_label(name: str) -> str:
    """knn_bwd_gemm_kernel<T, EPI, BT> -> its pass; other kernels by family."""
    m = re.search(r"knn_bwd_gemm_kernel<([^,]+), (\d+), ", name)
    if m:
        return f"K6b {PASSES[int(m.group(2))]} ({'bf16' if 'bfloat16' in m.group(1) else 'f32'})"
    for key, label in (("knn_bwd_t1", "K6b t1"), ("knn_bwd_delta", "K6b delta"),
                       ("scatter_", "K7"), ("gemm", "cuBLAS"), ("Gemm", "cuBLAS"),
                       ("sm90_xmma", "cuBLAS"), ("cutlass", "cuBLAS")):
        if key in name:
            return label
    return "other: " + name[:50]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--fwd-bwd", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _lib.lib()
    print(cs.gpu_line(), flush=True)
    rs = np.random.RandomState(0)
    if args.fwd_bwd:
        for D in (128, 256, 512, 1024):
            for case in ("self", "cross"):
                ts, dout = inputs(rs, B4, M4, N4, D, case == "self")
                call = fwd_bwd_call(ts, dout, K4)
                print(f"D{D} {case} bf16: K6 fwd + bwd {cs.time_cuda(call, iters=10):.3f} ms "
                      f"call by call, {cs.time_graph(call, iters=10):.3f} from a CUDA graph",
                      flush=True)
        print(cs.gpu_line())
        return 0
    results = {}
    for B, M, N, D, K, self_attn in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            ts, dout = cs.k6_train_inputs(rs, B, M, N, D, dtype, self_attn)
            idx = neighbours(ts, K)
            name = f"B{B}_M{M}_N{N}_D{D}_K{K}_{'self' if self_attn else 'cross'}"
            cs.k6b_case(results, name, ts, idx, dout, dtype)
    print(f"K6b held at {len(SHAPES)} shapes in float32 and bfloat16, bit-identical on repeat",
          flush=True)
    if args.time:
        for D in (128, 256, 512, 1024):
            for case in ("self", "cross"):
                ts, dout = inputs(rs, B4, M4, N4, D, case == "self")
                idx = neighbours(ts, K4)
                bwd = bwd_call(ts, idx, dout)
                ms, graph_ms = cs.time_cuda(bwd, iters=10), cs.time_graph(bwd, iters=10)
                fb_ms = cs.time_graph(fwd_bwd_call(ts, dout, K4), iters=10)
                plain_ms = cs.time_cuda(lambda: cs._k6b(
                    knn_attn.plain_knn_vector_attention_trainable_bwd, ts, idx, dout),
                    iters=3, warmup=1)
                flops = 2.0 * D * D * (6 * B4 * M4 * K4 + 4 * B4 * ts[2].shape[1])
                bound, by = cs.bound_ms(0.0, flops, torch.bfloat16)
                print(f"D{D} {case} bf16: K6b {ms:.3f} ms call by call, {graph_ms:.3f} from a "
                      f"graph ({100 * bound / graph_ms:.1f}% of its {bound:.4f} ms {by} bound); "
                      f"K6 fwd + bwd from a graph {fb_ms:.3f}; plain backward {plain_ms:.3f}",
                      flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        for D in (256, 1024):
            ts, dout = inputs(rs, B4, M4, N4, D, False)
            bwd = bwd_call(ts, neighbours(ts, K4), dout)
            for _ in range(3):
                bwd()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    bwd()
                torch.cuda.synchronize()
            groups = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    label = kernel_label(e.name)
                    groups[label] = groups.get(label, 0.0) + e.time_range.elapsed_us() / 5e3
            total = sum(groups.values())
            print(f"D{D} cross bf16, K6b device time a call {total:.3f} ms:")
            for label, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
                print(f"  {label}: {ms:.4f} ms ({100 * ms / total:.1f}%)")
    kernel = None  # last, so that a long run's tail keeps it
    for line in lib.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("entry function")[-1].strip()
        elif ("registers" in line or "spill" in line) and kernel and "knn_bwd" in kernel:
            print(f"ptxas {kernel[:60]}: {line.strip()}")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
