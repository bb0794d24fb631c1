"""K3 / K3b (dense cross-attention, forward and backward) alone on one CUDA card.

    env PYTHONPATH=. python3 scripts/torch_check_cross_attn.py [--quick] [--time]
        [--lse-repeat N [--out-dir DIR]]

Builds the port's kernels, prints what ``ptxas -v`` said of the dense
attention kernels (registers, spills, shared memory), then holds the
bfloat16 and float32 kernels against their plain versions on the card at the
four released head dims and at ragged shapes (M, N not multiples of any tile,
B 1): the output, the logsumexp, dQ / dK / dV from saved (out, lse), and two
backward launches bit for bit. ``--quick`` keeps to two small shapes;
``--time`` adds CUDA-event times at B4, 799 x 4096 beside
``F.scaled_dot_product_attention`` and its backward, once call by call (the
host's share of a call included) and once replayed from a CUDA graph (the
kernels alone). ``--lse-repeat N`` runs, in one process, the five float32 K3
cases of ``chip_smoke.py``'s phase 1 on its inputs (D 256, D 128 / 512 /
1024, and B 1 with 4100 keys) N times each, and holds every launch's row
logsumexp against the plain version on the CPU copies (recomputed every 10
launches), on the card (float32, TF32 off) and against a float64 logsumexp of
the same logits; a launch that misses 1e-5 against any of them keeps its
inputs and outputs under ``--out-dir`` (``tmp/k3_lse``). Exits non-zero on any
disagreement. Needs no JAX.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from poem_v2_tpu_torch.ops import _lib, cross_attn

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5


def ptxas_report() -> None:
    lines = _lib.lib().ptxas_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "dense_attn" in line:
            name = line.split("'")[1]
            used = next((l for l in lines[i + 1:i + 6] if "Used" in l), "")
            spill = next((l for l in lines[i + 1:i + 6] if "spill" in l), "")
            print(f"  {name[:70]}: {used.split(':', 1)[-1].strip()} | {spill.strip()}")
    for line in lines:
        if "warning" in line.lower() and ("wgmma" in line or "setmaxnreg" in line):
            print("  " + line.strip())


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


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


def check(B, M, N, D, dtype, heads=4, seed=0) -> bool:
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, n, D, device="cuda", generator=g).to(dtype)
                   for n in (M, N, N, M))
    scale = 1 / math.sqrt(D // heads)
    out, lse = cross_attn.dense_cross_attention_forward(q, k, v, heads, scale, return_lse=True)
    torch.cuda.synchronize()
    want = cross_attn.plain_dense_cross_attention(q, k, v, heads, scale)
    want_lse = cross_attn.plain_dense_cross_attention_lse(q, k, heads, scale)
    errs = {"out": rel_err(out, want)}
    lse_err = float((lse - want_lse).abs().max())
    grads = cross_attn.dense_cross_attention_bwd(q, k, v, do, heads, scale, out=out, lse=lse)
    again = cross_attn.dense_cross_attention_bwd(q, k, v, do, heads, scale, out=out, lse=lse)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    wants = cross_attn.plain_dense_cross_attention_bwd(q, k, v, do, heads, scale)
    for n, a, b in zip(("dq", "dk", "dv"), grads, wants):
        errs[n] = rel_err(a, b)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, lse, *grads))
    ok = finite and same and all(e <= TOL[dtype] for e in errs.values()) and lse_err <= LSE_TOL
    print(f"  B{B} M{M} N{N} D{D} {str(dtype)[6:]}: "
          + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" | lse abs {lse_err:.2e} | repeat identical {same} | {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def time_graph(fn, calls=20) -> float:
    """Milliseconds per call of ``fn`` with ``calls`` of them replayed from one
    CUDA graph: the kernels' own time, without the host's share of a call."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_cuda(graph.replay, iters=10, warmup=2) / calls


def timing(B=4, M=799, N=4096, heads=4) -> None:
    for D in (128, 256, 512, 1024):
        g = torch.Generator(device="cuda").manual_seed(D)
        q, k, v, do = (torch.randn(B, n, D, device="cuda", generator=g).bfloat16()
                       for n in (M, N, N, M))
        scale = 1 / math.sqrt(D // heads)
        fwd = time_cuda(lambda: cross_attn.dense_cross_attention_forward(q, k, v, heads, scale))
        out, lse = cross_attn.dense_cross_attention_forward(q, k, v, heads, scale,
                                                            return_lse=True)
        bwd = time_cuda(lambda: cross_attn.dense_cross_attention_bwd(
            q, k, v, do, heads, scale, out=out, lse=lse))
        hs = [t.reshape(B, t.shape[1], heads, -1).transpose(1, 2) for t in (q, k, v)]
        lib_fwd = time_cuda(lambda: F.scaled_dot_product_attention(*hs, scale=scale))
        leaves = [t.detach().requires_grad_() for t in hs]
        o = F.scaled_dot_product_attention(*leaves, scale=scale)
        doh = do.reshape(B, M, heads, -1).transpose(1, 2)
        lib_bwd = time_cuda(lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True))
        flops = 4.0 * B * M * N * D
        print(f"  D{D}: forward {fwd:.4f} ms ({flops / fwd / 1e9:.0f} TFLOP/s; library "
              f"{lib_fwd:.4f} ms), backward {bwd:.4f} ms ({2.5 * flops / bwd / 1e9:.0f} TFLOP/s; "
              f"library {lib_bwd:.4f} ms)", flush=True)
        g_fwd = time_graph(lambda: cross_attn.dense_cross_attention_forward(q, k, v, heads, scale))
        g_bwd = time_graph(lambda: cross_attn.dense_cross_attention_bwd(
            q, k, v, do, heads, scale, out=out, lse=lse))
        g_lib = time_graph(lambda: F.scaled_dot_product_attention(*hs, scale=scale))
        # (the library's backward runs on autograd's own thread and is not captured)
        print(f"        replayed from a CUDA graph: forward {g_fwd:.4f} ms "
              f"({flops / g_fwd / 1e9:.0f} TFLOP/s; library {g_lib:.4f} ms), backward "
              f"{g_bwd:.4f} ms ({2.5 * flops / g_bwd / 1e9:.0f} TFLOP/s)", flush=True)


def lse_repeat(repeat: int, out_dir: str) -> bool:
    """The float32 logsumexp of phase 1's K3 cases, ``repeat`` launches each."""
    import os

    import numpy as np

    from chip_smoke import kernel_cases

    cases = {n: c for n, c in kernel_cases(np.random.RandomState(0)).items() if c.get("lse")}
    ok, saved = True, 0
    for name, c in cases.items():
        q, k = c["args"][:2]
        kw = c["kw"]
        dev = [t.cuda() for t in c["args"]]
        qh = q.double().reshape(q.shape[0], q.shape[1], kw["num_heads"], -1).transpose(1, 2)
        kh = k.double().reshape(k.shape[0], k.shape[1], kw["num_heads"], -1).transpose(1, 2)
        ref64 = torch.logsumexp((qh @ kh.transpose(-1, -2)) * kw["sm_scale"], dim=-1)
        card = cross_attn.plain_dense_cross_attention_lse(*dev[:2], **kw).cpu()
        worst = dict(cpu=0.0, card=0.0, f64=0.0)
        plain_cpu, cpu_vs_f64, bits = None, 0.0, set()
        for i in range(repeat):
            if i % 10 == 0:
                plain_cpu = cross_attn.plain_dense_cross_attention_lse(q, k, **kw)
                cpu_vs_f64 = max(cpu_vs_f64, float((plain_cpu.double() - ref64).abs().max()))
            _, lse = cross_attn.dense_cross_attention_forward(*dev, **kw, return_lse=True)
            lse = lse.cpu()
            bits.add(hash(lse.numpy().tobytes()))
            errs = dict(cpu=float((lse - plain_cpu).abs().max()),
                        card=float((lse - card).abs().max()),
                        f64=float((lse.double() - ref64).abs().max()))
            for key, e in errs.items():
                worst[key] = max(worst[key], e)
            if max(errs.values()) > LSE_TOL:
                ok = False
                if saved < 3:
                    os.makedirs(out_dir, exist_ok=True)
                    path = os.path.join(out_dir, f"k3_lse_miss_{saved}.pt")
                    torch.save(dict(case=name, launch=i, args=c["args"], kw=kw, lse=lse,
                                    plain_cpu=plain_cpu, plain_card=card, ref64=ref64), path)
                    saved += 1
                print(f"  {name} launch {i}: lse against CPU {errs['cpu']:.3e}, card "
                      f"{errs['card']:.3e}, float64 {errs['f64']:.3e}: MISS", flush=True)
        print(f"  {name} [float32] {repeat} launches, {len(bits)} distinct outputs: worst lse "
              f"against the CPU's plain {worst['cpu']:.3e}, the card's plain {worst['card']:.3e}, "
              f"float64 {worst['f64']:.3e}; the card's plain against float64 "
              f"{float((card.double() - ref64).abs().max()):.3e}, the CPU's {cpu_vs_f64:.3e}",
              flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--lse-repeat", type=int, default=0)
    ap.add_argument("--out-dir", default="tmp/k3_lse")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    _lib.lib()
    if args.lse_repeat:
        torch.backends.cuda.matmul.allow_tf32 = False
        ok = lse_repeat(args.lse_repeat, args.out_dir)
        print("all ok" if ok else "FAILED")
        return 0 if ok else 1
    print("ptxas:")
    ptxas_report()
    if args.quick:
        shapes = [(1, 100, 300, 256), (2, 128, 256, 128)]
    else:
        shapes = [(4, 799, 4096, D) for D in (128, 256, 512, 1024)]
        shapes += [(1, 799, 4100, 256), (2, 65, 100, 512), (1, 1, 64, 1024), (3, 63, 4100, 128)]
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for B, M, N, D in shapes:
            ok &= check(B, M, N, D, dtype)
    if args.time:
        print("times at B4, 799 x 4096, bfloat16:")
        timing()
    print("all ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
