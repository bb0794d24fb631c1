"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``poem_v2_tpu_torch/csrc`` (nvcc,
sm_90a) and runs three phases; any failure raises and the exit code is
non-zero:

1. kernels: each kernel (K1-K4) against its plain PyTorch version on CPU
   copies of the same inputs, at the serving path's shapes, in float32 and
   bfloat16, with both versions timed on the card (CUDA events);
2. serving: the POEM-medium model (HRNet-W40, 8 views, 4096 BPS points,
   799 queries, 3 decoder blocks, width 256) behind the port's Predictor in
   bfloat16 answers 8-view requests at batch 1, 4 and 16; outputs are
   checked for shape and finiteness and the kernels' launch counts per
   forward are checked;
3. parity: the same model in float32 at batch 1, on the card (kernels) and
   on the CPU (plain versions), same weights and inputs, TF32 off.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Needs no network and no
JAX; without a CUDA device it fails before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from poem_v2_tpu_torch.ops import _lib, bilinear, cross_attn, knn_attn

KERNELS = {
    "fused_knn_vector_attention": dict(
        source="poem_v2_tpu_torch/csrc/knn_attn.cu",
        replaces="poem_v2_tpu/ops/pallas_knn_attn.py:810",
        wrapper=knn_attn.fused_knn_vector_attention),
    "fused_anchor_vector_attention": dict(
        source="poem_v2_tpu_torch/csrc/knn_attn.cu",
        replaces="poem_v2_tpu/ops/pallas_knn_attn.py:748",
        wrapper=knn_attn.fused_anchor_vector_attention),
    "dense_cross_attention": dict(
        source="poem_v2_tpu_torch/csrc/cross_attn.cu",
        replaces="poem_v2_tpu/ops/pallas_cross_attn.py:226",
        wrapper=cross_attn.dense_cross_attention),
    "grid_sample_points_fused": dict(
        source="poem_v2_tpu_torch/csrc/bilinear.cu",
        replaces="poem_v2_tpu/ops/pallas_bilinear.py:94",
        wrapper=bilinear.grid_sample_points),
}
# launches per serving forward of the medium model with 8 valid views
LAUNCHES_PER_FORWARD = {
    "dense_cross_attention": 6, "fused_anchor_vector_attention": 2,
    "fused_knn_vector_attention": 4, "grid_sample_points_fused": 1,
}
# argument positions that stay float32 (xyz, anchor xyz, sample coords)
KEEP_F32 = {
    "fused_knn_vector_attention": (1, 2), "fused_anchor_vector_attention": (1, 4),
    "dense_cross_attention": (), "grid_sample_points_fused": (1,),
}
# kernel vs plain version, relative to max|plain| of each output: float32
# differs only by summation order; bfloat16 by the order in which
# intermediates that are rounded to bfloat16 (x, h, t1 and the output) were
# summed, about one bfloat16 ulp (2**-8 relative) at the output's peak
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _to(x, device, dtype=None):
    if isinstance(x, (list, tuple)):
        return type(x)(_to(t, device, dtype) for t in x)
    t = x.to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def compare(name, got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = TOL[dtype] * scale
    ok = err <= tol
    log(f"  {name} [{str(dtype).split('.')[-1]}] max_abs_err={err:.3e} "
        f"(tol {tol:.3e}, max|plain|={scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def kernel_cases(rs: np.random.RandomState):
    """Inputs at the shapes phase 2's batch-4 requests give each kernel."""
    B, M, D, K, A, N = 4, 799, 256, 32, 32, 4096
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))

    def mlp_w(d_in):
        return (f(d_in, D) / math.sqrt(d_in), f(D) * 0.1, f(D, D) / math.sqrt(D), f(D) * 0.1)

    def ball(n):
        x = rs.randn(n, 3)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy((x * rs.rand(n, 1) ** (1 / 3)).astype(np.float32))

    q = f(B, M, D)
    qxyz = (f(B, M, 3) * 0.4)
    cloud = ball(N)[None].expand(B, N, 3).contiguous()
    wk, wv = f(D, D) / 16, f(D, D) / 16
    fcd, fcg = mlp_w(3), mlp_w(D)
    cases = {
        "fused_knn_vector_attention/self": (
            "fused_knn_vector_attention",
            (q, qxyz, qxyz, f(B, M, D), wk, wv, fcd, fcg),
            dict(n_neighbor=K, return_idx=True), knn_attn.plain_fused_knn_vector_attention),
        "fused_knn_vector_attention/cross": (
            "fused_knn_vector_attention",
            (q, qxyz, cloud, f(B, N, D), wk, wv, fcd, fcg),
            dict(n_neighbor=K, return_idx=True), knn_attn.plain_fused_knn_vector_attention),
        "fused_anchor_vector_attention": (
            "fused_anchor_vector_attention",
            (q, qxyz, f(B, A, D), f(B, A, D), ball(A), fcd, fcg),
            {}, knn_attn.plain_fused_anchor_vector_attention),
        "dense_cross_attention": (
            "dense_cross_attention",
            (q, f(B, N, D), f(B, N, D)),
            dict(num_heads=4, sm_scale=1 / 8), cross_attn.plain_dense_cross_attention),
        "grid_sample_points_fused": (
            "grid_sample_points_fused",
            (f(B * 8, 16, 16, D), torch.from_numpy(rs.uniform(-1.2, 1.2, (B * 8, N, 2))
                                                  .astype(np.float32))),
            {}, bilinear.plain_grid_sample_points),
    }
    return cases


def phase_kernels(results):
    log("phase 1: kernels vs plain versions")
    rs = np.random.RandomState(0)
    for case, (kname, args, kw, plain) in kernel_cases(rs).items():
        for dtype in (torch.float32, torch.bfloat16):
            # geometry (xyz, coords) stays float32; features and weights take dtype
            def cast(t, i):
                return _to(t, "cpu", None if i in KEEP_F32[kname] else dtype)
            cpu_args = tuple(cast(t, i) for i, t in enumerate(args))
            dev_args = _to(cpu_args, "cuda")
            wrapper = KERNELS[kname]["wrapper"]
            got = wrapper(*dev_args, **kw)
            torch.cuda.synchronize()
            want = plain(*cpu_args, **kw)
            if kw.get("return_idx"):
                (got, gidx), (want, widx) = got, want
                same = torch.equal(gidx.cpu(), widx)
                log(f"  {case} [{str(dtype).split('.')[-1]}] indices identical: {same}")
                if not same:
                    n_diff = int((gidx.cpu() != widx).sum())
                    raise AssertionError(f"{case}: {n_diff} neighbour indices differ")
            err = compare(case, got, want, dtype)
            ms = time_cuda(lambda: wrapper(*dev_args, **kw))
            plain_ms = time_cuda(lambda: plain(*dev_args, **kw), iters=3, warmup=1)
            log(f"  {case} [{str(dtype).split('.')[-1]}] kernel {ms:.3f} ms, "
                f"plain on card {plain_ms:.3f} ms")
            results.setdefault(case, {})[str(dtype).split(".")[-1]] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    lib = _lib.lib()
    log(f"built {lib.path} in {time.time() - t0:.1f} s")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    results = {}
    phase_kernels(results)
    launches = phase_serving(results)
    phase_parity(results)

    # one entry per kernel; K1's ms / plain_ms add its self and cross calls,
    # the pair a decoder block makes
    entries = []
    for kname, meta in KERNELS.items():
        rows = [r for case, r in results.items() if case.split("/")[0] == kname]
        bf = [r["bfloat16"] for r in rows]
        entries.append(dict(
            name=kname, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in bf),
            max_abs_err_f32=max(r["float32"]["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in bf),
            plain_ms=sum(r["plain_ms"] for r in bf),
        ))
    log(gpu_line())
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def look_at_request(rs: np.random.RandomState, B: int, V: int, size: int = 256):
    """B requests of V uint8 views from cameras 0.4-0.6 m around a hand-sized
    target in front of view 0 (whose frame is the master frame)."""
    images = rs.randint(0, 256, (B, V, size, size, 3)).astype(np.uint8)
    intr = np.zeros((B, V, 3, 3), np.float32)
    extr = np.zeros((B, V, 4, 4), np.float32)
    for b in range(B):
        target = np.array([0.0, 0.0, 0.5]) + rs.uniform(-0.03, 0.03, 3)
        for v in range(V):
            if v == 0:
                centre = np.zeros(3)
            else:
                d = rs.randn(3)
                d[2] = -abs(d[2])
                centre = target + rs.uniform(0.4, 0.6) * d / np.linalg.norm(d)
            z = (target - centre) / np.linalg.norm(target - centre)
            x = np.cross([0.0, 1.0, 0.0], z)
            x /= np.linalg.norm(x)
            extr[b, v, :3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
            extr[b, v, :3, 3] = centre
            extr[b, v, 3, 3] = 1.0
            f = size * rs.uniform(1.2, 1.6)
            intr[b, v] = [[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]]
    return images, intr, extr


def reset_launches():
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0


def read_launches():
    return {k: meta["wrapper"].launches for k, meta in KERNELS.items()}


def phase_serving(results):
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.serving.predictor import Predictor

    log("phase 2: serving POEM-medium (bf16, 8 views) behind Predictor")
    t0 = time.time()
    pred = Predictor.from_config(MEDIUM, dtype=torch.bfloat16, device="cuda", seed=0)
    n_params = sum(p.numel() for p in pred.model.parameters())
    log(f"  model built in {time.time() - t0:.1f} s, {n_params / 1e6:.2f} M parameters")
    rs = np.random.RandomState(1)
    requests = {bs: look_at_request(rs, bs, 8) for bs in (1, 4, 16)}
    for bs, req in requests.items():  # first call per bucket: cuDNN autotuning, allocator
        pred(*req)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    n_forwards = 0
    for bs, req in requests.items():
        times = []
        for _ in range(3):
            before = read_launches()
            t = time.perf_counter()
            out = pred(*req)   # returns host arrays: the call ends synchronised
            times.append((time.perf_counter() - t) * 1e3)
            n_forwards += 1
            after = read_launches()
            per_call = {k: after[k] - before[k] for k in after}
            if per_call != LAUNCHES_PER_FORWARD:
                raise AssertionError(f"launches per forward {per_call} != {LAUNCHES_PER_FORWARD}")
            for key, shape in (("joints_3d", (bs, 21, 3)), ("verts_3d", (bs, 778, 3)),
                               ("joints_uv", (bs, 8, 21, 2))):
                if out[key].shape != shape or not np.isfinite(out[key]).all():
                    raise AssertionError(f"B{bs} {key}: shape {out[key].shape}, "
                                         f"finite {np.isfinite(out[key]).all()}")
        med = float(np.median(times))
        spread = np.linalg.norm(out["verts_3d"] - out["joints_3d"][:, 9:10], axis=-1).max()
        log(f"  B{bs}: request latency median {med:.2f} ms over 3 ({', '.join(f'{t:.2f}' for t in times)}), "
            f"{med / bs:.2f} ms/sample, {bs * 1e3 / med:.1f} 8-view samples/s; "
            f"max |vert - joint 9| {spread:.3f} m")
        results.setdefault("serving", {})[f"B{bs}"] = dict(median_ms=med, runs_ms=times)
    launches = read_launches()
    want = {k: v * n_forwards for k, v in LAUNCHES_PER_FORWARD.items()}
    log(f"  launches over {n_forwards} forwards: {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_parity(results):
    """Medium model in float32 at B=1: kernels on the card vs plain versions on the CPU."""
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.models.poem import create_poem_model

    log("phase 3: whole forward, card (kernels) vs CPU (plain versions), float32, TF32 off")
    model, _ = create_poem_model(MEDIUM["MODEL"], generator=torch.Generator().manual_seed(0))
    images, intr, extr = look_at_request(np.random.RandomState(2), 1, 8)
    img = torch.from_numpy(images).float() / 255.0 - 0.5
    args = (img, torch.ones(1, 8, dtype=torch.bool), torch.from_numpy(intr),
            torch.from_numpy(extr))
    with torch.inference_mode():
        t = time.time()
        want = model(*args)
        cpu_s = time.time() - t
        gpu_model = model.to("cuda")
        got = gpu_model(*(a.to("cuda") for a in args))
        torch.cuda.synchronize()
    diffs = {}
    for key in ("pred_joints_uv", "pred_ref_joints_3d", "pred_joints_3d", "pred_verts_3d"):
        g, w = got[key].cpu(), want[key]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{key}: non-finite on the card")
        diffs[key] = float((g - w).abs().max())
    log(f"  max |card - cpu|: " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f" (cpu forward {cpu_s:.1f} s)")
    # float32 throughout; sums run in other orders on the two devices. 1e-4 m
    # (0.1 mm) is far below a hand's scale and above float32 noise through the
    # network; 1e-2 px for the integral 2D joints on 256 px crops
    tol = {"pred_joints_uv": 1e-2, "pred_ref_joints_3d": 1e-4, "pred_joints_3d": 1e-4,
           "pred_verts_3d": 1e-4}
    for key, d in diffs.items():
        if d > tol[key]:
            raise AssertionError(f"{key}: card vs cpu {d} > {tol[key]}")
    results["parity"] = diffs


if __name__ == "__main__":
    sys.exit(main())
