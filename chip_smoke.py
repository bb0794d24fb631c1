"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``poem_v2_tpu_torch/csrc`` (nvcc,
sm_90a) and runs four phases; any failure raises and the exit code is
non-zero:

1. kernels: each kernel against its plain PyTorch version on CPU copies of
   the same inputs, in float32 and bfloat16, with both versions timed on
   the card (CUDA events): K1-K4 at the serving path's batch-4 shapes, then
   the training kernels at the same shapes: K3b (dQ, dK, dV), K6 (value,
   and in float32 all 14 input gradients) and K7 (n_rows 799 and 4096, heavily
   duplicated indices, two launches bit-identical);
2. serving: the POEM-medium model (HRNet-W40, 8 views, 4096 BPS points,
   799 queries, 3 decoder blocks, width 256) behind the port's Predictor in
   bfloat16 answers 8-view requests at batch 1, 4 and 16; outputs are
   checked for shape and finiteness and the kernels' launch counts per
   forward are checked;
3. parity: the same model in float32 at batch 1, on the card (kernels) and
   on the CPU (plain versions), same weights and inputs, TF32 off;
4. train: (a) the medium model with float32 parameters, bfloat16 compute
   and remat takes 2 warm-up and 8 timed steps of the port's Trainer on a
   fixed synthetic batch of 8 samples with 1-8 of 8 views; loss and grad
   norm are finite, the loss falls, and the kernels' launches per step are
   checked; (b) one float32 step at batch 1, card (kernels) against CPU
   (plain versions), same weights, batch and jitter draws, dropout 0:
   loss terms, every gradient per module, and the parameters after the
   update.

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

from poem_v2_tpu_torch.ops import _lib, bilinear, cross_attn, knn_attn, scatter

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
    "dense_cross_attention_bwd": dict(
        source="poem_v2_tpu_torch/csrc/cross_attn.cu",
        replaces="poem_v2_tpu/ops/pallas_cross_attn.py:183",
        wrapper=cross_attn.dense_cross_attention_bwd),
    "knn_vector_attention_trainable": dict(
        source="poem_v2_tpu_torch/csrc/knn_attn.cu",
        replaces="poem_v2_tpu/ops/pallas_knn_attn.py:945",
        wrapper=knn_attn.knn_vector_attention_trainable),
    "scatter_add_rows": dict(
        source="poem_v2_tpu_torch/csrc/scatter.cu",
        replaces="poem_v2_tpu/ops/pallas_scatter.py:57",
        wrapper=scatter.scatter_add_rows),
}
# launches per serving forward of the medium model with 8 valid views
LAUNCHES_PER_FORWARD = {
    "dense_cross_attention": 6, "fused_anchor_vector_attention": 2,
    "fused_knn_vector_attention": 4, "grid_sample_points_fused": 1,
    "dense_cross_attention_bwd": 0, "knn_vector_attention_trainable": 0, "scatter_add_rows": 0,
}
# launches per train step of the medium model (3 blocks): two attentions per
# block, forward and backward; K6 (whose forward runs K1) in the self and
# cross attention of blocks 1 and 2, each backward scattering by K7. The
# remat recompute replays no kernel. Block 0's anchors and the sampler take
# plain paths in training, so K2 and K4 do not run.
LAUNCHES_PER_TRAIN_STEP = {
    "dense_cross_attention": 6, "dense_cross_attention_bwd": 6,
    "fused_knn_vector_attention": 4, "knn_vector_attention_trainable": 4,
    "scatter_add_rows": 4, "fused_anchor_vector_attention": 0, "grid_sample_points_fused": 0,
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


def compare(name, got, want, dtype, scale=None, tol_rel=None):
    """Max abs error of ``got`` against ``want``, held to ``tol_rel`` (TOL[dtype])
    times ``scale`` (max|want|)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max()) if scale is None else scale
    tol = (TOL[dtype] if tol_rel is None else tol_rel) * scale
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


# K6's gradients are held in float32 only. Its backward reruns the same
# PyTorch recompute on both sides; the hand-written parts are K1's indices
# (held identical to the plain ones by the forward) and K7's scatter. In
# bfloat16 a limit wide enough for the recompute's rounding (the gradient
# of q reaches 5e-2 of its peak) would let a K7 error of 10% through, so
# bfloat16 checks the value alone, and K7 is held on its own below
K6_GRAD_TOL = 1e-4
# K7 sums the same float32 (or exactly upcast bfloat16) values in float32 on
# both sides: only the summation order can differ
K7_TOL = 1e-5


def _dt(dtype):
    return str(dtype).split(".")[-1]


def phase_train_kernels(results):
    """K3b, K6 and K7 against their plain versions at batch-4 shapes."""
    log("phase 1b: training kernels vs plain versions")
    rs = np.random.RandomState(1)
    B, M, D, K, N = 4, 799, 256, 32, 4096
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))

    # K3b: dQ, dK, dV of the dense attention
    qkvd = (f(B, M, D), f(B, N, D), f(B, N, D), f(B, M, D))
    for dtype in (torch.float32, torch.bfloat16):
        cpu = [t.to(dtype) for t in qkvd]
        dev = [t.to("cuda") for t in cpu]
        got = cross_attn.dense_cross_attention_bwd(*dev, 4, 1 / 8)
        torch.cuda.synchronize()
        want = cross_attn.plain_dense_cross_attention_bwd(*cpu, 4, 1 / 8)
        err = max(compare(f"dense_cross_attention_bwd d{n}", g, w, dtype)
                  for n, g, w in zip("qkv", got, want))
        ms = time_cuda(lambda: cross_attn.dense_cross_attention_bwd(*dev, 4, 1 / 8))
        plain_ms = time_cuda(lambda: cross_attn.plain_dense_cross_attention_bwd(*dev, 4, 1 / 8),
                             iters=3, warmup=1)
        log(f"  dense_cross_attention_bwd [{_dt(dtype)}] kernel {ms:.3f} ms, "
            f"plain (autograd) on card {plain_ms:.3f} ms")
        results.setdefault("dense_cross_attention_bwd", {})[_dt(dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # K6: value and the gradients of its 14 inputs, self (799 points) and cross (4096)
    def ball(n):
        x = rs.randn(n, 3)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy((x * rs.rand(n, 1) ** (1 / 3)).astype(np.float32))

    q, qxyz, ct = f(B, M, D), f(B, M, 3) * 0.4, f(B, M, D)
    mlps = [f(3, D), f(D) * 0.1, f(D, D) / 16, f(D) * 0.1, f(D, D) / 16, f(D) * 0.1,
            f(D, D) / 16, f(D) * 0.1]
    clouds = {"self": (qxyz, f(B, M, D)),
              "cross": (ball(N)[None].expand(B, N, 3).contiguous(), f(B, N, D))}

    def k6(fn, ts):
        ts = [t.detach().requires_grad_() for t in ts]
        out = fn(*ts[:6], ts[6:10], ts[10:], n_neighbor=K)
        return out, torch.autograd.grad(out, ts, ct.to(out.device, out.dtype))

    for case, (pxyz, xf) in clouds.items():
        for dtype in (torch.float32, torch.bfloat16):
            cpu = [q.to(dtype), qxyz, pxyz, xf.to(dtype), f(D, D) / 16, f(D, D) / 16, *mlps]
            dev = [t.to("cuda") for t in cpu]
            got, g_got = k6(knn_attn.knn_vector_attention_trainable, dev)
            torch.cuda.synchronize()
            want, g_want = k6(knn_attn.knn_vector_attention_trainable, cpu)
            name = f"knn_vector_attention_trainable/{case}"
            err = compare(name, got, want, dtype)
            # fc_gamma's output bias (input 13) shifts every neighbour of a
            # channel alike: its exact gradient is 0, so it is held to the
            # scale of g1's gradient (input 12)
            g_err = None if dtype != torch.float32 else max(
                compare(f"{name} grad {i}", g, w, dtype,
                        scale=float(g_want[12 if i == 13 else i].float().abs().max()),
                        tol_rel=K6_GRAD_TOL)
                for i, (g, w) in enumerate(zip(g_got, g_want)))
            ms = time_cuda(lambda: k6(knn_attn.knn_vector_attention_trainable, dev))
            plain_ms = time_cuda(lambda: k6(knn_attn.plain_fused_knn_vector_attention, dev),
                                 iters=3, warmup=1)
            log(f"  {name} [{_dt(dtype)}] forward + backward {ms:.3f} ms, "
                f"plain (autograd) on card {plain_ms:.3f} ms")
            results.setdefault(name, {})[_dt(dtype)] = dict(
                max_abs_err=err, max_abs_err_grads=g_err, ms=ms, plain_ms=plain_ms)

    # K7: self (799 rows, ~32 entries each) and cross (4096 rows, entries only
    # on every 16th row: ~100 each); a second launch must give the same bits
    g = f(B, M, K, D)
    for case, n_rows, step in (("self", 799, 1), ("cross", 4096, 16)):
        idx = torch.from_numpy((rs.randint(0, n_rows // step, (B, M, K)) * step)
                               .astype(np.int32))
        for dtype in (torch.float32, torch.bfloat16):
            gc = g.to(dtype)
            gd, idd = gc.to("cuda"), idx.to("cuda")
            got = scatter.scatter_add_rows(gd, idd, n_rows)
            again = scatter.scatter_add_rows(gd, idd, n_rows)
            torch.cuda.synchronize()
            name = f"scatter_add_rows/{case}"
            same = torch.equal(got, again)
            log(f"  {name} [{_dt(dtype)}] two launches bit-identical: {same}")
            if not same:
                raise AssertionError(f"{name}: two launches differ")
            err = compare(name, got, scatter.plain_scatter_add_rows(gc, idx, n_rows), dtype,
                          tol_rel=K7_TOL)
            ms = time_cuda(lambda: scatter.scatter_add_rows(gd, idd, n_rows))
            plain_ms = time_cuda(lambda: scatter.plain_scatter_add_rows(gd, idd, n_rows))
            log(f"  {name} [{_dt(dtype)}] kernel {ms:.3f} ms, plain (index_add_) on card "
                f"{plain_ms:.3f} ms")
            results.setdefault(name, {})[_dt(dtype)] = dict(max_abs_err=err, ms=ms,
                                                            plain_ms=plain_ms)


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
    phase_train_kernels(results)
    launches = phase_serving(results)
    phase_parity(results)
    train_launches = phase_train(results)
    phase_train_parity(results)

    # one entry per kernel; the ms / plain_ms of K1, K6 and K7 add their self
    # and cross calls, the pair a decoder block makes. ``launches`` is the
    # count of the path the kernel serves (serving for K1-K4, the train steps
    # for K3b, K6 and K7); ``train_launches`` the count over the train steps
    entries = []
    for kname, meta in KERNELS.items():
        rows = [r for case, r in results.items() if case.split("/")[0] == kname]
        bf = [r["bfloat16"] for r in rows]
        path = launches if LAUNCHES_PER_FORWARD[kname] else train_launches
        entries.append(dict(
            name=kname, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=path[kname], train_launches=train_launches[kname],
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


# phase 4b: per-module bound on max |card - cpu| / max |cpu| of the gradients
GRAD_BOUND = {"backbone": 3e-2, "feat_neck": 2e-3, "uv_neck": 2e-3, "head": 5e-4, "block": 1e-5}
# ... and on |u_card - u_cpu|_2 / |u_cpu|_2 of each module's parameter
# change u in the Adam step. Elements whose gradient is noise on both sides
# may move +-lr either way, so it grows with a module's share of such
# elements; an update that is missing, halved, doubled or of the wrong sign
# reads 0.5 or more
UPDATE_BOUND = 0.3


def _module_group(name: str) -> str:
    """backbone, feat_neck, uv_neck, head (outside the decoder), head.transformer.block_i."""
    parts = name.split(".")
    return ".".join(parts[:3]) if parts[:2] == ["head", "transformer"] else parts[0]


def phase_train(results):
    """Phase 4a: the medium train step at B8 through the port's Trainer."""
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu_torch.models.poem import create_poem_model, draw_ref_noise
    from poem_v2_tpu_torch.training.trainer import Trainer

    log("phase 4a: train POEM-medium (f32 params, bf16 compute, remat) at B8, up to 8 views")
    t0 = time.time()
    model, aux = create_poem_model(MEDIUM["MODEL"], dtype=torch.bfloat16,
                                   param_dtype=torch.float32, device="cuda",
                                   generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, aux, MEDIUM["TRAIN"], MEDIUM["MODEL"]["LOSS"])
    ds = SyntheticMultiviewDataset(batch_size=8, view_max=8, view_range=(1, 8), image_size=256,
                                   seed=3)
    batch = trainer.to_device(ds.sample_batch())
    n_views = batch["view_mask"].sum(1).tolist()
    log(f"  model built in {time.time() - t0:.1f} s; views per sample {n_views}")
    warmup, timed = 2, 8
    metrics, events = [], []
    reset_launches()
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = read_launches()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics.append(trainer.step(batch))
        end.record()
        events.append((start, end))
        after = read_launches()
        per_step = {k: after[k] - before[k] for k in after}
        if per_step != LAUNCHES_PER_TRAIN_STEP:
            raise AssertionError(f"launches per train step {per_step} != {LAUNCHES_PER_TRAIN_STEP}")
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    times = [s.elapsed_time(e) for s, e in events]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {len(losses)} steps: {losses}")
    med = float(np.median(times[warmup:]))
    log(f"  step ms (CUDA events around the whole step): warm-up "
        f"{', '.join(f'{t:.1f}' for t in times[:warmup])}; timed "
        f"{', '.join(f'{t:.1f}' for t in times[warmup:])}")
    log(f"  median step {med:.2f} ms, {8e3 / med:.2f} samples/s, peak device memory "
        f"{peak:.2f} GiB")
    log(f"  loss {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"  grad norm {', '.join(f'{x:.3f}' for x in norms)}")
    log(f"  launches over {warmup + timed} steps: {launches}")

    # one more step, split by CUDA events: forward + loss, backward, clip + Adam
    opt = trainer.optimizer
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.train()
    opt.zero_grad()
    draws = draw_ref_noise(trainer.generator, 8)
    marks[0].record()
    preds = model(batch["image"], batch["view_mask"], batch["cam_intr"], batch["cam_extr"],
                  batch["master_joints_3d"], ref_draws=draws)
    loss, _ = trainer.loss_fn(preds, batch)
    marks[1].record()
    loss.backward()
    marks[2].record()
    opt.step()
    marks[3].record()
    torch.cuda.synchronize()
    split = {k: marks[i].elapsed_time(marks[i + 1])
             for i, k in enumerate(("forward_loss", "backward", "optimizer"))}
    log("  split of one step: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()))
    profile = profile_train_step(trainer, batch, med)
    results["train"] = dict(median_ms=med, runs_ms=times, samples_per_s=8e3 / med,
                            peak_gib=peak, losses=losses, split_ms=split, profile=profile)
    return launches


# device kernels by name: the port's kernels, and the largest other groups
PROFILE_GROUPS = (
    ("K3 dense_attn_*kernel", ("dense_attn_kernel", "dense_attn_tc_kernel")),
    ("K3b dense_attn_bwd_*", "dense_attn_bwd_"),
    ("K1 (K6 fwd) knn_select + vector_attn", ("knn_select_kernel", "vector_attn_kernel")),
    ("K7 scatter_*", "scatter_"),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "Conv", "implicit")),
    ("gemm (cuBLAS / cuDNN)", ("gemm", "Gemm", "sm90_xmma", "cutlass")),
    ("group norm", ("group_norm", "GroupNorm", "groupnorm")),
    ("layout (NCHW <-> NHWC)", ("nchwToNhwc", "nhwcToNchw")),
    ("copies and sets", ("Memcpy", "Memset")),
)


def profile_train_step(trainer, batch, step_ms):
    """One more train step under torch.profiler: device time by kernel group,
    and the device's idle share against ``step_ms``, the unprofiled median
    step (the profiler slows the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = {}  # device-side events only (kernels, copies, sets), ms by name
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.name] = dev.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(dev.values())
    if total <= 0:
        log("  profiler: no device time recorded; breakdown not measured")
        return None
    groups, left = {}, dict(dev)
    for label, keys in PROFILE_GROUPS:
        keys = (keys,) if isinstance(keys, str) else keys
        hit = [k for k in left if any(s in k for s in keys)]
        groups[label] = sum(left.pop(k) for k in hit)
    groups["other"] = sum(left.values())
    idle = 100 * (1 - total / step_ms)
    log(f"  profiled step: wall {wall_ms:.1f} ms (profiler on), device busy {total:.1f} ms, "
        f"idle {idle:.1f}% of the {step_ms:.1f} ms median step")
    for label, ms in groups.items():
        log(f"    {label}: {ms:.1f} ms ({100 * ms / total:.1f}%)")
    top = sorted(left.items(), key=lambda kv: -kv[1])[:6]
    log("    largest other kernels: " + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top))
    return dict(wall_ms=wall_ms, device_ms=total, idle_pct=idle, groups=groups)


def phase_train_parity(results):
    """Phase 4b: one float32 train step at B1, card (kernels) vs CPU (plain versions)."""
    import copy

    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu_torch.models.poem import create_poem_model, draw_ref_noise
    from poem_v2_tpu_torch.training.trainer import Trainer, make_train_step

    log("phase 4b: one train step, card (kernels) vs CPU (plain versions), float32, TF32 off, "
        "dropout 0")
    model, aux = create_poem_model(MEDIUM["MODEL"], generator=torch.Generator().manual_seed(1))
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    models = {"cpu": model, "cuda": copy.deepcopy(model).to("cuda")}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    raw = SyntheticMultiviewDataset(batch_size=1, view_max=4, view_range=(2, 4), image_size=256,
                                    seed=5).sample_batch()
    draws = draw_ref_noise(torch.Generator().manual_seed(7), 1)
    out = {}
    for dev, mdl in models.items():
        trainer = Trainer(mdl, aux, MEDIUM["TRAIN"], MEDIUM["MODEL"]["LOSS"])
        grads = {}
        hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().cpu().clone()))
                 for n, p in mdl.named_parameters()]
        t = time.time()
        metrics = make_train_step(mdl, trainer.loss_fn, trainer.optimizer)(
            trainer.to_device(raw), draws)
        metrics = {k: float(v) for k, v in metrics.items()}
        secs = time.time() - t
        for h in hooks:
            h.remove()
        out[dev] = dict(metrics=metrics, grads=grads, secs=secs,
                        params={n: p.detach().cpu() for n, p in mdl.named_parameters()})
    cpu, card = out["cpu"], out["cuda"]
    log(f"  {int(raw['view_mask'].sum())} of 4 views; step on the CPU {cpu['secs']:.1f} s, "
        f"on the card {card['secs']:.2f} s (first call)")
    # float32 on both sides, summed in other orders (cuDNN, cuBLAS and the
    # kernels against the CPU's): loss terms to 1e-4 relative
    loss_err = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-12)
                for k, v in cpu["metrics"].items()}
    log("  loss terms, |card - cpu| / |cpu|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in loss_err.items()))
    bad = {k: v for k, v in loss_err.items() if v > 1e-4}
    if bad:
        raise AssertionError(f"loss terms differ: {bad}")
    # every parameter with a nonzero CPU gradient has one on the card
    missing = [n for n, g in cpu["grads"].items()
               if bool(g.abs().max() > 0) and (n not in card["grads"]
                                               or not bool(card["grads"][n].abs().max() > 0))]
    if missing:
        raise AssertionError(f"{len(missing)} parameters got no gradient on the card: "
                             f"{missing[:10]}")
    extra = sorted(set(card["grads"]) - set(cpu["grads"]))
    if extra:
        raise AssertionError(f"gradients on the card only: {extra[:10]}")
    # gradients per module: max |card - cpu| <= bound x the module's max |cpu|.
    # Both sides are float32 with other summation orders. The HRNet-W40
    # backward at 256 px is ill-conditioned in float32 with these random
    # weights: on this card its gradients sit up to 1.2e-2 of the backbone's
    # largest from a float64 run (tests/test_torch_cuda.py::
    # test_hrnet_float32_backward_conditioning), so the backbone and the
    # necks it feeds get looser bounds than the head and the decoder blocks
    groups = {}
    for n, g in cpu["grads"].items():
        err, scale = groups.get(_module_group(n), (0.0, 0.0))
        groups[_module_group(n)] = (max(err, float((card["grads"][n] - g).abs().max())),
                                    max(scale, float(g.abs().max())))
    rel = {k: e / s for k, (e, s) in groups.items()}
    log(f"  {len(cpu['grads'])} parameters with gradients on both; max |dgrad| / max |grad| "
        "per module: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    bad = {k: v for k, v in rel.items() if not v <= GRAD_BOUND.get(k, GRAD_BOUND["block"])}
    if bad:
        raise AssertionError(f"gradients differ: {bad}")
    # after clip + Adam: Adam's first update is -lr g / (|g| + 1e-8). Where the
    # CPU gradient is 100x the largest gradient disagreement of its tensor and
    # above 1e-4 (so 1e4 x Adam's eps), that is -lr sign(g) to 1e-4 on both
    # sides: such "firm" elements agree to 1e-3 of lr plus 2 float32 ulps of
    # the parameter (p - update rounds once on each side). Per module, the
    # change of the parameters is held to UPDATE_BOUND.
    lr = MEDIUM["TRAIN"]["LR"]
    worst_firm, worst_name, n_flip, upd = -1.0, "", 0, {}
    for n, p in cpu["params"].items():
        d = (card["params"][n] - p).abs()
        n_flip += int((d > lr).sum())
        u_cpu = (p - before[n]).double()
        err2, ref2 = upd.get(_module_group(n), (0.0, 0.0))
        upd[_module_group(n)] = (err2 + float((d.double() ** 2).sum()),
                                 ref2 + float((u_cpu ** 2).sum()))
        g = cpu["grads"].get(n)
        if g is None:
            continue
        firm = (g.abs() > 100 * float((card["grads"][n] - g).abs().max())) & (g.abs() > 1e-4)
        if firm.any():
            over = float((d - 1e-3 * lr - 2 * torch.finfo(torch.float32).eps * p.abs())[firm].max())
            if over > worst_firm:
                worst_firm, worst_name = over, n
    upd_rel = {k: math.sqrt(e / r) if r > 0 else math.inf for k, (e, r) in upd.items()}
    log(f"  params after one step: {n_flip} elements differ by more than lr = {lr:.1e}; "
        f"firm elements: worst margin {worst_firm:.3e} ({worst_name}); "
        "|u_card - u_cpu| / |u_cpu| per module: "
        + ", ".join(f"{k} {v:.2e}" for k, v in upd_rel.items()))
    bad = {k: v for k, v in upd_rel.items() if not v <= UPDATE_BOUND}
    if worst_firm > 0 or bad:
        raise AssertionError(f"parameters after the update differ: firm margin {worst_firm}, "
                             f"modules {bad}")
    results["train_parity"] = dict(loss_rel=loss_err, grad_rel=rel, update_rel=upd_rel,
                                   n_flip=n_flip)


if __name__ == "__main__":
    sys.exit(main())
