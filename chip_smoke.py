"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``poem_v2_tpu_torch/csrc`` (nvcc,
sm_90a) and runs the phases below; any failure raises and the exit code is
non-zero:

1. kernels: each kernel against its plain PyTorch version on CPU copies of
   the same inputs, in float32 and bfloat16, with both versions timed on
   the card (CUDA events) beside the one PyTorch call that computes the
   same function, where there is one, and the least time the card could
   take (bytes over 3.35 TB/s or operations over the peak of the dtype):
   K1-K5 and K8 at the serving path's batch-4 shapes (K4 and K5
   bit-identical), K1-K5 also at D = 128, 512 and 1024, the other tiers'
   widths, and K4 at medium's batch 16 (against the plain version on the
   card; K4 and K5 bit-identical there too), each time with its share of
   the bound; K3 also at batch 1 with a key count that
   is no multiple of any tile (4100), and its row logsumexp against the plain
   one (1e-5 absolute) in every K3 case, each side's distance from a float64
   logsumexp logged beside it; K1's bound from its least work (three
   products a row, the k / v projection once a cloud point), the TPU kernel's
   five products a row beside it; and the eval kernels at the synthetic
   ResNet-18 model's shapes (width 64, K = 8, 256 BPS points): K1 self and
   cross, K2, K3 at head dim 16 over 256 and 4096 keys (beside SDPA), K4 on 2
   views of 8x8 maps, K5 on a batch of 1 and 2 views;
1a. the attention core at neighbour counts that do not divide 32 (8, 24,
   48) and at 1 and 65 queries, D = 256 and D = 1024 at K = 24: K1, K2, K8
   and K6b (the backward of K6) against their plain versions on the card, K1's
   indices identical, K1 fed with its own indices (``neighbor_idx``) bit for
   bit the selecting call, and K6b bit for bit on a second launch; then the
   two selections alone against their plain versions on the card, indices
   identical and two launches alike: K1's at N = 1, 33, 799, 4096, 5000 and
   7000, M = 1 and 65, K = 1, 32, 48 and N, with and without duplicated
   points; K9's up to 32 768 candidates, with ragged blocks, every bucket a
   candidate and bucket sizes no multiple of 32 (margins as in phase 1c);
1b. the training kernels at the train path's batch-4 shapes, D = 256 and then
   D = 128, 512 and 1024 (on the card): K3b (dQ, dK, dV; 4 heads of D / 4;
   from the forward's saved output and logsumexp, which is what is timed; two
   launches bit-identical; the same bits without the saved pair; also at
   batch 1 with 4100 keys), K6 (value and all 14 input gradients; self and
   cross), K6b alone (the same gradients at K6's indices, two launches
   bit-identical, timed beside the plain version, autograd through the
   recompute) and K7 (n_rows 799 and 4096, heavily duplicated indices, two
   launches bit-identical). K6's and K6b's gradients: float32 to 1e-4 of each
   peak; bfloat16 against a float32 autograd of the plain version at the same
   bf16-rounded inputs, within the larger of the bfloat16 recompute's error
   and 2e-2 of the peak; the same cases at the synthetic model's D = 64, K = 8,
   N = 256 (K3b there at head dim 16, also over 4096 keys);
1e. bf16 at the batch-4 shapes, call by call and replayed from a CUDA
   graph: K4 (also at D = 128, 512, 1024 and at batch 16, with its share
   of the bound), K1 (cross), K2, K8, and K7 (self, cross) beside
   ``index_add_``; the selections alone with their bounds and plain versions:
   K1's (cross and self), K9's candidate choice and selection, K9's attention
   and K9 whole, beside ``torch.topk`` of a precomputed d2; K6's forward +
   backward and K6b alone, self and cross, at D = 256 and 1024;
1c. K9, the bucketed exact-KNN attention, on the real BPS cloud (4096 points
   in 32 k-d buckets of 128) with 799 queries on a posed hand, batch 4,
   D = 256 (and once D = 1024): against its plain version on the card
   (indices and certified blocks identical, margins to 1e-6), against K1 on
   the same inputs (every bucket a candidate: sentinel margins, K1's
   neighbours; 8 and 24 candidates: every certified block, of which there
   must be some at 8 and most at 24), the share of blocks it certifies, and
   its time beside K1's;
1d. K10, the five K-th-key variants at keys (16, 832, 4096), K = 32: each
   equal to its plain version, on the benchmark's keys and on keys whose rows
   share a 20-bit prefix (there also scan32 and radix8 equal to np.partition,
   and the five times beside ``torch.kthvalue`` and ``torch.topk``), then the
   benchmark itself
   (``ops/select.py:bench_kth_key``, what ``scripts/torch_bench_radix_select.py``
   runs): scan32 = radix8 = np.partition, cur = bcast, and the five times
   beside ``torch.kthvalue`` and ``torch.topk``;
2. serving: the POEM-medium model (HRNet-W40, 8 views, 4096 BPS points,
   799 queries, 3 decoder blocks, width 256) behind the port's Predictor in
   bfloat16 answers 8-view requests at batch 1, 4 and 16; outputs are
   checked for shape and finiteness and the kernels' launch counts per
   forward are checked;
2b. tiers: small, medium, medium_MANO, large and huge, each behind its own
   Predictor in bfloat16, answer batch-4 requests whose samples have 2-8
   valid views of 8 (K5 runs once per forward) and uniform 8-view requests
   (K5 does not run); medium also at batch 16; shapes, finiteness, launches
   per forward, latency and peak memory per configuration;
3. parity: the medium model in float32 at batch 1, on the card (kernels)
   and on the CPU (plain versions), same weights and inputs, TF32 off;
3b. parity of this slice: medium_MANO (with ``pred_pose`` / ``pred_shape``)
   and huge at batch 2 with mixed views, card against CPU in float32; and
   ``PointerLayer(use_fused=True)`` at D = 256, 799 queries, 4096 points,
   card (K8, two launches per forward) against CPU (plain);
4. train: (a) the medium model with float32 parameters, bfloat16 compute
   and remat takes 2 warm-up and 8 timed steps of the port's Trainer on a
   fixed synthetic batch of 8 samples with 1-8 of 8 views; loss and grad
   norm are finite, the loss falls, and the kernels' launches per step are
   checked; (b) one float32 step at batch 1, card (kernels) against CPU
   (plain versions), same weights, batch and jitter draws, dropout 0:
   loss terms, every gradient per module, and the parameters after the
   update; (c) small, medium_MANO, large and huge take 2 warm-up, 4 timed and
   6 more steps on the same batch: finite loss and grad norm, the launches
   per step, a loss under fixed noise that falls over the 12 steps, step time
   and peak memory;
   (d) phase (b) for medium_MANO, with the pose and shape terms.
5. the front doors, the port's train and eval CLIs (``cli/train.py:train``,
   ``cli/eval.py:evaluate`` on config dicts): (a) ``synthetic_smoke`` as
   shipped, one epoch of 16 steps at B4 from the prefetch feed, validation and
   a checkpoint; (b) the same on fixed sets for two epochs, and again resumed
   from the first epoch's snapshot: step, epoch and the next loss equal; (c)
   the eval CLI on (a)'s checkpoint with ``--eval_extra auc``; (d) medium with
   synthetic 256 px data, 1-8 of 8 views: 4 train steps at B8 with a 2-batch
   validation, then the eval CLI on its checkpoint. Each run's launches are
   counted around it and must equal its steps' and forwards' counts; losses
   finite, measures finite metres; ms/step (CUDA events), samples/s, peak
   GiB, checkpoint bytes and write / read seconds, eval samples/s.
6. this slice's paths at medium's full width, B8 (1-8 of 8 views): (a) the
   Trainer under ``torch.distributed``: world size 1 over NCCL against the
   single-process step, bit for bit in float32 (deterministic cuDNN and
   algorithms), the same launches, then both timed in turns in bfloat16 (ms /
   step, samples/s, peak GiB) and profiled once (device busy, idle share); two gloo ranks on the card (``--ddp-worker``
   processes of this script), B4 each, against the single-process B8 step in
   float32 at dropout 0: loss terms to 1e-5 relative, gradients per module to
   1e-4 of the module's largest (the backbone to phase 4b's 3e-2); (b) the
   ``--no-flash_train`` step: K3 / K3b / K6 / K6b launch 0 times and K7 4 times,
   at dropout 0 in float32, its gathered path fed K1's neighbours (K6 breaks
   near-ties by K1's packed keys), it is held to the flash step with (a)'s
   bounds, and read as shipped beside it; its bfloat16 step is timed beside the
   flash one; (c) medium's random weights
   (``NORM: frozen_bn``) under the released checkpoints' names through
   ``scripts/torch_convert_checkpoint.py`` into ``Predictor.from_config(ckpt_path=)``:
   the B4 mixed-view forward bit-identical to the source model's, K1-K5 launched.

The second-to-last line is a JSON object with one entry per kernel (``ms``
call by call; K4's also ``graph_ms``, from phase 1e's CUDA graph; K1's and
K9's also their selections' times from phase 1e under ``selection``; K3's and
K3b's their head-dim-16 cases under ``head_dim_16``; every entry its launches
on phase 5's paths under ``front_door_launches``); the last
line is ``{"ok": true, "device": {...}}``. Needs no network and no JAX;
without a CUDA device it fails before printing any result.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from poem_v2_tpu_torch.ops import (_lib, bilinear, cross_attn, knn_attn, points, scatter, scramble,
                                   select, vector_attn)

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
    "knn_vector_attention_trainable_bwd": dict(
        source="poem_v2_tpu_torch/csrc/knn_attn_bwd.cu",
        replaces="poem_v2_tpu/ops/pallas_knn_attn.py:994",
        wrapper=knn_attn.knn_vector_attention_trainable_bwd),
    "scatter_add_rows": dict(
        source="poem_v2_tpu_torch/csrc/scatter.cu",
        replaces="poem_v2_tpu/ops/pallas_scatter.py:57",
        wrapper=scatter.scatter_add_rows),
    "scrambled_merge_gather": dict(
        source="poem_v2_tpu_torch/csrc/scramble.cu",
        replaces="poem_v2_tpu/ops/pallas_scramble.py:99",
        wrapper=scramble.scrambled_merge_gather),
    "fused_vector_attention": dict(
        source="poem_v2_tpu_torch/csrc/knn_attn.cu",
        replaces="poem_v2_tpu/ops/pallas_vector_attn.py:80",
        wrapper=vector_attn.fused_vector_attention),
    "fused_knn_vector_attention_bucketed": dict(
        source="poem_v2_tpu_torch/csrc/knn_bucketed.cu",
        replaces="poem_v2_tpu/ops/pallas_knn_attn.py:597",
        wrapper=knn_attn.fused_knn_vector_attention_bucketed),
    # five entry points, one entry: its launches are theirs added up
    "radix_select": dict(
        source="poem_v2_tpu_torch/csrc/select.cu",
        replaces="scripts/bench_radix_select.py:153",
        wrappers=(select.key_row_sum, select.kth_key_scan32, select.kth_key_radix8,
                  select.kth_key_cur, select.kth_key_bcast)),
}
# K9 and K10 are functions only, as in the JAX package: no model path runs them
NO_MODEL_PATH = {"fused_knn_vector_attention_bucketed": 0, "radix_select": 0}
# launches per serving forward of a 3-block model whose samples all have 8
# valid views (every tier has 3 blocks); a batch that mixes view counts adds K5
LAUNCHES_PER_FORWARD = {
    "dense_cross_attention": 6, "fused_anchor_vector_attention": 2,
    "fused_knn_vector_attention": 4, "grid_sample_points_fused": 1,
    "dense_cross_attention_bwd": 0, "knn_vector_attention_trainable": 0,
    "knn_vector_attention_trainable_bwd": 0, "scatter_add_rows": 0, "scrambled_merge_gather": 0,
    "fused_vector_attention": 0, **NO_MODEL_PATH,
}
LAUNCHES_PER_MIXED_FORWARD = {**LAUNCHES_PER_FORWARD, "scrambled_merge_gather": 1}
# launches per train step of every tier (3 blocks each): two attentions per
# block, forward and backward; K6 (whose forward runs K1) in the self and
# cross attention of blocks 1 and 2, each backward K6b, scattering by K7. The
# remat recompute replays no kernel. Block 0's anchors and the sampler take
# plain paths in training, so K2 and K4 do not run, nor K5 (the mixed batch
# takes the differentiable gather) nor K8.
LAUNCHES_PER_TRAIN_STEP = {
    "dense_cross_attention": 6, "dense_cross_attention_bwd": 6,
    "fused_knn_vector_attention": 4, "knn_vector_attention_trainable": 4,
    "knn_vector_attention_trainable_bwd": 4, "scatter_add_rows": 4,
    "fused_anchor_vector_attention": 0, "grid_sample_points_fused": 0, "scrambled_merge_gather": 0,
    "fused_vector_attention": 0, **NO_MODEL_PATH,
}
# argument positions that stay float32 (xyz, anchor xyz, sample coords)
KEEP_F32 = {
    "fused_knn_vector_attention": (1, 2), "fused_anchor_vector_attention": (1, 4),
    "dense_cross_attention": (), "grid_sample_points_fused": (1,),
    "scrambled_merge_gather": (), "fused_vector_attention": (),
    # query xyz, cloud xyz and the buckets' box corners
    "fused_knn_vector_attention_bucketed": (1, 2, 4, 5),
}
# kernel vs plain version, relative to max|plain| of each output: float32
# differs only by summation order; bfloat16 by the order in which
# intermediates that are rounded to bfloat16 (x, h, t1 and the output) were
# summed, about one bfloat16 ulp (2**-8 relative) at the output's peak
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K3's row logsumexp is float32 in both dtypes, absolute: both sides sum the
# same exact products of the inputs in float32, in other orders
LSE_TOL = 1e-5
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory, bfloat16 in the tensor cores, float32 outside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


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


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def bound_ms(nbytes: float, flops: float, dtype):
    """The least time the card could take: (ms, "bytes" or "operations"), the
    larger of bytes over the memory rate and operations over the dtype's peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_flops(rows: int, D: int, products: int) -> float:
    """``products`` D x D products and the 3 -> D position layer for every
    (query, neighbour) row, 2 operations a multiply-add."""
    return rows * (products * 2.0 * D * D + 2.0 * 3 * D)


def knn_attention_flops(B: int, M: int, K: int, N: int, D: int) -> float:
    """The least work of K1: three D x D products a (query, neighbour) row, the
    k / v projection (two D x D products) once a cloud point, and the squared
    distances to the cloud (8 operations a pair)."""
    return attention_flops(B * M * K, D, 3) + B * N * 2 * 2.0 * D * D + 8.0 * B * M * N


def _mlps(f, D):
    """(fc_delta, fc_gamma) weights of a width-D vector attention."""
    def mlp(d_in):
        return (f(d_in, D) / math.sqrt(d_in), f(D) * 0.1, f(D, D) / math.sqrt(D), f(D) * 0.1)
    return mlp(3), mlp(D)


def _ball(rs, n):
    x = rs.randn(n, 3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy((x * rs.rand(n, 1) ** (1 / 3)).astype(np.float32))


def sdpa_heads(q, k, v, num_heads):
    """(B, L, H) -> (B, heads, L, hd) views for ``F.scaled_dot_product_attention``."""
    return [t.reshape(t.shape[0], t.shape[1], num_heads, -1).transpose(1, 2) for t in (q, k, v)]


def library_sdpa(args, kw):
    """K3's library call: ``F.scaled_dot_product_attention`` on the same heads."""
    qh, kh, vh = sdpa_heads(*args, kw["num_heads"])
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=kw["sm_scale"])


def library_grid_sample(args, kw):
    """K4's library call: ``F.grid_sample`` of the NCHW maps at the points."""
    feat, coords = args
    nchw, grid = feat.permute(0, 3, 1, 2), coords[:, :, None, :].to(feat.dtype)
    return lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)


def library_gather(args, kw):
    """K5's library call: ``torch.gather`` of the scrambled rows (index made beforehand)."""
    flat, nv = args
    rows = flat.reshape(flat.shape[0], -1, kw["C"])
    index = scramble.scramble_row_index(nv, kw["V"], rows.shape[1] // kw["V"])
    index = index[..., None].expand(-1, -1, kw["C"])
    return lambda: torch.gather(rows, 1, index)


def scramble_in_bytes_of(args, kw):
    """K5's input bytes: source rows 0 .. (NS - 1) * n_b + V - 1 of each sample,
    clamped, and n_val."""
    flat, nv = args
    NS = flat.shape[1] // (kw["V"] * kw["C"])
    rows = sum(min((NS - 1) * int(n) + kw["V"], kw["V"] * NS) for n in nv)
    return rows * kw["C"] * flat.element_size() + nv.numel() * 4


def kernel_cases(rs: np.random.RandomState, B=4, M=799, D=256, K=32, N=4096, V=8,
                 wide=(128, 512, 1024)):
    """Inputs at the shapes the serving phases' batch-4 requests give each kernel
    (the defaults; a rehearsal on the CPU passes small ones).

    Each case: kernel name, arguments, keywords, plain version, operations of
    one call, and optionally ``library`` (makes, from the card's arguments,
    the one PyTorch call that computes the same function), ``in_bytes`` (the
    input bytes the call needs, where that is less than all of them) and
    ``plain_on_card`` (compare with the plain version on the card)."""
    A = K  # anchors
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))

    q = f(B, M, D)
    qxyz = (f(B, M, 3) * 0.4)
    cloud = _ball(rs, N)[None].expand(B, N, 3).contiguous()
    wk, wv = f(D, D) / 16, f(D, D) / 16
    fcd, fcg = _mlps(f, D)
    n_val = torch.tensor(([3, V, 2, 6] * B)[:B], dtype=torch.int64)  # valid views per sample

    cases = {
        "fused_knn_vector_attention/self": dict(
            kernel="fused_knn_vector_attention",
            args=(q, qxyz, qxyz, f(B, M, D), wk, wv, fcd, fcg),
            kw=dict(n_neighbor=K, return_idx=True),
            plain=knn_attn.plain_fused_knn_vector_attention,
            flops=knn_attention_flops(B, M, K, M, D),
            flops_five=attention_flops(B * M * K, D, 5) + 8.0 * B * M * M),
        "fused_knn_vector_attention/cross": dict(
            kernel="fused_knn_vector_attention",
            args=(q, qxyz, cloud, f(B, N, D), wk, wv, fcd, fcg),
            kw=dict(n_neighbor=K, return_idx=True),
            plain=knn_attn.plain_fused_knn_vector_attention,
            flops=knn_attention_flops(B, M, K, N, D),
            flops_five=attention_flops(B * M * K, D, 5) + 8.0 * B * M * N),
        "fused_anchor_vector_attention": dict(
            kernel="fused_anchor_vector_attention",
            args=(q, qxyz, f(B, A, D), f(B, A, D), _ball(rs, A), fcd, fcg), kw={},
            plain=knn_attn.plain_fused_anchor_vector_attention,
            flops=attention_flops(B * M * A, D, 3)),
        "dense_cross_attention": dict(
            kernel="dense_cross_attention", args=(q, f(B, N, D), f(B, N, D)),
            kw=dict(num_heads=4, sm_scale=1 / 8), plain=cross_attn.plain_dense_cross_attention,
            flops=4.0 * B * M * N * D, library=library_sdpa, lse=True),
        "grid_sample_points_fused": dict(
            kernel="grid_sample_points_fused",
            args=(f(B * V, 16, 16, D), torch.from_numpy(rs.uniform(-1.2, 1.2, (B * V, N, 2))
                                                        .astype(np.float32))),
            kw={}, plain=bilinear.plain_grid_sample_points,
            flops=8.0 * B * V * N * D, library=library_grid_sample, exact=True),
        "scrambled_merge_gather": dict(
            kernel="scrambled_merge_gather", args=(f(B, V * N * D), n_val), kw=dict(V=V, C=D),
            plain=scramble.plain_scrambled_merge_gather, flops=0.0, library=library_gather,
            in_bytes=scramble_in_bytes_of, exact=True),
        "fused_vector_attention": dict(
            kernel="fused_vector_attention",
            args=(q, f(B, M, K, D), f(B, M, K, D), f(B, M, K, 3) * 0.4, fcd, fcg), kw={},
            plain=vector_attn.plain_fused_vector_attention,
            flops=attention_flops(B * M * K, D, 3)),
    }
    # K1 (cross), K2, K3 (4 heads of Dw / 4), K4 and K5 at the widths of the
    # small, large and huge tiers
    for Dw in wide:
        fw = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
        fcd_w, fcg_w = _mlps(fw, Dw)
        s = 1 / math.sqrt(Dw)
        qw = fw(B, M, Dw)
        cases[f"wide/fused_knn_vector_attention/D{Dw}"] = dict(
            kernel="fused_knn_vector_attention",
            args=(qw, qxyz, cloud, fw(B, N, Dw), fw(Dw, Dw) * s, fw(Dw, Dw) * s, fcd_w, fcg_w),
            kw=dict(n_neighbor=K, return_idx=True),
            plain=knn_attn.plain_fused_knn_vector_attention,
            flops=knn_attention_flops(B, M, K, N, Dw),
            flops_five=attention_flops(B * M * K, Dw, 5) + 8.0 * B * M * N, plain_on_card=True)
        cases[f"wide/fused_anchor_vector_attention/D{Dw}"] = dict(
            kernel="fused_anchor_vector_attention",
            args=(qw, qxyz, fw(B, A, Dw), fw(B, A, Dw), _ball(rs, A), fcd_w, fcg_w), kw={},
            plain=knn_attn.plain_fused_anchor_vector_attention,
            flops=attention_flops(B * M * A, Dw, 3), plain_on_card=True)
        cases[f"wide/dense_cross_attention/D{Dw}"] = dict(
            kernel="dense_cross_attention", args=(qw, fw(B, N, Dw), fw(B, N, Dw)),
            kw=dict(num_heads=4, sm_scale=1 / math.sqrt(Dw // 4)),
            plain=cross_attn.plain_dense_cross_attention, flops=4.0 * B * M * N * Dw,
            library=library_sdpa, plain_on_card=True, lse=True)
        cases[f"wide/grid_sample_points_fused/D{Dw}"] = dict(
            kernel="grid_sample_points_fused",
            args=(fw(B * V, 16, 16, Dw), cases["grid_sample_points_fused"]["args"][1]), kw={},
            plain=bilinear.plain_grid_sample_points, flops=8.0 * B * V * N * Dw,
            library=library_grid_sample, plain_on_card=True, exact=True)
        cases[f"wide/scrambled_merge_gather/D{Dw}"] = dict(
            kernel="scrambled_merge_gather", args=(fw(B, V * N * Dw), n_val),
            kw=dict(V=V, C=Dw), plain=scramble.plain_scrambled_merge_gather, flops=0.0,
            library=library_gather, in_bytes=scramble_in_bytes_of, exact=True, plain_on_card=True)
    # K4 at medium's batch 16: 128 maps
    cases[f"wide/grid_sample_points_fused/B{4 * B}_D{D}"] = dict(
        kernel="grid_sample_points_fused",
        args=(f(4 * B * V, 16, 16, D), torch.from_numpy(
            rs.uniform(-1.2, 1.2, (4 * B * V, N, 2)).astype(np.float32))), kw={},
        plain=bilinear.plain_grid_sample_points, flops=32.0 * B * V * N * D,
        library=library_grid_sample, plain_on_card=True, exact=True)
    # K3 where no tile divides the keys, one sample
    cases[f"ragged/dense_cross_attention/B1_N{N + 4}"] = dict(
        kernel="dense_cross_attention", args=(f(1, M, D), f(1, N + 4, D), f(1, N + 4, D)),
        kw=dict(num_heads=4, sm_scale=1 / math.sqrt(D // 4)),
        plain=cross_attn.plain_dense_cross_attention, flops=4.0 * M * (N + 4) * D,
        library=library_sdpa, plain_on_card=True, lse=True)
    return cases


def synthetic_kernel_cases(rs: np.random.RandomState, B=4, M=799, D=64, K=8, N=256, V=2,
                           HW=8, N_big=4096, A=32):
    """The eval kernels at the shapes the synthetic ResNet-18 model gives them
    (``configs/synthetic_smoke.yaml``: width 64 in 4 heads of 16, 256 BPS points,
    K = 8, 2 views of 8x8 maps at 64 px), named ``synthetic/...``: K1 self and
    cross, K2, K3 at head dim 16 over N and ``N_big`` keys, K4 and K5 on a batch
    that mixes 1 and 2 views. Cases as :func:`kernel_cases` makes them."""
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    s = 1 / math.sqrt(D)
    q, qxyz = f(B, M, D), f(B, M, 3) * 0.4
    cloud = _ball(rs, N)[None].expand(B, N, 3).contiguous()
    fcd, fcg = _mlps(f, D)
    n_val = torch.tensor(([1, V, V, 1] * B)[:B], dtype=torch.int64)
    cases = {}
    for name, (pxyz, n_pts) in (("self", (qxyz, M)), ("cross", (cloud, N))):
        cases[f"synthetic/fused_knn_vector_attention/{name}_D{D}_K{K}"] = dict(
            kernel="fused_knn_vector_attention",
            args=(q, qxyz, pxyz, f(B, n_pts, D), f(D, D) * s, f(D, D) * s, fcd, fcg),
            kw=dict(n_neighbor=K, return_idx=True),
            plain=knn_attn.plain_fused_knn_vector_attention,
            flops=knn_attention_flops(B, M, K, n_pts, D),
            flops_five=attention_flops(B * M * K, D, 5) + 8.0 * B * M * n_pts)
    cases[f"synthetic/fused_anchor_vector_attention/D{D}"] = dict(
        kernel="fused_anchor_vector_attention",
        args=(q, qxyz, f(B, A, D), f(B, A, D), _ball(rs, A), fcd, fcg), kw={},
        plain=knn_attn.plain_fused_anchor_vector_attention, flops=attention_flops(B * M * A, D, 3))
    for n in (N, N_big):
        cases[f"synthetic/dense_cross_attention/hd{D // 4}_N{n}"] = dict(
            kernel="dense_cross_attention", args=(q, f(B, n, D), f(B, n, D)),
            kw=dict(num_heads=4, sm_scale=1 / math.sqrt(D // 4)),
            plain=cross_attn.plain_dense_cross_attention, flops=4.0 * B * M * n * D,
            library=library_sdpa, lse=True)
    cases[f"synthetic/grid_sample_points_fused/V{V}_{HW}x{HW}_D{D}"] = dict(
        kernel="grid_sample_points_fused",
        args=(f(B * V, HW, HW, D), torch.from_numpy(rs.uniform(-1.2, 1.2, (B * V, N, 2))
                                                    .astype(np.float32))),
        kw={}, plain=bilinear.plain_grid_sample_points, flops=8.0 * B * V * N * D,
        library=library_grid_sample, exact=True)
    cases[f"synthetic/scrambled_merge_gather/V{V}_D{D}"] = dict(
        kernel="scrambled_merge_gather", args=(f(B, V * N * D), n_val), kw=dict(V=V, C=D),
        plain=scramble.plain_scrambled_merge_gather, flops=0.0,
        library=library_gather, in_bytes=scramble_in_bytes_of, exact=True)
    return cases


def lse_float64(q, k, num_heads, sm_scale):
    """The row logsumexp of the scaled logits in float64, on the CPU."""
    qh, kh = (t.detach().cpu().double() for t in (q, k))
    qh, kh = (t.reshape(t.shape[0], t.shape[1], num_heads, -1).transpose(1, 2) for t in (qh, kh))
    return torch.logsumexp((qh @ kh.transpose(-1, -2)) * sm_scale, dim=-1)


def check_lse(name, got, want, dtype, ref64=None):
    """K3's second output against the plain logsumexp, ``LSE_TOL`` absolute.
    With ``ref64`` (a float64 logsumexp of the same logits) it also logs how
    far each of the two lies from it: a diagnostic, not a limit."""
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"{name}: lse {tuple(got.shape)} {got.dtype}, plain "
                             f"{tuple(want.shape)}")
    err = float((got.detach().cpu() - want.detach().cpu()).abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= LSE_TOL
    f64 = ""
    if ref64 is not None:
        f64 = (f"; against float64: kernel {float((got.cpu().double() - ref64).abs().max()):.3e}"
               f", plain {float((want.cpu().double() - ref64).abs().max()):.3e}")
    log(f"  {name} [{_dt(dtype)}] lse max_abs_err={err:.3e} (tol {LSE_TOL:.0e}){f64} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: lse max_abs_err {err} > {LSE_TOL}{f64}")
    return err


def phase_kernels(results, synthetic=None, **shapes):
    log("phase 1: kernels vs plain versions")
    rs = np.random.RandomState(0)
    cases = kernel_cases(rs, **shapes)
    cases.update(synthetic_kernel_cases(np.random.RandomState(10), **(synthetic or {})))
    for case, c in cases.items():
        kname, args, kw, plain = c["kernel"], c["args"], c["kw"], c["plain"]
        for dtype in (torch.float32, torch.bfloat16):
            # geometry (xyz, coords) stays float32; features and weights take dtype
            def cast(t, i):
                return _to(t, "cpu", None if i in KEEP_F32[kname] else dtype)
            cpu_args = tuple(cast(t, i) for i, t in enumerate(args))
            dev_args = _to(cpu_args, "cuda")
            wrapper = KERNELS[kname]["wrapper"]
            got = wrapper(*dev_args, **kw)
            torch.cuda.synchronize()
            # the wide cases are held against the plain version on the card
            # (float32 products, TF32 off): the CPU would take minutes there
            want = plain(*dev_args, **kw) if c.get("plain_on_card") else plain(*cpu_args, **kw)
            nbytes = (c["in_bytes"](cpu_args, kw) if "in_bytes" in c else _nbytes(cpu_args)) \
                + _nbytes(got)
            if kw.get("return_idx"):
                (got, gidx), (want, widx) = got, want
                same = torch.equal(gidx.cpu(), widx.cpu())
                log(f"  {case} [{_dt(dtype)}] indices identical: {same}")
                if not same:
                    n_diff = int((gidx.cpu() != widx.cpu()).sum())
                    raise AssertionError(f"{case}: {n_diff} neighbour indices differ")
            err = compare(case, got, want, dtype, tol_rel=0.0 if c.get("exact") else None)
            lse_err = None
            if c.get("lse"):
                _, lse = cross_attn.dense_cross_attention_forward(*dev_args, **kw,
                                                                  return_lse=True)
                qk = (dev_args if c.get("plain_on_card") else cpu_args)[:2]
                lse_err = check_lse(case, lse, cross_attn.plain_dense_cross_attention_lse(
                    *qk, **kw), dtype, ref64=lse_float64(*cpu_args[:2], **kw))
            ms = time_cuda(lambda: wrapper(*dev_args, **kw))
            plain_ms = time_cuda(lambda: plain(*dev_args, **kw), iters=3, warmup=1)
            library_ms = None
            if "library" in c:
                library_ms = time_cuda(c["library"](dev_args, kw))
            b_ms, b_by = bound_ms(nbytes, c["flops"], dtype)
            log(f"  {case} [{_dt(dtype)}] kernel {ms:.4f} ms, plain on card {plain_ms:.3f} ms, "
                f"library call {'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
                f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                f"{c['flops'] / 1e9:.2f} GFLOP): {100 * b_ms / ms:.1f}% of it")
            results.setdefault(case, {})[_dt(dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by)
            if "flops_five" in c:  # K1: the bound of the TPU kernel's five products a row
                results[case][_dt(dtype)]["bound_five_ms"] = bound_ms(nbytes, c["flops_five"],
                                                                      dtype)[0]
            if lse_err is not None:
                results[case][_dt(dtype)]["lse_max_abs_err"] = lse_err


def core_shape_cases(rs: np.random.RandomState, B: int, N: int, D: int, K: int, M: int):
    """K1 (cross), K2 (K anchors) and K8 (K gathered neighbours) at one (D, K, M):
    kernel name -> (arguments, keywords, plain version), float32 on the CPU."""
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    s = 1 / math.sqrt(D)
    q, qxyz = f(B, M, D), f(B, M, 3) * 0.4
    cloud = _ball(rs, N)[None].expand(B, N, 3).contiguous()
    fcd, fcg = _mlps(f, D)
    return {
        "fused_knn_vector_attention": (
            (q, qxyz, cloud, f(B, N, D), f(D, D) * s, f(D, D) * s, fcd, fcg),
            dict(n_neighbor=K, return_idx=True), knn_attn.plain_fused_knn_vector_attention),
        "fused_anchor_vector_attention": (
            (q, qxyz, f(B, K, D), f(B, K, D), _ball(rs, K), fcd, fcg), {},
            knn_attn.plain_fused_anchor_vector_attention),
        "fused_vector_attention": (
            (q, f(B, M, K, D), f(B, M, K, D), f(B, M, K, 3) * 0.4, fcd, fcg), {},
            vector_attn.plain_fused_vector_attention),
    }


def k6_train_inputs(rs: np.random.RandomState, B: int, M: int, N: int, D: int, dtype,
                    self_attn: bool):
    """K6's 14 inputs on the card (features in ``dtype``, xyz and the weights
    float32, as the model hands them over) and a (B, M, D) cotangent in
    ``dtype``; self attention: one cloud, the queries' own points."""
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    s = 1 / math.sqrt(D)
    qxyz = f(B, M, 3) * 0.4
    pxyz, n = (qxyz, M) if self_attn else (_ball(rs, N)[None].expand(B, N, 3).contiguous(), N)
    fcd, fcg = _mlps(f, D)
    ts = [f(B, M, D).to(dtype), qxyz, pxyz, f(B, n, D).to(dtype), f(D, D) * s, f(D, D) * s,
          *fcd, *fcg]
    return _to(ts, "cuda"), _to(f(B, M, D), "cuda", dtype)


def phase_core_shapes(results, B=2, N=600, D=256, wide=1024, Ks=(8, 24, 48), Ms=(1, 65),
                      K_wide=24):
    """Phase 1a: K1, K2, K8 and K6b at neighbour counts that do not divide 32 and
    at 1 and 65 queries, at D and at ``wide`` for one such K, against their plain
    versions on the card (``TOL``; K6b as :func:`hold_k6_grads` holds it, and two
    launches bit-identical), K1's indices identical; and K1 fed with its own
    returned indices (``neighbor_idx``): the selecting call's bits."""
    log(f"phase 1a: the attention core at K = {', '.join(map(str, Ks))} and M = "
        f"{', '.join(map(str, Ms))} (D = {D}; D = {wide} at K = {K_wide}), B={B}, N={N}")
    rs = np.random.RandomState(9)
    shapes = [(D, K, M) for K in Ks for M in Ms] + [(wide, K_wide, M) for M in Ms]
    for Dw, K, M in shapes:
        for kname, (args, kw, plain) in core_shape_cases(rs, B, N, Dw, K, M).items():
            wrapper = KERNELS[kname]["wrapper"]
            case = f"shapes/{kname}/D{Dw}_K{K}_M{M}"
            for dtype in (torch.float32, torch.bfloat16):
                dev = _to(tuple(_to(t, "cpu", None if i in KEEP_F32[kname] else dtype)
                                for i, t in enumerate(args)), "cuda")
                got = wrapper(*dev, **kw)
                want = plain(*dev, **kw)
                torch.cuda.synchronize()
                row = {}
                if kw.get("return_idx"):
                    (got, gidx), (want, widx) = got, want
                    if not torch.equal(gidx, widx):
                        raise AssertionError(f"{case}: {int((gidx != widx).sum())} neighbour "
                                             "indices differ")
                    again = wrapper(*dev, n_neighbor=K, neighbor_idx=gidx)
                    torch.cuda.synchronize()
                    if not torch.equal(again, got):
                        raise AssertionError(f"{case}: neighbor_idx gives other bits")
                    row["from_idx_bit_identical"] = True
                row["max_abs_err"] = compare(case, got, want, dtype)
                results.setdefault(case, {})[_dt(dtype)] = row
        for dtype in (torch.float32, torch.bfloat16):
            ts, dout = k6_train_inputs(rs, B, M, N, Dw, dtype, self_attn=False)
            with torch.no_grad():
                idx = knn_attn.fused_knn_vector_attention(*ts[:6], ts[6:10], ts[10:],
                                                          n_neighbor=K, return_idx=True)[1]
            k6b_case(results, f"shapes/knn_vector_attention_trainable_bwd/D{Dw}_K{K}_M{M}", ts,
                     idx, dout, dtype)
    log("  K1's indices identical to the plain selection in every case; K1 fed with its own "
        "indices bit-identical to the selecting call; K6b bit-identical on a second launch")


# K9's selection at the edges of its limits: (B, M, N, bucket size, block_q,
# n_cand, K, queries around one point): a ragged last block; every bucket a
# candidate (the sentinel margin); bucket sizes that are no multiple of 32; one
# candidate bucket; 6144 candidates (the most staged in shared memory), 6656,
# 8192, 16 384 and 32 768 (read from L2); K = n_cand x bucket size
K9_EDGE_CASES = (
    (4, 799, 4096, 128, 32, 8, 32, True), (2, 203, 1000, 40, 7, 3, 48, False),
    (2, 100, 768, 96, 50, 1, 16, True), (2, 65, 16384, 512, 16, 12, 32, True),
    (2, 65, 16384, 512, 16, 13, 32, False), (2, 65, 8192, 1024, 16, 8, 32, False),
    (1, 33, 16384, 512, 33, 32, 48, False), (1, 40, 32768, 1024, 32, 32, 32, True),
    (2, 65, 600, 24, 64, 25, 48, False), (1, 9, 360, 45, 4, 2, 90, False),
    (2, 1, 512, 32, 32, 16, 1, False))


def _cloud(rs, n: int, dup: bool) -> torch.Tensor:
    """n points in the unit ball; ``dup``: every point twice (exact ties)."""
    if dup and n > 1:
        half = _ball(rs, (n + 1) // 2)
        return torch.cat([half, half], 0)[:n]
    return _ball(rs, n)


def phase_selection_shapes(results, B=2, Ns=(1, 33, 799, 4096, 5000, 7000), Ms=(1, 65),
                           Ks=(1, 32, 48), k9_cases=K9_EDGE_CASES):
    """Phase 1a, the selections alone: K1's (``knn_select``) at every N, M and
    K of the lists and K = N (packed keys up to 4096 points, exact keys above,
    the cloud read from L2 above 6144), on clouds with and without every point
    twice, and K9's (``knn_select_bucketed``) at ``k9_cases``, against their
    plain versions on the card: indices ``torch.equal``, K9's margins certified
    alike and within 1e-6, and two launches the same bits."""
    log(f"phase 1a: the selections alone: K1's at N = {', '.join(map(str, Ns))}, M = "
        f"{', '.join(map(str, Ms))}, K = {', '.join(map(str, Ks))} and N; K9's at "
        f"{len(k9_cases)} shapes")
    rs = np.random.RandomState(11)
    n1 = 0
    for N in Ns:
        for M in Ms:
            for K in sorted({k for k in (*Ks, N) if k <= N}):
                for dup in (False, True):
                    pxyz = _to(_cloud(rs, N, dup)[None].expand(B, N, 3).contiguous(), "cuda")
                    qxyz = _to(torch.from_numpy((rs.randn(B, M, 3) * 0.4).astype(np.float32)),
                               "cuda")
                    got, again = (knn_attn.knn_select(qxyz, pxyz, K) for _ in range(2))
                    want = knn_attn.knn_select_plain(qxyz, pxyz, K)
                    torch.cuda.synchronize()
                    if not (torch.equal(got, want) and torch.equal(got, again)):
                        raise AssertionError(
                            f"knn_select B{B} M{M} N{N} K{K} dup={dup}: "
                            f"{int((got != want).sum())} indices differ from the plain version, "
                            f"{int((got != again).sum())} between two launches")
                    n1 += 1
    log(f"  knn_select: {n1} cases identical to the plain version, two launches alike")
    for Bc, M, N, SB, BQ, C, K, tight in k9_cases:
        cloud = rs.randn(N, 3).astype(np.float32)
        perm, lo, hi = points.build_balanced_buckets(cloud, SB)
        q_np = cloud[7] + rs.randn(Bc, M, 3).astype(np.float32) * (0.05 if tight else 1.0)
        qxyz, pxyz, lo, hi = (_to(torch.from_numpy(np.array(a)), "cuda") for a in (
            q_np, np.broadcast_to(cloud[perm], (Bc, N, 3)), lo, hi))
        cand = knn_attn.select_candidate_buckets(knn_attn._pad_queries_edge(qxyz, BQ), lo, hi,
                                                 BQ, C)
        args = (qxyz, pxyz, lo, hi, cand, K, BQ, C, SB)
        (idx, margins), (idx2, margins2) = (knn_attn.knn_select_bucketed(*args) for _ in range(2))
        widx, wm = knn_attn.knn_select_bucketed_plain(*args)
        torch.cuda.synchronize()
        tag = f"knn_select_bucketed B{Bc} M{M} N{N} SB{SB} BQ{BQ} C{C} K{K}"
        if not torch.equal(idx, widx):
            raise AssertionError(f"{tag}: {int((idx != widx).sum())} indices differ")
        finite = wm < 1e30
        m_err = float((margins - wm)[finite].abs().max()) if bool(finite.any()) else 0.0
        if not torch.equal(margins >= 0, wm >= 0) or not torch.equal(margins < 1e30, finite) \
                or m_err > 1e-6:
            raise AssertionError(f"{tag}: margins differ from the plain version "
                                 f"(max abs {m_err:.3e})")
        if C * SB == N and not bool((margins == knn_attn.MARGIN_SENTINEL).all()):
            raise AssertionError(f"{tag}: a margin is not the sentinel")
        if not (torch.equal(idx, idx2) and torch.equal(margins, margins2)):
            raise AssertionError(f"{tag}: two launches differ")
        log(f"  {tag}: indices identical, margins within {m_err:.1e}, "
            f"{int((margins >= 0).sum())} of {margins.numel()} blocks certified")
    results["selection_shapes"] = dict(knn_select=n1, knn_select_bucketed=len(k9_cases))


@functools.lru_cache(maxsize=None)
def capture_stream() -> "torch.cuda.Stream":
    """The one side stream of every capture: cuBLAS keeps a workspace (tens of
    MB) for each stream it meets, until the process ends, so a new stream per
    capture would raise every later phase's peak memory."""
    return torch.cuda.Stream()


def time_graph(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``iters`` calls (captured after 3 calls on a side stream): the kernels'
    time without the host's launch cost."""
    stream = capture_stream()
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


# float32 operations of a selection a (query, point) pair: 13 for d2, one compare
SELECT_OPS_PER_PAIR = 14


def phase_graph_times(results, B=4, M=799, N=4096, D=256, K=32, wide=1024,
                      sampler_shapes=((4, 128), (4, 512), (4, 1024), (16, 256)),
                      bucket_size=128, n_cand=8, block_q=32):
    """Phase 1e, bf16 at the batch-4 shapes: K4, the selection alone, the core
    (K1 cross, K2, K8) and K7 (self, cross) call by call and from a CUDA graph,
    K4 also at the (batch, width) of ``sampler_shapes`` with its byte bound,
    and ``index_add_`` from a graph beside K7; the selections alone with their
    bounds and plain versions' times: K1's (cross and self), K9's candidate
    choice and selection on the BPS cloud at ``n_cand``, K9's attention at its
    indices and K9 whole, beside ``torch.topk`` of a precomputed d2 (a
    yardstick, not the same function: it does not promise the lowest index among
    ties); then K6's forward + backward (the train path's call) and K6b alone,
    self and cross, at D and at ``wide``."""
    log(f"phase 1e: call by call and from a CUDA graph, bf16, B={B}, M={M}, N={N}, D={D}, K={K} "
        f"[{gpu_line()}]")
    rs = np.random.RandomState(10)
    bf = torch.bfloat16
    f = lambda *s: _to(torch.from_numpy(rs.randn(*s).astype(np.float32)), "cuda", bf)
    s = 1 / math.sqrt(D)
    q = f(B, M, D)
    qxyz = _to(torch.from_numpy((rs.randn(B, M, 3) * 0.4).astype(np.float32)), "cuda")
    cloud = _to(_ball(rs, N)[None].expand(B, N, 3).contiguous(), "cuda")
    fcd, fcg = _mlps(f, D)
    xf, wk, wv = f(B, N, D), f(D, D) * s, f(D, D) * s
    ka, va = f(B, K, D), f(B, K, D)
    axyz = _to(_ball(rs, K), "cuda")
    kg, vg, dg = f(B, M, K, D), f(B, M, K, D), f(B, M, K, 3) * 0.4
    maps = f(B * 8, 16, 16, D)  # K4: the 8 views' feature maps, 4096 BPS points each
    grid = _to(torch.from_numpy(rs.uniform(-1.2, 1.2, (B * 8, N, 2)).astype(np.float32)), "cuda")
    calls = {
        "grid_sample_points_fused": lambda: bilinear.grid_sample_points(maps, grid),
        "fused_knn_vector_attention": lambda: knn_attn.fused_knn_vector_attention(
            q, qxyz, cloud, xf, wk, wv, fcd, fcg, n_neighbor=K),
        "fused_anchor_vector_attention": lambda: knn_attn.fused_anchor_vector_attention(
            q, qxyz, ka, va, axyz, fcd, fcg),
        "fused_vector_attention": lambda: vector_attn.fused_vector_attention(
            q, kg, vg, dg, fcd, fcg),
    }
    g = f(B, M, K, D)
    for case, n_rows in (("self", M), ("cross", N)):
        idx = _to(torch.from_numpy(rs.randint(0, n_rows, (B, M, K)).astype(np.int32)), "cuda")
        rows = (torch.arange(B, device=idx.device)[:, None] * n_rows
                + idx.reshape(B, -1).long()).reshape(-1)
        src = g.reshape(-1, D).float()
        sink = torch.empty((B * n_rows, D), dtype=torch.float32, device=idx.device)
        calls[f"scatter_add_rows/{case}"] = \
            lambda g=g, idx=idx, n=n_rows: scatter.scatter_add_rows(g, idx, n)
        calls[f"index_add_/{case}"] = \
            lambda sink=sink, rows=rows, src=src: sink.zero_().index_add_(0, rows, src)
    timed = {}

    def time_both(name, call):
        timed[name] = dict(ms=time_cuda(call, iters=20, warmup=3), graph_ms=time_graph(call))
        log(f"  {name}: call by call {timed[name]['ms']:.4f} ms, from a CUDA graph "
            f"{timed[name]['graph_ms']:.4f} ms")

    with torch.inference_mode():
        for name, call in calls.items():
            time_both(name, call)
        # K4 at the other tiers' widths and at medium's batch 16: call by call
        # a narrow call's host time hides the kernel's
        for name, (bs, width) in [("grid_sample_points_fused", (B, D))] + [
                (f"grid_sample_points_fused/B{bs}_D{width}", (bs, width))
                for bs, width in sampler_shapes]:
            if name not in timed:
                fm = f(bs * 8, 16, 16, width)
                pts = _to(torch.from_numpy(rs.uniform(-1.2, 1.2, (bs * 8, N, 2))
                                           .astype(np.float32)), "cuda")
                time_both(name, lambda fm=fm, pts=pts: bilinear.grid_sample_points(fm, pts))
            nbytes = bs * 8 * (16 * 16 * width * 2 + N * 2 * 4 + N * width * 2)
            b_ms = bound_ms(nbytes, 8.0 * bs * 8 * N * width, torch.bfloat16)[0]
            timed[name]["bound_ms"] = b_ms
            log(f"  {name}: bound {b_ms:.4f} ms (bytes), from a CUDA graph "
                f"{100 * b_ms / timed[name]['graph_ms']:.1f}% of it")
        # the selections alone, K9's parts and K9 whole
        args9, fcd9, fcg9 = bucketed_case(np.random.RandomState(8), B, M, N, D, bucket_size)
        k9 = "fused_knn_vector_attention_bucketed"
        dev9 = _to(tuple(_to(t, "cpu", None if i in KEEP_F32[k9] else bf)
                         for i, t in enumerate((*args9, fcd9, fcg9))), "cuda")
        q9, qxyz9, cloud9, xf9, lo9, hi9 = dev9[:6]
        cand9 = knn_attn.select_candidate_buckets(knn_attn._pad_queries_edge(qxyz9, block_q),
                                                  lo9, hi9, block_q, n_cand)
        sel9 = (qxyz9, cloud9, lo9, hi9, cand9, K, block_q, n_cand, bucket_size)
        idx9 = knn_attn.knn_select_bucketed(*sel9)[0]
        d2 = {"cross": knn_attn.square_distance_rn(qxyz, cloud),
              "self": knn_attn.square_distance_rn(qxyz, qxyz)}
        selections = {  # name: (call, plain version, (query, point) pairs, bytes)
            "knn_select (K1's selection alone)": (
                lambda: knn_attn.knn_select(qxyz, cloud, K),
                lambda: knn_attn.knn_select_plain(qxyz, cloud, K), B * M * N,
                4 * B * (M * 3 + N * 3 + M * K)),
            "knn_select/self (K1's selection alone)": (
                lambda: knn_attn.knn_select(qxyz, qxyz, K),
                lambda: knn_attn.knn_select_plain(qxyz, qxyz, K), B * M * M,
                4 * B * (M * 3 + M * 3 + M * K)),
            "knn_select_bucketed (K9's selection alone)": (
                lambda: knn_attn.knn_select_bucketed(*sel9),
                lambda: knn_attn.knn_select_bucketed_plain(*sel9),
                B * M * n_cand * bucket_size,
                4 * B * (M * 3 + N * 3 + M * K + cand9.numel() // B + M // block_q + 1)
                + 4 * 6 * lo9.shape[0]),
        }
        for name, (call, plain, pairs, nbytes) in selections.items():
            time_both(name, call)
            b_ms, b_by = bound_ms(nbytes, SELECT_OPS_PER_PAIR * pairs, torch.float32)
            timed[name].update(bound_ms=b_ms, bound_by=b_by,
                               plain_ms=time_cuda(plain, iters=3, warmup=1))
            log(f"  {name}: bound {b_ms:.4f} ms ({b_by}), from a CUDA graph "
                f"{100 * b_ms / timed[name]['graph_ms']:.1f}% of it; plain version on the card "
                f"{timed[name]['plain_ms']:.4f} ms")
        for case in ("cross", "self"):
            time_both(f"torch.topk of d2/{case} (a yardstick)",
                      lambda d=d2[case]: torch.topk(d, K, dim=-1, largest=False, sorted=True))
        time_both("select_candidate_buckets (K9's candidate choice)",
                  lambda: knn_attn.select_candidate_buckets(
                      knn_attn._pad_queries_edge(qxyz9, block_q), lo9, hi9, block_q, n_cand))
        time_both("K9's attention (K1's chain at K9's indices)",
                  lambda: knn_attn.fused_knn_vector_attention(
                      q9, qxyz9, cloud9, xf9, *dev9[6:], n_neighbor=K, neighbor_idx=idx9))
        time_both("fused_knn_vector_attention_bucketed (K9 whole)",
                  lambda: knn_attn.fused_knn_vector_attention_bucketed(
                      *dev9, n_neighbor=K, block_q=block_q, n_cand=n_cand,
                      bucket_size=bucket_size))
    for Dw in (D, wide):
        for case in ("self", "cross"):
            ts, dout = k6_train_inputs(rs, B, M, N, Dw, bf, self_attn=case == "self")
            leaves = [t.requires_grad_() for t in ts]
            with torch.no_grad():
                idx = knn_attn.fused_knn_vector_attention(*ts[:6], ts[6:10], ts[10:],
                                                          n_neighbor=K, return_idx=True)[1]

            def fwd_bwd(leaves=leaves, dout=dout):
                out = knn_attn.knn_vector_attention_trainable(*leaves[:6], leaves[6:10],
                                                              leaves[10:], n_neighbor=K)
                return torch.autograd.grad(out, leaves, dout)

            def bwd(ts=ts, idx=idx, dout=dout):
                with torch.no_grad():
                    return _k6b(knn_attn.knn_vector_attention_trainable_bwd, ts, idx, dout)

            time_both(f"knn_vector_attention_trainable fwd + bwd/{case}/D{Dw}", fwd_bwd)
            time_both(f"knn_vector_attention_trainable_bwd/{case}/D{Dw}", bwd)
            del ts, leaves, idx
    results["graph_times"] = timed


# K6's gradients in float32: on the card the backward is K6b's float32 chain
# (scalar FMA products), against the plain version, autograd through the
# float32 recompute; the two sum in other orders, nothing else
K6_GRAD_TOL = 1e-4
# ... and in bfloat16. The recompute K6b replaced ran every operation in
# bfloat16 (its gradient of q reached 5e-2 of the peak); K6b rounds delta, t1,
# x and h to bfloat16 as the forward does and computes in float32. Both are
# held against a float32 autograd of K6's plain forward (K1's plain version at
# the same indices, which rounds at the kernel's points and passes those
# roundings straight through) on the same bf16 inputs: K6b to the larger of
# the bfloat16 recompute's error and K6B_BF16_REL of each gradient's peak.
# (Against the float32 function without the forward's roundings, both would
# differ from it mostly by the forward's rounding of delta, t1, x and h, which
# K6b must keep; tests/test_torch_knn_attn_bwd.py holds K6b's rounding points
# within K6B_BF16_REL of this reference on the CPU.)
K6B_BF16_REL = 2e-2
# K7 sums the same float32 (or exactly upcast bfloat16) values in float32 on
# both sides: only the summation order can differ
K7_TOL = 1e-5


def _k6b(fn, ts, idx, dout):
    """The 14 gradients of K6 at indices ``idx`` and cotangent ``dout`` by ``fn``
    (K6b's wrapper or its plain version) on the inputs ``ts``."""
    return fn(*ts[:6], ts[6:10], ts[10:], idx, dout)


def _peak(grads, i):
    # fc_gamma's output bias (input 13) shifts every neighbour of a channel
    # alike: its exact gradient is 0, so it is held to the scale of g1's (12)
    return float(grads[12 if i == 13 else i].float().abs().max())


def plain_k6_grads(ts, idx, dout):
    """The 14 gradients of K6's plain forward (K1's plain version at the
    indices ``idx``) at the inputs ``ts`` by autograd: float32 arithmetic,
    and in bfloat16 the forward's roundings passed straight through."""
    leaves = [t.detach().requires_grad_() for t in ts]
    out = knn_attn.plain_fused_knn_vector_attention(
        *leaves[:6], leaves[6:10], leaves[10:], n_neighbor=idx.shape[-1], neighbor_idx=idx)
    return torch.autograd.grad(out, leaves, dout.to(out.dtype))


def hold_k6_grads(name, got, ts, idx, dout, dtype, want=None):
    """Hold K6's 14 gradients ``got`` at inputs ``ts`` (on the card), indices
    ``idx`` and cotangent ``dout``. Float32: against ``want``, else the plain
    version on the card, to ``K6_GRAD_TOL`` of each peak. bfloat16: against
    :func:`plain_k6_grads` on the same inputs, each within the larger of the
    bfloat16 recompute's error and ``K6B_BF16_REL`` of the peak; both errors
    are printed. Returns the largest error, absolute and over its peak."""
    plain = knn_attn.plain_knn_vector_attention_trainable_bwd
    if dtype == torch.float32:
        want = _k6b(plain, ts, idx, dout) if want is None else want
        errs = [compare(f"{name} grad {i}", g, w, dtype, scale=_peak(want, i),
                        tol_rel=K6_GRAD_TOL) for i, (g, w) in enumerate(zip(got, want))]
        return max(errs), max(e / _peak(want, i) for i, e in enumerate(errs))
    ref = plain_k6_grads(ts, idx, dout)
    rec = _k6b(plain, ts, idx, dout)
    errs, rels = [], []
    for i, (g, r, w) in enumerate(zip(got, rec, ref)):
        peak = _peak(ref, i)
        err = float((g.float() - w.float()).abs().max())
        rec_err = float((r.float() - w.float()).abs().max())
        lim = max(rec_err, K6B_BF16_REL * peak)
        ok = bool(torch.isfinite(g).all()) and err <= lim
        log(f"  {name} grad {i} [bfloat16] max_abs_err={err:.3e}, bf16 recompute "
            f"{rec_err:.3e} (limit {lim:.3e}, peak {peak:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} grad {i}: max_abs_err {err} > {lim}")
        errs.append(err)
        rels.append(err / peak)
    return max(errs), max(rels)


def k6b_case(results, name, ts, idx, dout, dtype, iters=None):
    """K6b alone on the card at ``ts`` / ``idx`` / ``dout``: its gradients held by
    :func:`hold_k6_grads`, a second launch bit for bit the first, and with
    ``iters`` its time beside the plain version's and its bound."""
    fn = knn_attn.knn_vector_attention_trainable_bwd
    got, again = _k6b(fn, ts, idx, dout), _k6b(fn, ts, idx, dout)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two launches differ")
    err, rel = hold_k6_grads(name, got, ts, idx, dout, dtype)
    row = dict(max_abs_err=err, max_rel_err_grads=rel, bit_identical=True)
    if iters:
        B, M, D = ts[0].shape
        K, n_pts = idx.shape[-1], ts[2].shape[1]
        ms = time_cuda(lambda: _k6b(fn, ts, idx, dout), iters=iters)
        plain_ms = time_cuda(
            lambda: _k6b(knn_attn.plain_knn_vector_attention_trainable_bwd, ts, idx, dout),
            iters=3, warmup=1)
        # the least work of the gradients: per row the three products of the input
        # gradients and the three of the weight gradients; per cloud point
        # dx_full's two and dWk / dWv (the forward's rerun is the port's choice).
        # Bytes: the 14 inputs, idx, dout and the 14 gradients
        flops = 2.0 * D * D * (6 * B * M * K + 4 * B * n_pts)
        b_ms, b_by = bound_ms(_nbytes(list(ts)) + _nbytes([idx, dout]) + _nbytes(list(got)),
                              flops, dtype)
        log(f"  {name} [{_dt(dtype)}] K6b {ms:.3f} ms, plain (autograd recompute) on card "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}): {100 * b_ms / ms:.1f}% of it")
        row.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
    results.setdefault(name, {})[_dt(dtype)] = row
    return got


def phase_train_kernels(results, B=4, M=799, D=256, K=32, N=4096, wide=(128, 512, 1024),
                        synthetic=(64, 8, 256)):
    """Phase 1b: K3b, K6 and K7 against their plain versions at the train path's
    shapes: at D on CPU copies of the inputs, at the ``wide`` widths of the other
    tiers on the card; at the synthetic ResNet-18 model's (D, K, N) on CPU copies,
    K3b there (head dim D / 4 = 16) also over N keys; then K3b alone at one
    sample and a key count that no tile divides."""
    log("phase 1b: training kernels vs plain versions")
    rs = np.random.RandomState(1)
    train_kernel_cases(results, rs, B, M, D, K, N, on_card=False)
    for Dw in wide:
        train_kernel_cases(results, rs, B, M, Dw, K, N, on_card=True)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    Ds, Ks, Ns = synthetic
    train_kernel_cases(results, rs, B, M, Ds, Ks, Ns, on_card=False, prefix="synthetic")
    dense_bwd_case(results, f"synthetic/dense_cross_attention_bwd/D{Ds}_N{N}",
                   (f(B, M, Ds), f(B, N, Ds), f(B, N, Ds), f(B, M, Ds)), 4,
                   1 / math.sqrt(Ds // 4), on_card=False, iters=10)
    dense_bwd_case(results, f"ragged/dense_cross_attention_bwd/B1_N{N + 4}",
                   (f(1, M, D), f(1, N + 4, D), f(1, N + 4, D), f(1, M, D)), 4,
                   1 / math.sqrt(D // 4), on_card=True, iters=5)


def dense_bwd_case(results, name, qkvd, heads, sm_scale, on_card, iters):
    """K3b on (q, k, v, dout): dQ, dK, dV from the forward's saved output and
    logsumexp against the plain backward (on the card if ``on_card``, else on
    CPU copies), a second launch and a call without the saved pair bit for bit
    the same, and the saved-pair call timed."""
    B, M, D = qkvd[0].shape
    N = qkvd[1].shape[1]
    for dtype in (torch.float32, torch.bfloat16):
        cpu = [t.to(dtype) for t in qkvd]
        dev = _to(cpu, "cuda")
        with torch.no_grad():
            out, lse = cross_attn.dense_cross_attention_forward(*dev[:3], heads, sm_scale,
                                                                return_lse=True)
        bwd = lambda: cross_attn.dense_cross_attention_bwd(*dev, heads, sm_scale, out=out,
                                                           lse=lse)
        got, again = bwd(), bwd()
        unsaved = cross_attn.dense_cross_attention_bwd(*dev, heads, sm_scale)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"  {name} [{_dt(dtype)}] two launches bit-identical: {same}")
        if not same:
            raise AssertionError(f"{name}: two launches differ")
        # without the saved pair the wrapper runs the forward first: the same
        # kernels, so the same bits
        for n, g, u in zip("qkv", got, unsaved):
            compare(f"{name} d{n} without saved (out, lse)", u, g, dtype, tol_rel=0.0)
        side = dev if on_card else cpu
        want = cross_attn.plain_dense_cross_attention_bwd(*side, heads, sm_scale)
        lse_err = check_lse(name, lse, cross_attn.plain_dense_cross_attention_lse(
            *side[:2], heads, sm_scale), dtype)
        err = max(compare(f"{name} d{n}", g, w, dtype) for n, g, w in zip("qkv", got, want))
        ms = time_cuda(bwd, iters=iters)
        plain_ms = time_cuda(
            lambda: cross_attn.plain_dense_cross_attention_bwd(*dev, heads, sm_scale),
            iters=3, warmup=1)
        # the library call: the backward of F.scaled_dot_product_attention,
        # which also starts from its saved output and logsumexp
        leaves = [t.detach().requires_grad_() for t in dev[:3]]
        qh, kh, vh = sdpa_heads(*leaves, heads)
        sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, scale=sm_scale)
        dout = dev[3].reshape(B, M, heads, -1).transpose(1, 2)
        library_ms = time_cuda(
            lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True))
        # S, dP, dQ, dK and dV: five (M, N, hd) products a head
        b_ms, b_by = bound_ms(_nbytes(cpu) + _nbytes([out, lse]) + _nbytes(got),
                              10.0 * B * M * N * D, dtype)
        log(f"  {name} [{_dt(dtype)}] kernel {ms:.3f} ms, "
            f"plain (autograd) on card {plain_ms:.3f} ms, library call {library_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        results.setdefault(name, {})[_dt(dtype)] = dict(
            max_abs_err=err, lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def train_kernel_cases(results, rs, B, M, D, K, N, on_card, prefix=None):
    """K3b (4 heads of D / 4), K6 (self and cross) and K7 (M and N rows) at width
    D. ``on_card``: a width of another tier, named ``wide/<kernel>/.../D<D>`` and
    held against the plain version on the card (the CPU would take minutes);
    ``prefix`` names the cases ``<prefix>/<kernel>/.../D<D>`` instead."""
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    prefix = prefix or ("wide" if on_card else None)
    tag = (lambda name: f"{prefix}/{name}/D{D}") if prefix else (lambda name: name)
    iters = 5 if on_card else 10
    heads, sm_scale, s = 4, 1 / math.sqrt(D // 4), 1 / math.sqrt(D)

    # K3b: dQ, dK, dV of the dense attention
    dense_bwd_case(results, tag("dense_cross_attention_bwd"),
                   (f(B, M, D), f(B, N, D), f(B, N, D), f(B, M, D)), heads, sm_scale, on_card,
                   iters)

    # K6: value and the gradients of its 14 inputs, self (M points) and cross (N)
    q, qxyz, ct = f(B, M, D), f(B, M, 3) * 0.4, f(B, M, D)
    mlps = [f(3, D), f(D) * 0.1, f(D, D) * s, f(D) * 0.1, f(D, D) * s, f(D) * 0.1,
            f(D, D) * s, f(D) * 0.1]
    clouds = {"self": (qxyz, f(B, M, D)),
              "cross": (_ball(rs, N)[None].expand(B, N, 3).contiguous(), f(B, N, D))}

    def k6(fn, ts):
        ts = [t.detach().requires_grad_() for t in ts]
        out = fn(*ts[:6], ts[6:10], ts[10:], n_neighbor=K)
        return out, torch.autograd.grad(out, ts, ct.to(out.device, out.dtype))

    for case, (pxyz, xf) in clouds.items():
        for dtype in (torch.float32, torch.bfloat16):
            cpu = [q.to(dtype), qxyz, pxyz, xf.to(dtype), f(D, D) * s, f(D, D) * s, *mlps]
            dev = _to(cpu, "cuda")
            got, g_got = k6(knn_attn.knn_vector_attention_trainable, dev)
            torch.cuda.synchronize()
            want, g_want = k6(knn_attn.plain_fused_knn_vector_attention, dev) if on_card \
                else k6(knn_attn.knn_vector_attention_trainable, cpu)
            name = tag(f"knn_vector_attention_trainable/{case}")
            err = compare(name, got, want, dtype)
            with torch.no_grad():
                idx = knn_attn.fused_knn_vector_attention(*dev[:6], dev[6:10], dev[10:],
                                                          n_neighbor=K, return_idx=True)[1]
            dout = ct.to(dev[0].device, dtype)
            # the Function's gradients (K1's forward, K6b's backward), then K6b alone
            g_err = hold_k6_grads(name, g_got, dev, idx, dout, dtype,
                                  want=g_want if dtype == torch.float32 else None)[0]
            k6b_case(results, tag(f"knn_vector_attention_trainable_bwd/{case}"), dev, idx, dout,
                     dtype, iters=iters)
            ms = time_cuda(lambda: k6(knn_attn.knn_vector_attention_trainable, dev), iters=iters)
            plain_ms = time_cuda(lambda: k6(knn_attn.plain_fused_knn_vector_attention, dev),
                                 iters=3, warmup=1)
            # what the function needs: the selection, the forward's five products a
            # row, and two products for the gradients of each (15 in all; the port's
            # recompute of the forward is its own choice and is not counted).
            # Bytes: the 14 inputs, their 14 gradients, the output and its cotangent
            n_pts = pxyz.shape[1]
            flops = 3 * attention_flops(B * M * K, D, 5) + 8.0 * B * M * n_pts
            b_ms, b_by = bound_ms(_nbytes(cpu) + _nbytes(list(g_got)) + 2 * _nbytes(got), flops,
                                  dtype)
            log(f"  {name} [{_dt(dtype)}] forward + backward {ms:.3f} ms, "
                f"plain (autograd) on card {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
            results.setdefault(name, {})[_dt(dtype)] = dict(
                max_abs_err=err, max_abs_err_grads=g_err, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
            del got, g_got, want, g_want, idx

    # K7: self (M rows, ~K entries each) and cross (N rows, entries only on every
    # 16th row: ~100 each at the defaults); a second launch must give the same bits
    g = f(B, M, K, D)
    for case, n_rows, step in (("self", M, 1), ("cross", N, 16)):
        idx = torch.from_numpy((rs.randint(0, n_rows // step, (B, M, K)) * step)
                               .astype(np.int32))
        for dtype in (torch.float32, torch.bfloat16):
            gc = g.to(dtype)
            gd, idd = _to(gc, "cuda"), _to(idx, "cuda")
            got = scatter.scatter_add_rows(gd, idd, n_rows)
            again = scatter.scatter_add_rows(gd, idd, n_rows)
            torch.cuda.synchronize()
            name = tag(f"scatter_add_rows/{case}")
            same = torch.equal(got, again)
            log(f"  {name} [{_dt(dtype)}] two launches bit-identical: {same}")
            if not same:
                raise AssertionError(f"{name}: two launches differ")
            want = scatter.plain_scatter_add_rows(gd, idd, n_rows) if on_card \
                else scatter.plain_scatter_add_rows(gc, idx, n_rows)
            err = compare(name, got, want, dtype, tol_rel=K7_TOL)
            ms = time_cuda(lambda: scatter.scatter_add_rows(gd, idd, n_rows))
            plain_ms = time_cuda(lambda: scatter.plain_scatter_add_rows(gd, idd, n_rows))
            # the library call: index_add_ alone, on float32 rows made beforehand
            rows = (torch.arange(B, device=gd.device)[:, None] * n_rows
                    + idd.reshape(B, -1).long()).reshape(-1)
            src = gd.reshape(-1, D).float()
            sink = torch.empty((B * n_rows, D), dtype=torch.float32, device=gd.device)
            library_ms = time_cuda(lambda: sink.zero_().index_add_(0, rows, src))
            b_ms, b_by = bound_ms(_nbytes([gd, idd, got]), float(gd.numel()), dtype)
            log(f"  {name} [{_dt(dtype)}] kernel {ms:.3f} ms, plain on card {plain_ms:.3f} ms, "
                f"library call (index_add_) {library_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
            results.setdefault(name, {})[_dt(dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by)


def bucketed_case(rs: np.random.RandomState, B: int, M: int, N: int, D: int, bucket_size: int):
    """K9's inputs as the decoder would give them: the BPS cloud of the released
    models (``assets/bps.npy`` at N = 4096; a generated ball otherwise) laid out
    in k-d buckets, and as queries the joints and vertices of a posed MANO hand
    centred in the ball, in the model's query order, both over the ball's radius.
    Returns (args up to wv, fc_delta, fc_gamma), float32 on the CPU."""
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.mano.layer import ManoLayer
    from poem_v2_tpu_torch.models.poem import load_static_assets

    head = MEDIUM["MODEL"]["HEAD"]
    radius = head["RADIUS_SAMPLE"]
    bps = load_static_assets(head, N, radius)[0] / radius               # (N, 3), unit ball
    perm, lo, hi = points.build_balanced_buckets(bps, bucket_size)      # host, once per cloud
    cloud = torch.from_numpy(bps[perm])[None].expand(B, N, 3).contiguous()
    pose = torch.from_numpy((rs.randn(B, 48) * 0.2).astype(np.float32))
    betas = torch.from_numpy((rs.randn(B, 10) * 0.3).astype(np.float32))
    hand = ManoLayer(center_idx=9)(pose, betas)
    qxyz = (torch.cat([hand.joints, hand.verts], 1) / radius)[:, :M].contiguous()
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    s = 1 / math.sqrt(D)
    args = (f(B, M, D), qxyz, cloud, f(B, N, D), torch.from_numpy(lo), torch.from_numpy(hi),
            f(D, D) * s, f(D, D) * s)
    return args, *_mlps(f, D)


def _same_neighbours_as_k1(name, idx9, idx1, d2, rows):
    """(B, M) bool: the queries whose K9 and K1 neighbour sets are the same. K1
    orders by keys that drop d2's low 12 bits, K9 by the full float32 d2, so
    where the K-th and the next distance agree in their upper 20 bits the two
    rightly differ; any other difference among ``rows`` (B, M), the queries of
    certified blocks, raises."""
    s9, s1 = idx9.long().sort(-1).values, idx1.long().sort(-1).values
    same = (s9 == s1).all(-1)
    if not bool((same | ~rows).all()):
        # farthest selected d2 of each, with the low 12 bits dropped: equal in a tie
        far9 = torch.gather(d2, 2, idx9.long()).amax(-1).clamp_min(0).view(torch.int32) & ~0xFFF
        far1 = torch.gather(d2, 2, idx1.long()).amax(-1).clamp_min(0).view(torch.int32) & ~0xFFF
        wrong = int((rows & ~same & (far9 != far1)).sum())
        if wrong:
            raise AssertionError(f"{name}: {wrong} queries differ from K1 beyond a packed-key tie")
    return same


def phase_bucketed(results, B=4, M=799, N=4096, D=256, K=32, bucket_size=128, block_q=32,
                   n_cand=8, n_cand_most=24, wide=(1024,)):
    """Phase 1c: K9 against its plain version and against K1, on the BPS cloud.
    ``n_cand`` is the default the function is timed and counted at and must
    certify some block; at ``n_cand_most`` candidates most blocks must be
    certified, so that the agreement with K1 is held on most of the queries."""
    kname = "fused_knn_vector_attention_bucketed"
    NB = N // bucket_size
    log(f"phase 1c: bucketed exact-KNN attention (K9): {N} BPS points in {NB} buckets of "
        f"{bucket_size}, {M} hand queries, B={B}, K={K}, block_q={block_q}")
    fn, plain = knn_attn.fused_knn_vector_attention_bucketed, \
        knn_attn.plain_fused_knn_vector_attention_bucketed
    nblk = -(-M // block_q)
    for Dw in (D, *wide):
        args, fcd, fcg = bucketed_case(np.random.RandomState(8), B, M, N, Dw, bucket_size)
        case = kname if Dw == D else f"wide/{kname}/D{Dw}"
        for dtype in (torch.float32, torch.bfloat16) if Dw == D else (torch.bfloat16,):
            dev = _to(tuple(_to(t, "cpu", None if i in KEEP_F32[kname] else dtype)
                            for i, t in enumerate((*args, fcd, fcg))), "cuda")
            k1_args = (*dev[:4], *dev[6:])
            out1, idx1 = knn_attn.fused_knn_vector_attention(*k1_args, n_neighbor=K,
                                                             return_idx=True)
            d2 = knn_attn.square_distance_rn(dev[1], dev[2])
            shares = {}
            for C in (n_cand, n_cand_most, NB):
                kw = dict(n_neighbor=K, block_q=block_q, n_cand=C, bucket_size=bucket_size,
                          return_idx=True)
                got, margins, idx = fn(*dev, **kw)
                torch.cuda.synchronize()
                want, w_margins, w_idx = plain(*dev, **kw)  # on the card, as the wide cases
                tag = f"{case} n_cand={C}"
                if not torch.equal(idx, w_idx):
                    raise AssertionError(f"{tag}: {int((idx != w_idx).sum())} indices differ "
                                         "from the plain version")
                err = compare(tag, got, want, dtype)
                certified = margins >= 0
                finite = w_margins < 1e30
                m_err = float((margins - w_margins)[finite].abs().max()) if bool(finite.any()) \
                    else 0.0
                if margins.shape != (B, nblk) or not torch.equal(certified, w_margins >= 0) \
                        or not torch.equal(margins < 1e30, finite) or m_err > 1e-6:
                    raise AssertionError(f"{tag}: margins differ from the plain version "
                                         f"(max abs {m_err:.3e})")
                if C == NB and not bool((margins == knn_attn.MARGIN_SENTINEL).all()):
                    raise AssertionError(f"{tag}: a margin is not the sentinel")
                # against K1: every query of a certified block
                rows = certified[:, :, None].expand(B, nblk, block_q).reshape(B, -1)[:, :M]
                same = _same_neighbours_as_k1(tag, idx, idx1, d2, rows)
                if bool((~same & rows).any()):
                    n_tie = int((~same & rows).sum())
                    log(f"  {tag}: {n_tie} certified queries tie with K1's packed keys")
                shares[C] = float(certified.float().mean())
                least = {n_cand: 1 / (B * nblk), n_cand_most: 0.5, NB: 1.0}[C]
                if shares[C] < least:
                    raise AssertionError(f"{tag}: {100 * shares[C]:.1f}% of the blocks certified, "
                                         f"below {100 * least:.1f}%: the comparison with K1 "
                                         "would hold too few queries")
                held = rows & same
                k1_err = compare(f"{tag} vs K1 on {int(held.sum())} of {B * M} queries",
                                 got[held], out1[held], dtype)
                log(f"  {tag} [{_dt(dtype)}] indices identical to the plain version, margins "
                    f"within {m_err:.1e}, blocks certified {int(certified.sum())} of "
                    f"{B * nblk} ({100 * shares[C]:.1f}%), least margin "
                    f"{float(margins.min()):.3e}, vs K1 {k1_err:.3e}")
            kw = dict(n_neighbor=K, block_q=block_q, n_cand=n_cand, bucket_size=bucket_size)
            ms = time_cuda(lambda: fn(*dev, **kw))
            plain_ms = time_cuda(lambda: plain(*dev, **kw), iters=3, warmup=1)
            k1_ms = time_cuda(lambda: knn_attn.fused_knn_vector_attention(*k1_args, n_neighbor=K))
            # what the call needs: K1's least work, with distances to the candidates only
            flops = knn_attention_flops(B, M, K, N, Dw) - 8.0 * B * M * N \
                + 8.0 * B * M * n_cand * bucket_size
            nbytes = _nbytes(dev) + _nbytes(got) + _nbytes(margins)
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            log(f"  {case} [{_dt(dtype)}] n_cand={n_cand}: kernel {ms:.3f} ms, plain on card "
                f"{plain_ms:.3f} ms, K1 over the whole cloud {k1_ms:.3f} ms, library call none, "
                f"bound {b_ms:.4f} ms ({b_by})")
            results.setdefault(case, {})[_dt(dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, k1_ms=k1_ms, certified_share=shares[n_cand],
                certified_share_most=shares[n_cand_most])
            if Dw == D and dtype == torch.bfloat16:
                path_args = dev
    # the path: the function as a caller uses it (bfloat16, the defaults), counted on its own
    reset_launches()
    with torch.inference_mode():
        out, margins = fn(*path_args, n_neighbor=K, block_q=block_q, n_cand=n_cand,
                          bucket_size=bucket_size)
    torch.cuda.synchronize()
    if out.shape != (B, M, D) or margins.shape != (B, nblk) \
            or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{kname}: output {tuple(out.shape)}, margins "
                             f"{tuple(margins.shape)}, or a value that is not finite")
    return read_launches()


def phase_select(results, B=16, M=832, N=4096, K=32, block_q=64, chunk_j=16, device="cuda"):
    """Phase 1d: the five K-th-key variants (K10) and their benchmark."""
    log(f"phase 1d: K-th smallest key (K10), keys ({B}, {M}, {N}) int32, K={K}, "
        f"block_q={block_q}, chunk_j={chunk_j}")
    keys = _to(torch.from_numpy(select.make_keys(1, B, M, N)), "cuda")
    calls = select.variant_calls(keys, K, block_q, chunk_j)
    plains = select.variant_calls(keys, K, block_q, chunk_j, plain=True)
    plain_ms = {}
    for name in select.VARIANTS:
        got, want = calls[name](), plains[name]()
        torch.cuda.synchronize()
        if got.shape != (B, M, 1) or got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"radix_select {name}: differs from its plain version "
                                 f"in {int((got != want).sum())} rows")
        plain_ms[name] = time_cuda(plains[name], iters=2, warmup=0)
    log("  all five equal to their plain versions on the card (integers: tolerance 0)")
    # adversarial keys: every key of a row shares a 20-bit prefix, so radix8's
    # lists stay the whole row for five passes
    pk_np = select.make_prefix_keys(2, B, M, N)
    pkeys = _to(torch.from_numpy(pk_np), "cuda")
    pcalls = select.variant_calls(pkeys, K, block_q, chunk_j)
    pplains = select.variant_calls(pkeys, K, block_q, chunk_j, plain=True)
    pkth = np.partition(pk_np, K - 1, axis=2)[..., K - 1:K]
    for name in select.VARIANTS:
        got = pcalls[name]()
        if not torch.equal(got, pplains[name]()):
            raise AssertionError(f"radix_select {name}: differs from its plain version on "
                                 "keys with a shared prefix")
        if name in ("scan32", "radix8") and not np.array_equal(got.cpu().numpy(), pkth):
            raise AssertionError(f"radix_select {name}: differs from np.partition on keys "
                                 "with a shared prefix")
    prefix_ms = {name: time_cuda(pcalls[name], iters=20, warmup=2) for name in select.VARIANTS}
    prefix_kth_ms = time_cuda(lambda: torch.kthvalue(pkeys, K, dim=-1, keepdim=True))
    prefix_topk_ms = time_cuda(lambda: torch.topk(pkeys, K, dim=-1, largest=False, sorted=True))
    log("  keys with a row-wide 20-bit prefix: all five equal to their plain versions, scan32 "
        "and radix8 to np.partition; ms " + ", ".join(f"{n} {t:.4f}" for n, t in prefix_ms.items())
        + f"; torch.kthvalue {prefix_kth_ms:.4f}, torch.topk {prefix_topk_ms:.4f}")
    del pkeys, pcalls, pplains
    kth_ms = time_cuda(lambda: torch.kthvalue(keys, K, dim=-1, keepdim=True))
    topk_ms = time_cuda(lambda: torch.topk(keys, K, dim=-1, largest=False, sorted=True))
    same = torch.equal(torch.kthvalue(keys, K, dim=-1, keepdim=True).values, calls["scan32"]())
    if not same:
        raise AssertionError("radix_select: torch.kthvalue disagrees with scan32")
    # the path: the benchmark as its script runs it, counted on its own
    reset_launches()
    bench = select.bench_kth_key(B, M, N, K, block_q, chunk_j, device=device,
                                 log=lambda line: log("  " + line))
    launches = read_launches()
    b_ms, b_by = bound_ms(bench["key_bytes"] + B * M * 4, 0.0, torch.float32)
    exact = [n for n in ("scan32", "radix8") if bench["exact"][n]]
    best = min(exact, key=lambda n: bench["ms"][n])
    log("  ms per variant (kernel / plain on card): "
        + ", ".join(f"{n} {bench['ms'][n]:.3f} / {plain_ms[n]:.3f}" for n in select.VARIANTS)
        + f"; library calls: torch.kthvalue {kth_ms:.3f} ms, torch.topk (k={K}) {topk_ms:.3f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}: one read of the keys); fastest exact variant: {best}, "
        f"{100 * b_ms / bench['ms'][best]:.1f}% of the bound")
    results["radix_select"] = {"int32": dict(
        max_abs_err=0.0, ms=bench["ms"][best], plain_ms=plain_ms[best], library_ms=kth_ms,
        bound_ms=b_ms, bound_by=b_by, variant=best, variants_ms=bench["ms"],
        variants_plain_ms=plain_ms, topk_ms=topk_ms, prefix_keys_ms=prefix_ms,
        prefix_keys_kthvalue_ms=prefix_kth_ms, prefix_keys_topk_ms=prefix_topk_ms)}
    return launches


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
    phase_core_shapes(results)
    phase_selection_shapes(results)
    phase_train_kernels(results)
    phase_graph_times(results)
    bucketed_launches = phase_bucketed(results)
    select_launches = phase_select(results)
    launches = phase_serving(results)
    tier_launches = phase_tiers(results)
    phase_parity(results)
    phase_tier_parity(results)
    pointer_launches = phase_pointer_layer(results)
    train_launches = phase_train(results)
    phase_train_parity(results)
    phase_train_tiers(results)
    phase_train_parity(results, "medium_MANO")
    front = phase_front_doors(results)
    ddp_launches = phase_ddp(results)
    no_flash_launches = phase_no_flash(results)
    phase_reference_checkpoint(results)
    path_launches = {
        **{k: launches[k] for k, n in LAUNCHES_PER_FORWARD.items() if n},
        "scrambled_merge_gather": tier_launches["scrambled_merge_gather"],
        "fused_vector_attention": pointer_launches["fused_vector_attention"],
        **{k: train_launches[k] for k in (
            "dense_cross_attention_bwd", "knn_vector_attention_trainable",
            "knn_vector_attention_trainable_bwd", "scatter_add_rows")},
        "fused_knn_vector_attention_bucketed":
            bucketed_launches["fused_knn_vector_attention_bucketed"],
        "radix_select": select_launches["radix_select"],
    }

    # one entry per kernel, from the bfloat16 runs at the batch-4 shapes; the
    # times and bounds of K1, K6, K6b and K7 add their self and cross calls, the
    # pair a decoder block makes. ``launches`` is the count of the path the kernel
    # serves, read around that path alone: phase 2 for K1-K4, phase 2b for K5,
    # phase 3b's pointer layer for K8, the train steps for K3b, K6, K6b and K7, the
    # function call of phase 1c for K9 and the benchmark of phase 1d for K10
    # (integer keys: its one row stands for both dtypes)
    entries = []
    for kname, meta in KERNELS.items():
        rows = [r if "int32" not in r else {"bfloat16": r["int32"], "float32": r["int32"]}
                for case, r in results.items() if case.split("/")[0] == kname]
        bf = [r["bfloat16"] for r in rows]
        library = [r["library_ms"] for r in bf]
        entries.append(dict(
            name=kname, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=path_launches[kname], train_launches=train_launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in bf),
            max_abs_err_f32=max(r["float32"]["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in bf),
            plain_ms=sum(r["plain_ms"] for r in bf),
            bound_ms=sum(r["bound_ms"] for r in bf),
            bound_by=max(bf, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=None if None in library else sum(library),
        ))
    # K4's call costs the host about as much as the kernel takes on the card,
    # so beside its call-by-call ``ms`` it carries phase 1e's CUDA-graph time
    k4 = next(e for e in entries if e["name"] == "grid_sample_points_fused")
    k4["graph_ms"] = results["graph_times"]["grid_sample_points_fused"]["graph_ms"]
    # the two selections alone (phase 1e), beside their bounds and plain versions
    gt, by_name = results["graph_times"], {e["name"]: e for e in entries}
    sel = lambda name: {k: gt[name][k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                                 "bound_by")}
    by_name["fused_knn_vector_attention"]["selection"] = dict(
        cross=sel("knn_select (K1's selection alone)"),
        self=sel("knn_select/self (K1's selection alone)"),
        topk_graph_ms={c: gt[f"torch.topk of d2/{c} (a yardstick)"]["graph_ms"]
                       for c in ("cross", "self")})
    by_name["fused_knn_vector_attention_bucketed"]["selection"] = dict(
        sel("knn_select_bucketed (K9's selection alone)"),
        candidates_graph_ms=gt["select_candidate_buckets (K9's candidate choice)"]["graph_ms"],
        attention_graph_ms=gt["K9's attention (K1's chain at K9's indices)"]["graph_ms"],
        whole_graph_ms=gt["fused_knn_vector_attention_bucketed (K9 whole)"]["graph_ms"])
    # K3 / K3b at the synthetic models' head dim of 16 (phases 1 and 1b), and every
    # kernel's launches on the front doors' paths (phase 5)
    for name, prefix in (("dense_cross_attention", "synthetic/dense_cross_attention/"),
                         ("dense_cross_attention_bwd", "synthetic/dense_cross_attention_bwd/")):
        by_name[name]["head_dim_16"] = {
            case[len(prefix):]: {k: r["bfloat16"][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
            | {"max_abs_err_f32": r["float32"]["max_abs_err"],
               "lse_max_abs_err": max(r[d]["lse_max_abs_err"] for d in r)}
            for case, r in results.items() if case.startswith(prefix)}
    for e in entries:
        e["front_door_launches"] = {path: front[path]["launches"][e["name"]] for path in (
            "synthetic_train", "synthetic_eval", "medium_train", "medium_eval")}
        # one step of phase 6a's DDP (world 1, NCCL) and of 6b's --no-flash_train path
        e["ddp_launches"] = ddp_launches[e["name"]]
        e["no_flash_launches"] = no_flash_launches[e["name"]]
    # every kernel the synthetic paths run launched there
    quiet = [k for k, n in LAUNCHES_PER_SYNTHETIC_TRAIN_STEP.items()
             if n and not front["synthetic_train"]["launches"][k]]
    quiet += [k for k, n in LAUNCHES_PER_SYNTHETIC_FORWARD.items()
              if n and not front["synthetic_eval"]["launches"][k]]
    if quiet or not (front["synthetic_eval"]["launches"]["scrambled_merge_gather"]
                     or front["medium_eval"]["launches"]["scrambled_merge_gather"]):
        raise AssertionError(f"kernels the front doors did not launch: {quiet or 'K5'}")
    missing = [e["name"] for e in entries if e["launches"] < 1]
    if missing:
        raise AssertionError(f"kernels that no path launched: {missing}")
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


def _wrappers(meta):
    return meta["wrappers"] if "wrappers" in meta else (meta["wrapper"],)


def reset_launches():
    for meta in KERNELS.values():
        for w in _wrappers(meta):
            w.launches = 0


def read_launches():
    return {k: sum(w.launches for w in _wrappers(meta)) for k, meta in KERNELS.items()}


def mixed_view_mask(rs: np.random.RandomState, B: int, V: int = 8) -> np.ndarray:
    """(B, V) bool: sample b keeps its first n_b views, n_b drawn from 2..V with
    the counts not all alike and at least one sample keeping all V."""
    while True:
        n = rs.randint(2, V + 1, B)
        if (n == V).any() and (n != V).any():
            return np.arange(V)[None, :] < n[:, None]


def _check_outputs(name, out, bs):
    for key, shape in (("joints_3d", (bs, 21, 3)), ("verts_3d", (bs, 778, 3)),
                       ("joints_uv", (bs, 8, 21, 2))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{name} {key}: shape {out[key].shape}, "
                                 f"finite {np.isfinite(out[key]).all()}")


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
            _check_outputs(f"B{bs}", out, bs)
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


def phase_tiers(results):
    """Phase 2b: every released configuration answers mixed-view and uniform requests."""
    from poem_v2_tpu_torch.configs import RELEASE
    from poem_v2_tpu_torch.models.heads import ptemb_head
    from poem_v2_tpu_torch.serving.predictor import Predictor

    log("phase 2b: serving the five released configurations (bf16), mixed views against 8 views")
    card = gpu_line()
    rs = np.random.RandomState(4)
    requests = {}
    for bs in (4, 16):
        req = look_at_request(rs, bs, 8)
        mask = mixed_view_mask(rs, bs)
        requests[bs] = {"uniform": req, "mixed": (*req, mask)}
        log(f"  B{bs} mixed request: valid views per sample {mask.sum(1).tolist()}")
    total = {k: 0 for k in KERNELS}
    tiers = {}
    for name in ("small", "medium", "medium_MANO", "large", "huge"):
        t0 = time.time()
        pred = Predictor.from_config(RELEASE[name], dtype=torch.bfloat16, device="cuda", seed=0)
        n_params = sum(p.numel() for p in pred.model.parameters())
        build_s = time.time() - t0
        cells = [(4, "mixed"), (4, "uniform")] + ([(16, "mixed"), (16, "uniform")]
                                                  if name == "medium" else [])
        for bs, kind in cells:  # first call per shape: cuDNN autotuning, allocator
            pred(*requests[bs][kind])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row = {}
        for bs, kind in cells:
            want = LAUNCHES_PER_MIXED_FORWARD if kind == "mixed" else LAUNCHES_PER_FORWARD
            times = []
            for _ in range(5):
                reset_launches()
                t = time.perf_counter()
                out = pred(*requests[bs][kind])  # returns host arrays: ends synchronised
                times.append((time.perf_counter() - t) * 1e3)
                per_call = read_launches()
                if per_call != want:
                    raise AssertionError(f"{name} B{bs} {kind}: launches per forward "
                                         f"{per_call} != {want}")
                for k, n in per_call.items():
                    total[k] += n
                _check_outputs(f"{name} B{bs} {kind}", out, bs)
            row[f"B{bs}_{kind}"] = dict(median_ms=float(np.median(times)), runs_ms=times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {name}: {n_params / 1e6:.2f} M parameters, built in {build_s:.1f} s, peak device "
            f"memory {peak:.2f} GiB; request latency median of 5 [{card}]: "
            + "; ".join(f"{k} {v['median_ms']:.2f} ms" for k, v in row.items()))
        if name == "medium":
            # what the uniform-or-mixed test costs: bool((n_val == V).all()) makes the
            # host wait for everything enqueued before it (backbone, necks, sampler)
            stalls = []
            real = ptemb_head.scramble_views

            def timed(a_flat, n_val, fused=False):
                t = time.perf_counter()
                out = real(a_flat, n_val, fused)
                stalls.append((time.perf_counter() - t) * 1e3)
                return out

            ptemb_head.scramble_views = timed
            try:
                for _ in range(5):
                    pred(*requests[4]["uniform"])
            finally:
                ptemb_head.scramble_views = real
            row["scramble_views_host_ms_B4_uniform"] = float(np.median(stalls))
            log(f"  medium B4 uniform: the host spends {np.median(stalls):.2f} ms (median of 5) in "
                "scramble_views, a reshape behind one device-to-host sync")
        tiers[name] = dict(row, peak_gib=peak, params=n_params)
        del pred
        torch.cuda.empty_cache()
    log(f"  launches over the phase's timed forwards: {total}")
    results["tiers"] = tiers
    return total


def phase_parity(results):
    """Medium model in float32 at B=1: kernels on the card vs plain versions on the CPU."""
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.models.poem import create_poem_model

    log("phase 3: whole forward, card (kernels) vs CPU (plain versions), float32, TF32 off")
    model, _ = create_poem_model(MEDIUM["MODEL"], device="cpu",
                                 generator=torch.Generator().manual_seed(0))
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


def phase_tier_parity(results):
    """Phase 3b: medium_MANO and huge in float32 at B=2 with mixed views, card vs CPU."""
    from poem_v2_tpu_torch.configs import RELEASE
    from poem_v2_tpu_torch.models.poem import create_poem_model

    log("phase 3b: medium_MANO and huge, B=2 with 5 and 8 of 8 views, card (kernels) vs CPU "
        "(plain versions), float32, TF32 off")
    images, intr, extr = look_at_request(np.random.RandomState(6), 2, 8)
    mask = np.arange(8)[None, :] < np.array([5, 8])[:, None]
    img = torch.from_numpy(images).float() / 255.0 - 0.5
    args = (img, torch.from_numpy(mask), torch.from_numpy(intr), torch.from_numpy(extr),
            torch.zeros(2, 21, 3))
    # the limits of phase 3; the shape (MANO units) comes through the same float32
    # decoder plus one 799-term sum: 1e-4 as well. The pose (radians) is held to
    # 1e-3: at random weights the regressed 6D rows have small norms, and their
    # Gram-Schmidt multiplies the float32 noise by 1 / norm (tens)
    tol = {"pred_joints_uv": 1e-2, "pred_ref_joints_3d": 1e-4, "pred_joints_3d": 1e-4,
           "pred_verts_3d": 1e-4, "pred_pose": 1e-3, "pred_shape": 1e-4}
    for name in ("medium_MANO", "huge"):
        model, aux = create_poem_model(RELEASE[name]["MODEL"], device="cpu",
                                       generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            t = time.time()
            want = model(*args)
            cpu_s = time.time() - t
            reset_launches()
            got = model.to("cuda")(*(a.to("cuda") for a in args))
            torch.cuda.synchronize()
        if read_launches() != LAUNCHES_PER_MIXED_FORWARD:
            raise AssertionError(f"{name}: launches {read_launches()} != "
                                 f"{LAUNCHES_PER_MIXED_FORWARD}")
        keys = [k for k in tol if k in want]
        if aux["parametric_output"] != ("pred_pose" in keys):
            raise AssertionError(f"{name}: pred_pose in the outputs: {'pred_pose' in keys}")
        diffs = {}
        for key in keys:
            g, w = got[key].cpu(), want[key]
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"{name} {key}: shape {tuple(g.shape)}, non-finite on the card")
            diffs[key] = float((g - w).abs().max())
        log(f"  {name}: max |card - cpu|: " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
            + f" (cpu forward {cpu_s:.1f} s)")
        bad = {k: d for k, d in diffs.items() if d > tol[k]}
        if bad:
            raise AssertionError(f"{name}: card vs cpu {bad}")
        results[f"parity_{name}"] = diffs
        del model, got
        torch.cuda.empty_cache()


def phase_pointer_layer(results):
    """Phase 3b: PointerLayer(use_fused=True) on the card (K8) against the CPU (plain)."""
    from poem_v2_tpu_torch.models.decoder import PointerLayer
    from poem_v2_tpu_torch.models.poem import init_parameters

    log("phase 3b: PointerLayer(use_fused=True, use_fused_knn=False), D=256, 799 queries, 4096 "
        "points, K=32, B=4, float32: card (K8) vs CPU (plain)")
    rs = np.random.RandomState(7)
    B, M, N, D, K = 4, 799, 4096, 256, 32
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    layer = PointerLayer(D, K, K, init_block=False, use_fused=True, use_fused_knn=False).eval()
    init_parameters(layer, torch.Generator().manual_seed(5))
    args = (_ball(rs, N)[None].expand(B, N, 3).contiguous(), f(B, N, D), f(B, M, 3) * 0.4,
            f(B, M, D))
    with torch.inference_mode():
        want = layer(*args)
        dev_args = _to(args, "cuda")
        gpu_layer = layer.to("cuda")
        reset_launches()
        got = gpu_layer(*dev_args)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches["fused_vector_attention"] != 2 or sum(launches.values()) != 2:
            raise AssertionError(f"launches of one forward {launches}: want K8 twice, no other")
        # float32 on both sides, sums in other orders through two attentions
        errs = [compare(f"pointer layer {n}", g, w, torch.float32)
                for n, g, w in zip(("features", "xyz"), got, want)]
        ms = time_cuda(lambda: gpu_layer(*dev_args), iters=5, warmup=1)
        plain_layer = PointerLayer(D, K, K, init_block=False, use_fused=False,
                                   use_fused_knn=False).eval().to("cuda")
        plain_layer.load_state_dict(gpu_layer.state_dict())
        plain_ms = time_cuda(lambda: plain_layer(*dev_args), iters=5, warmup=1)
    log(f"  layer forward on the card: with K8 {ms:.3f} ms, with the reference attention "
        f"{plain_ms:.3f} ms (float32; the exact KNN by sort is in both)")
    results["pointer_layer"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    return launches


# phase 4b: per-module bound on max |card - cpu| / max |cpu| of the gradients
GRAD_BOUND = {"backbone": 3e-2, "feat_neck": 2e-3, "uv_neck": 2e-3, "head": 5e-4, "block": 1e-5}
# The parametric model's loss sees the last block's MANO surface only, so blocks 0
# and 1 take their gradients through block 2's attention alone, and float32 is not
# enough to hold them to 1e-5: the CPU's plain step with 8 threads and with 1 differ
# by 8.95e-5 of block 1's largest gradient and 9.6e-6 of block 0's, and from a
# float64 step by 8.95e-5 and 5.1e-5, the card by 2.9e-5 (NVIDIA H100 80GB HBM3;
# tests/test_torch_cuda.py::test_parametric_step_float32_gradient_conditioning).
# Each block has its own bound, about 3x what it read; block 2, which holds the
# mano_linear / flat_verts leaves and takes its gradients straight from K6, K7
# and K3b, stays at 4b's 1e-5
GRAD_BOUND_PARAMETRIC = {**GRAD_BOUND, "head.transformer.block_0": 5e-5,
                         "head.transformer.block_1": 3e-4, "head.transformer.block_2": 1e-5}
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
    # the Trainer seeds dropout per step from its own generator (MEDIUM's
    # MANUAL_SEED): the steps' losses repeat from run to run
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
    ("K3 dense_attn_*kernel", ("dense_attn_kernel", "dense_attn_wg_kernel")),
    ("K3b dense_attn_bwd_*", "dense_attn_bwd_"),
    # before K1's and cuBLAS's groups: their keys would take K6b's kernels too
    ("K6b knn_bwd_*", "knn_bwd_"),
    ("K1 (K6 fwd) knn_select + core", ("knn_select_kernel", "vector_attn_kernel",
                                        "core_gemm_kernel")),
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
        # a user annotation's device range (DDP's forward is one) spans kernels
        # counted on their own
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
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


def phase_train_parity(results, name="medium"):
    """Phases 4b (medium) and 4d (medium_MANO): one float32 train step at B1, card
    (kernels) vs CPU (plain versions)."""
    import copy

    from poem_v2_tpu_torch.configs import RELEASE
    from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu_torch.models.poem import create_poem_model, draw_ref_noise
    from poem_v2_tpu_torch.training.trainer import Trainer, make_train_step

    cfg = RELEASE[name]
    log(f"phase {'4b' if name == 'medium' else '4d'}: one train step of {name}, card (kernels) "
        "vs CPU (plain versions), float32, TF32 off, dropout 0")
    model, aux = create_poem_model(cfg["MODEL"], device="cpu",
                                   generator=torch.Generator().manual_seed(1))
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
        trainer = Trainer(mdl, aux, cfg["TRAIN"], cfg["MODEL"]["LOSS"])
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
    if aux["parametric_output"]:
        # the pose and shape terms are there, and the leaves only this head has
        # (in the last block's group below) take gradients on both sides
        lost = {"loss_pose", "loss_shape"} - set(loss_err)
        leaves = [f"head.transformer.block_2.{m}.{p}" for m in ("mano_linear", "flat_verts")
                  for p in ("weight", "bias")]
        dead = [n for n in leaves for side in (cpu, card)
                if n not in side["grads"] or not bool(side["grads"][n].abs().max() > 0)]
        if lost or dead:
            raise AssertionError(f"{name}: loss terms missing {lost}, no gradient at {dead}")
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
    bound = GRAD_BOUND_PARAMETRIC if aux["parametric_output"] else GRAD_BOUND
    bad = {k: v for k, v in rel.items() if not v <= bound.get(k, bound["block"])}
    if bad:
        raise AssertionError(f"gradients differ: {bad}")
    # after clip + Adam: Adam's first update is -lr g / (|g| + 1e-8). Where the
    # CPU gradient is 100x the largest gradient disagreement of its tensor and
    # above 1e-4 (so 1e4 x Adam's eps), that is -lr sign(g) to 1e-4 on both
    # sides: such "firm" elements agree to 1e-3 of lr plus 2 float32 ulps of
    # the parameter (p - update rounds once on each side). Per module, the
    # change of the parameters is held to UPDATE_BOUND.
    lr = cfg["TRAIN"]["LR"]
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
    results["train_parity" if name == "medium" else f"train_parity_{name}"] = dict(
        loss_rel=loss_err, grad_rel=rel, update_rel=upd_rel, n_flip=n_flip)


def _probe_loss(trainer, batch, draws):
    """The train-mode loss of ``batch`` under fixed noise: the same reference
    jitter and, by the seed, the same dropout masks at every call."""
    torch.manual_seed(1234)
    trainer.model.train()
    with torch.no_grad():
        preds = trainer.model(batch["image"], batch["view_mask"], batch["cam_intr"],
                              batch["cam_extr"], batch["master_joints_3d"], ref_draws=draws)
        return float(trainer.loss_fn(preds, batch)[0])


def phase_train_tiers(results, names=("small", "medium_MANO", "large", "huge"), warmup=2,
                      timed=4, more=6):
    """Phase 4c: the train step of the other released tiers on phase 4a's batch:
    ``warmup`` + ``timed`` steps, then ``more`` untimed ones before the loss under
    fixed noise is read again. Twelve steps, not six: at lr 1e-4 on one batch the
    step-to-step noise of large is as large as six steps' progress (with its own
    seed its loss under fixed noise read 0.3139 before, 0.4702 after two steps,
    0.3292 after six and 0.2633 after twelve: ``scripts/torch_train_probe.py``,
    NVIDIA H100 80GB HBM3, 700 W)."""
    from poem_v2_tpu_torch.configs import RELEASE
    from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu_torch.models.poem import create_poem_model, draw_ref_noise
    from poem_v2_tpu_torch.training.trainer import Trainer

    log(f"phase 4c: train {', '.join(names)} (f32 params, bf16 compute, remat) on phase 4a's "
        f"batch, {warmup} warm-up + {timed} timed + {more} more steps")
    card = gpu_line()
    raw = SyntheticMultiviewDataset(batch_size=8, view_max=8, view_range=(1, 8), image_size=256,
                                    seed=3).sample_batch()
    probe_draws = draw_ref_noise(torch.Generator().manual_seed(11), 8)
    tiers = {}
    for name in names:
        cfg = RELEASE[name]
        for bs in (8, 4, 2, 1):
            model, aux = create_poem_model(cfg["MODEL"], dtype=torch.bfloat16,
                                           param_dtype=torch.float32, device="cuda",
                                           generator=torch.Generator().manual_seed(0))
            trainer = Trainer(model, aux, cfg["TRAIN"], cfg["MODEL"]["LOSS"])
            batch = trainer.to_device({k: v[:bs] for k, v in raw.items()})
            draws = tuple(d[:bs] if d.shape[0] == 8 else d for d in probe_draws)
            fits = True
            try:
                first = _probe_loss(trainer, batch, draws)
                metrics, events = [], []
                for i in range(warmup + timed + more):
                    if i == warmup:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                    reset_launches()
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    metrics.append(trainer.step(batch))
                    end.record()
                    events.append((start, end))
                    if read_launches() != LAUNCHES_PER_TRAIN_STEP:
                        raise AssertionError(f"{name}: launches per train step "
                                             f"{read_launches()} != {LAUNCHES_PER_TRAIN_STEP}")
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                # the one failure this phase answers: a batch that does not fit is halved,
                # and the batch that ran is printed; widths and depth never change
                fits = False
            if fits:
                break
            log(f"  {name}: batch {bs} does not fit in the card's memory, halving it")
            del model, trainer, batch
            gc.collect()
            torch.cuda.empty_cache()
        else:
            raise AssertionError(f"{name}: no batch size fits in the card's memory")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        last = _probe_loss(trainer, batch, draws)
        times = [s.elapsed_time(e) for s, e in events]
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        if not all(math.isfinite(x) for x in losses + norms + [first, last]):
            raise AssertionError(f"{name}: non-finite loss or grad norm: {losses}, {norms}")
        if aux["parametric_output"] != ("loss_pose" in metrics[0]):
            raise AssertionError(f"{name}: loss_pose among the terms: {'loss_pose' in metrics[0]}")
        # the steps' own losses carry fresh dropout masks and jitter each; the loss
        # under fixed noise must fall over the steps
        if not last < first:
            raise AssertionError(f"{name}: loss under fixed noise did not fall over "
                                 f"{warmup + timed + more} steps: {first} -> {last}")
        med = float(np.median(times[warmup:warmup + timed]))
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  {name} B{bs} [{card}]: {n_params / 1e6:.2f} M parameters, median step "
            f"{med:.2f} ms ({', '.join(f'{t:.1f}' for t in times)}), {bs * 1e3 / med:.2f} "
            f"samples/s, peak device memory {peak:.2f} GiB; loss "
            f"{', '.join(f'{x:.4f}' for x in losses)} (last below first: "
            f"{losses[-1] < losses[0]}); under fixed noise {first:.4f} -> {last:.4f}; grad norm "
            f"{', '.join(f'{x:.3f}' for x in norms)}; launches per step as the table")
        tiers[name] = dict(batch=bs, median_ms=med, runs_ms=times, samples_per_s=bs * 1e3 / med,
                           peak_gib=peak, losses=losses, probe=(first, last))
        del model, trainer, batch
        torch.cuda.empty_cache()
    results["train_tiers"] = tiers


def _launch_counts(**counts):
    """A launch count for every kernel: the given ones, the others 0."""
    return {k: counts.get(k, 0) for k in KERNELS}


# launches of the synthetic ResNet-18 model (2 decoder blocks, every config of
# configs/synthetic_*.yaml): per eval forward, two dense attentions a block, K2
# twice in block 0, K1 twice in block 1, K4 once (K5 once more on a batch whose
# samples do not all use every view); per train step K3 / K3b in both blocks,
# K6 (its forward K1) / K6b / K7 in block 1
LAUNCHES_PER_SYNTHETIC_FORWARD = _launch_counts(
    dense_cross_attention=4, fused_anchor_vector_attention=2, fused_knn_vector_attention=2,
    grid_sample_points_fused=1)
LAUNCHES_PER_SYNTHETIC_TRAIN_STEP = _launch_counts(
    dense_cross_attention=4, dense_cross_attention_bwd=4, fused_knn_vector_attention=2,
    knn_vector_attention_trainable=2, knn_vector_attention_trainable_bwd=2, scatter_add_rows=2)


def _mixed_batches(data_cfg, batch_size, view_max, epoch_size):
    """Batches of the dataset ``data_cfg`` (drawn here on the host from its seed)
    whose samples do not all use ``view_max`` views: each runs K5 once in eval."""
    from poem_v2_tpu_torch.data import batch_iterator, create_dataset

    ds = create_dataset(data_cfg)
    return sum(int((b["view_mask"].sum(1) != view_max).any())
               for b in batch_iterator(ds, batch_size, view_max, epoch_size))


def _expected(steps, forwards, mixed, per_step, per_forward):
    return {k: steps * per_step[k] + forwards * per_forward[k]
            + (mixed if k == "scrambled_merge_gather" else 0) for k in KERNELS}


def _drive_cli(fn, cfg_dict, argv, timing=None):
    """One run of a CLI's body (``train`` or ``evaluate``) on ``cfg_dict`` with the
    command line ``argv``, the launch counts set to 0 before it and read after.
    Returns (its result, launches, seconds on the host clock, peak GiB on the card)."""
    from poem_v2_tpu_torch.cli.opt import parse_exp_args
    from poem_v2_tpu_torch.utils.config import get_config

    args = parse_exp_args(["-c", "<dict>", "--exp_id", "default", *argv])
    cfg = get_config(cfg_dict, arg=args, merge=True)
    on_card = args.device.startswith("cuda")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    res = fn(cfg, args, timing) if timing is not None else fn(cfg, args)
    if on_card:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    return res, read_launches(), secs, peak


def _check_measures(name, results):
    """Finite measures in metres: mean errors of a random or briefly trained model
    lie between 0 and a metre (millimetres would read tens), AUCs in [0, 1]."""
    bad = {k: v for k, v in results.items()
           if not (math.isfinite(v) and (0.0 <= v <= 1.0 if k.startswith("auc")
                                         else 0.0 < v < 1.0))}
    if bad:
        raise AssertionError(f"{name}: measures not finite metres: {bad}")


def _check_launches(name, got, want):
    log(f"  {name} launches: " + ", ".join(f"{k} {v}" for k, v in got.items() if v))
    if got != want:
        raise AssertionError(f"{name}: launches {got} != {want}")


def _train_summary(name, run, secs, peak, batch, card, warmup=2):
    ms = run["step_ms"][warmup:] or run["step_ms"]
    med = float(np.median(ms))
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"{name}: non-finite losses {run['losses']}")
    ck = run["checkpoint"]
    log(f"  {name} [{card}]: {len(run['losses'])} steps in {secs:.2f} s (model build, data and "
        f"validation included); step ms (CUDA events) median {med:.2f} over steps "
        f"{warmup + 1}-{len(run['step_ms'])} ({', '.join(f'{t:.1f}' for t in run['step_ms'])}), "
        f"{batch * 1e3 / med:.2f} samples/s; peak {peak:.2f} GiB; checkpoint "
        f"{ck['bytes']} bytes written in {ck['write_s']:.3f} s; loss "
        f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}")
    return dict(steps=len(run["losses"]), seconds=secs, median_step_ms=med,
                step_ms=run["step_ms"], samples_per_s=batch * 1e3 / med, peak_gib=peak,
                ckpt_bytes=ck["bytes"], ckpt_write_s=ck["write_s"], losses=run["losses"],
                val=run["val"])


def phase_front_doors(results, device="cuda", dtype="bf16", smoke_epoch=64, medium_model=None,
                      medium_image=256, medium_views=8, medium_batch=8, medium_train=32,
                      medium_test=16):
    """Phase 5: the port's train and eval CLIs (their ``train`` / ``evaluate``
    bodies on config dicts, as ``python -m poem_v2_tpu_torch.cli.train`` runs them)
    on the synthetic ResNet-18 model (``smoke_epoch`` samples an epoch) and on
    medium (``medium_model``) with synthetic data, in a temporary directory
    (their ``exp/`` goes there). A rehearsal on the CPU passes small ones."""
    import copy
    import os
    import tempfile

    from poem_v2_tpu_torch.cli import eval as eval_cli, train as train_cli
    from poem_v2_tpu_torch.configs import MEDIUM, SYNTHETIC_SMOKE

    log("phase 5: the train and eval CLIs: synthetic_smoke (ResNet-18, width 64, 4 heads of "
        "16), a resumed run, and medium with synthetic data")
    card = gpu_line()
    out = {}
    cwd = os.getcwd()
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # (a) synthetic_smoke as shipped: one epoch of 16 steps at B4 from the
            # streaming feed, validation on 4 batches, a checkpoint
            smoke = copy.deepcopy(SYNTHETIC_SMOKE)
            smoke["DATASET"]["TRAIN"]["EPOCH_SIZE"] = smoke_epoch
            spe = smoke_epoch // 4  # steps an epoch
            argv = ["--view_max", "2", "-b", "4", "--device", device, "--dtype", dtype]
            run, got, secs, peak = _drive_cli(train_cli.train, smoke, argv)
            test = smoke["DATASET"]["TEST"]
            mixed = _mixed_batches(test, 4, 2, test["EPOCH_SIZE"])
            n_val = test["EPOCH_SIZE"] // 4
            _check_launches("synthetic train CLI", got, _expected(
                spe, n_val, mixed, LAUNCHES_PER_SYNTHETIC_TRAIN_STEP,
                LAUNCHES_PER_SYNTHETIC_FORWARD))
            _check_measures("synthetic validation", run["val"][0])
            out["synthetic_train"] = dict(_train_summary("synthetic_smoke train", run, secs,
                                                         peak, 4, card),
                                          launches=got, mixed_val_batches=mixed)
            if device.startswith("cuda"):  # where the step's time goes: one more, profiled
                from poem_v2_tpu_torch.data import batch_iterator, create_dataset

                sample = next(iter(batch_iterator(create_dataset(smoke["DATASET"]["TRAIN"]), 4,
                                                  2, 4)))
                out["synthetic_train"]["profile"] = profile_train_step(
                    run["trainer"], run["trainer"].to_device(sample),
                    out["synthetic_train"]["median_step_ms"])
            smoke_ckpt = run["checkpoint"]["path"]

            # (b) resume: smoke on fixed train and test sets, two epochs uninterrupted,
            # then again from the first epoch's snapshot
            fixed = copy.deepcopy(smoke)
            fixed["TRAIN"]["EPOCH"] = 2
            for part in ("TRAIN", "TEST"):
                fixed["DATASET"][part]["FIXED_SET"] = True
            whole, _, _, _ = _drive_cli(train_cli.train, fixed, argv)
            snap = os.path.join(whole["dump_path"], "checkpoints", "checkpoint_1.pt")
            again, _, secs_r, _ = _drive_cli(train_cli.train, fixed, argv + ["--resume", snap])
            rs_, rsd = again["resumed"], whole["losses"][spe:]
            if (again["start_epoch"], rs_["step"], rs_["epoch"],
                    again["trainer"].global_step) != (1, spe, 0, 2 * spe):
                raise AssertionError(f"resume: epoch {again['start_epoch']}, step {rs_['step']}, "
                                     f"checkpoint epoch {rs_['epoch']}, final step "
                                     f"{again['trainer'].global_step}")
            rel = [abs(a - b) / abs(b) for a, b in zip(again["losses"], rsd)]
            log(f"  resumed from {os.path.basename(snap)} (read in {rs_['read_s']:.3f} s) at step "
                f"{spe}, epoch 1: next loss {again['losses'][0]!r} vs uninterrupted {rsd[0]!r} "
                f"(bit-equal: {again['losses'][0] == rsd[0]}); the epoch's {spe} losses differ by "
                f"at most {max(rel):.2e} relative")
            if not rel[0] <= 1e-6:
                raise AssertionError(f"resume: next loss {again['losses'][0]} != {rsd[0]}")
            out["resume"] = dict(next_loss=again["losses"][0], uninterrupted=rsd[0],
                                 max_rel_diff_epoch=max(rel), read_s=rs_["read_s"])

            # (c) the eval CLI on (a)'s checkpoint with AUC
            timing = {}
            res, got, secs, peak = _drive_cli(
                eval_cli.evaluate, smoke, argv + ["--eval_extra", "auc", "--reload", smoke_ckpt],
                timing)
            _check_launches("synthetic eval CLI", got, _expected(
                0, n_val, mixed, LAUNCHES_PER_SYNTHETIC_TRAIN_STEP,
                LAUNCHES_PER_SYNTHETIC_FORWARD))
            _check_measures("synthetic eval", res)
            log(f"  synthetic eval CLI [{card}]: {timing['samples']} samples, "
                f"{timing['samples'] / timing['seconds']:.1f} samples/s (data drawn on the host "
                f"included); peak {peak:.2f} GiB; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in res.items()))
            out["synthetic_eval"] = dict(results=res, samples_per_s=timing["samples"]
                                         / timing["seconds"], peak_gib=peak, launches=got)

            # (d) medium (HRNet-W40, width 256, 4096 BPS points) on synthetic 256 px data,
            # 1-8 valid views of 8: 4 train steps at B8, validation on 2 batches, then
            # the eval CLI on its checkpoint
            V, Bm = medium_views, medium_batch
            data = {"TYPE": "Synthetic", "VIEW_MAX": V, "VIEW_RANGE": [1, V],
                    "IMAGE_SIZE": medium_image, "EPOCH_SIZE": medium_train}
            medium = copy.deepcopy(MEDIUM)
            medium["MODEL"] = copy.deepcopy(medium_model or MEDIUM["MODEL"])
            medium["TRAIN"]["EPOCH"] = 1
            medium["DATA_PRESET"]["IMAGE_SIZE"] = [medium_image, medium_image]
            medium["DATASET"] = {"TRAIN": data, "TEST": dict(data, EPOCH_SIZE=medium_test)}
            argv_m = ["--view_max", str(V), "-b", str(Bm), "--device", device, "--dtype", dtype]
            run, got, secs, peak = _drive_cli(train_cli.train, medium, argv_m)
            mixed_m = _mixed_batches(medium["DATASET"]["TEST"], Bm, V, medium_test)
            _check_launches("medium train CLI", got, _expected(
                medium_train // Bm, medium_test // Bm, mixed_m, LAUNCHES_PER_TRAIN_STEP,
                LAUNCHES_PER_FORWARD))
            _check_measures("medium validation", run["val"][0])
            out["medium_train"] = dict(_train_summary("medium train", run, secs, peak, Bm, card,
                                                      warmup=1),
                                       launches=got, mixed_val_batches=mixed_m)
            timing = {}
            res, got, secs, peak = _drive_cli(
                eval_cli.evaluate, medium,
                argv_m + ["--eval_extra", "auc", "--reload", run["checkpoint"]["path"]], timing)
            _check_launches("medium eval CLI", got, _expected(
                0, medium_test // Bm, mixed_m, LAUNCHES_PER_TRAIN_STEP, LAUNCHES_PER_FORWARD))
            _check_measures("medium eval", res)
            log(f"  medium eval CLI [{card}]: {timing['samples']} samples, "
                f"{timing['samples'] / timing['seconds']:.1f} samples/s (data drawn on the host "
                f"included); peak {peak:.2f} GiB; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in res.items()))
            out["medium_eval"] = dict(results=res, samples_per_s=timing["samples"]
                                      / timing["seconds"], peak_gib=peak, launches=got)
        finally:
            os.chdir(cwd)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    results["front_doors"] = out
    return out


# phase 6: the data-parallel step against the single-process one (loss terms
# relative, gradients per module relative to the module's largest). Float32 on
# one card, summed in other orders (B4 + B4 against B8); the float32 HRNet-W40
# backward at random weights keeps phase 4b's bound (ROADMAP queue 3)
DDP_LOSS_RTOL = 1e-5
DDP_GRAD_BOUND = {"backbone": 3e-2, "other": 1e-4}
# launches per train step of every tier with --no-flash_train: the einsum attention
# and the gathered KNN neighbourhoods run no kernel forward; the backward of each
# gathered bfloat16 block (self and cross attention of blocks 1 and 2) is K7
LAUNCHES_PER_NO_FLASH_STEP = _launch_counts(scatter_add_rows=4)
# the kernels the flash train step runs, each of which must launch on the DDP path
TRAIN_PATH_KERNELS = [k for k, n in LAUNCHES_PER_TRAIN_STEP.items() if n]


def _train_model(model_cfg, device, dtype, dropout=None, use_flash_train=True, state=None):
    """A POEMNet of ``model_cfg`` with float32 parameters computing in ``dtype``,
    weights from seed 0 or ``state``, ``dropout`` overriding the config's."""
    import copy

    from poem_v2_tpu_torch.models.poem import create_poem_model

    cfg = copy.deepcopy(model_cfg)
    if dropout is not None:
        cfg["HEAD"]["TRANSFORMER"]["DROPOUT"] = dropout
    model, aux = create_poem_model(cfg, dtype=dtype, param_dtype=torch.float32, device=device,
                                   generator=torch.Generator().manual_seed(0),
                                   use_flash_train=use_flash_train)
    if state is not None:
        model.load_state_dict(state)
    return model, aux


def _record_step(trainer, raw):
    """One ``Trainer.step`` on the global host batch ``raw``: the metrics, the
    gradients as the step left them before clipping (DDP's average under data
    parallel), the parameters after the update (both on the CPU) and the launches,
    counted from 0 around the step."""
    grads = {}
    step = trainer.optimizer.step

    def keep():
        grads.update({k: p.grad.detach().cpu().clone() for k, p in
                      trainer.model.named_parameters() if p.grad is not None})
        step()

    trainer.optimizer.step = keep
    reset_launches()
    try:
        metrics = {k: float(v) for k, v in trainer.step(raw).items()}
    finally:
        trainer.optimizer.step = step
    launches = read_launches()
    return dict(metrics=metrics, grads=grads, launches=launches,
                params={k: p.detach().cpu().clone() for k, p in trainer.model.named_parameters()})


def _same_bits(name, got, want):
    """Raise unless two recorded steps are identical bit for bit."""
    bad = [k for k in want["metrics"] if got["metrics"][k] != want["metrics"][k]]
    bad += [f"grad {k}" for k in want["grads"]
            if k not in got["grads"] or not torch.equal(got["grads"][k], want["grads"][k])]
    bad += [f"param {k}" for k in want["params"] if not torch.equal(got["params"][k],
                                                                     want["params"][k])]
    log(f"  {name}: {len(want['metrics'])} metrics, {len(want['grads'])} gradients and "
        f"{len(want['params'])} parameters compared bit for bit, {len(bad)} differ")
    if bad or set(got["grads"]) != set(want["grads"]):
        raise AssertionError(f"{name}: not bit-identical: {bad[:10]}")


def _hold_step(name, got, want, card):
    """Raise unless ``got``'s loss terms are within DDP_LOSS_RTOL of ``want``'s and its
    gradients per module within DDP_GRAD_BOUND of the module's largest; every
    reading is logged beside its bound."""
    loss = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
            for k, v in want["metrics"].items()}
    groups = {}
    for k, w in want["grads"].items():
        g = got["grads"].get(k, torch.zeros_like(w))
        err, scale = groups.get(_module_group(k), (0.0, 0.0))
        groups[_module_group(k)] = (max(err, float((g - w).abs().max())),
                                    max(scale, float(w.abs().max())))
    rel = {k: (e / s if s > 0 else (0.0 if e == 0 else math.inf)) for k, (e, s) in groups.items()}
    bound = lambda k: DDP_GRAD_BOUND.get(k, DDP_GRAD_BOUND["other"])
    log(f"  {name} [{card}]: loss terms |got - want| / |want| (bound {DDP_LOSS_RTOL:.0e}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in loss.items()))
    log(f"  {name}: gradients max |dgrad| / max |grad| per module (bound): "
        + ", ".join(f"{k} {v:.2e} ({bound(k):.0e})" for k, v in rel.items()))
    bad = {k: v for k, v in loss.items() if not v <= DDP_LOSS_RTOL}
    bad.update({k: v for k, v in rel.items() if not v <= bound(k)})
    if bad or set(got["grads"]) - set(want["grads"]):
        raise AssertionError(f"{name}: over the bounds: {bad}")
    return dict(loss_rel=loss, grad_rel=rel)


def _step_ms(trainer, raw, n):
    """Milliseconds of ``n`` train steps, each between CUDA events (host clock on the CPU)."""
    out = []
    for _ in range(n):
        if trainer.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            trainer.step(raw)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            trainer.step(raw)
            out.append((time.perf_counter() - t) * 1e3)
    return out


def _time_in_turns(trainers, raw, batch, card, warmup=2, timed=3, rounds=2):
    """Steps of each named Trainer in turns (``rounds`` x ``timed`` each, after
    ``warmup``): the median ms / step, samples/s and peak GiB of each, logged."""
    on_card = next(iter(trainers.values())).device.type == "cuda"
    times = {name: [] for name in trainers}
    peaks = dict.fromkeys(trainers, 0.0)
    for name, tr in trainers.items():
        _step_ms(tr, raw, warmup)
    for _ in range(rounds):
        for name, tr in trainers.items():
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            times[name] += _step_ms(tr, raw, timed)
            if on_card:
                peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 2 ** 30)
    out = {}
    for name, ts in times.items():
        med = float(np.median(ts))
        out[name] = dict(median_ms=med, runs_ms=ts, samples_per_s=batch * 1e3 / med,
                         peak_gib=peaks[name])
        log(f"  {name} [{card}]: median step {med:.2f} ms ({', '.join(f'{t:.1f}' for t in ts)}),"
            f" {batch * 1e3 / med:.2f} samples/s, peak device memory {peaks[name]:.2f} GiB")
    return out


def _spawn_ranks(spec, world, tmp, timeout=600):
    """``world`` gloo rank processes of ``ddp_worker`` on ``spec``; their results."""
    import os

    inp = os.path.join(tmp, "ddp_in.pt")
    torch.save(spec, inp)
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-worker", str(r), str(world),
                 os.path.join(tmp, "rdzv"), inp, os.path.join(tmp, f"ddp_out{r}.pt")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} failed:\n{text[-4000:]}")
    return [torch.load(os.path.join(tmp, f"ddp_out{r}.pt"), weights_only=False)
            for r in range(world)]


def ddp_worker(rank, world, rendezvous, inp, out):
    """One rank of phase 6a's gloo run: the Trainer's DDP step on its rows of the
    global batch, on the device of the spec (all ranks on one card)."""
    import torch.distributed as dist

    from poem_v2_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(inp, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=int(rank),
                            world_size=int(world))
    try:
        model, aux = _train_model(spec["model_cfg"], spec["device"], torch.float32,
                                  state=spec["state"])
        trainer = Trainer(model, aux, spec["train_cfg"], spec["model_cfg"]["LOSS"])
        res = _record_step(trainer, spec["batch"])
    finally:
        dist.destroy_process_group()
    torch.save(res, out)


def phase_ddp(results, device="cuda", model_cfg=None, image=256, views=8, batch=8,
              timing_dtype=torch.bfloat16, warmup=2, timed=3, rounds=2):
    """Phase 6a: the Trainer under ``torch.distributed`` at medium's full width
    (``model_cfg``: a rehearsal on the CPU passes a small one). World size 1 over
    NCCL (gloo on the CPU) against the single-process step, bit for bit in
    float32 with deterministic algorithms, then both timed in ``timing_dtype``;
    two gloo ranks of B/2 against the single-process B step in float32 at dropout
    0. Returns the DDP step's launches per step."""
    import copy
    import os
    import tempfile
    import warnings

    import torch.distributed as dist

    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu_torch.training.trainer import Trainer

    model_cfg = model_cfg or MEDIUM["MODEL"]
    train_cfg = MEDIUM["TRAIN"]
    on_card = device == "cuda"
    card = gpu_line()
    log(f"phase 6a: data parallel (DistributedDataParallel), B{batch}, {views} views at "
        f"{image} px: world 1 over {'NCCL' if on_card else 'gloo'} and 2 gloo ranks on one "
        f"{'card' if on_card else 'CPU'} against the single-process step")
    raw = SyntheticMultiviewDataset(batch_size=batch, view_max=views, view_range=(1, views),
                                    image_size=image, seed=3).sample_batch()
    base, _ = _train_model(model_cfg, "cpu", torch.float32)
    state = base.state_dict()
    del base
    out = {}
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled())
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # (i) world 1 against the single process, float32, bit for bit: deterministic
            # convolutions and every op's deterministic algorithm (the gathers' backward
            # scatters would sum in a racing order otherwise). A Trainer built outside
            # the process group steps as a single process; one built inside it wraps
            # the model in DDP
            backend = "nccl" if on_card else "gloo"
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
            torch.use_deterministic_algorithms(True, warn_only=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                model, aux = _train_model(model_cfg, device, torch.float32, state=state)
                single = _record_step(Trainer(model, aux, train_cfg, model_cfg["LOSS"]), raw)
                del model
                dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv1", rank=0,
                                        world_size=1)
                model, aux = _train_model(model_cfg, device, torch.float32, state=state)
                trainer = Trainer(model, aux, train_cfg, model_cfg["LOSS"])
                if not isinstance(trainer.net, torch.nn.parallel.DistributedDataParallel):
                    raise AssertionError("the Trainer in a process group runs no DDP")
                world1 = _record_step(trainer, raw)
                del model, trainer
            dist.destroy_process_group()
            notes = sorted({str(w.message).splitlines()[0][:120] for w in caught})
            if notes:
                log("  warnings in the float32 steps: " + " | ".join(notes))
            _same_bits("DDP world 1 vs single process (float32)", world1, single)
            _check_launches("DDP world 1 step (float32)", world1["launches"], single["launches"])
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det[:2]
            torch.use_deterministic_algorithms(det[2])

            # (ii) both timed in turns in timing_dtype; the DDP step's launches
            trainers = {"single process": Trainer(
                *_train_model(model_cfg, device, timing_dtype, state=state), train_cfg,
                model_cfg["LOSS"])}
            dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv2", rank=0,
                                    world_size=1)
            trainers["DDP world 1"] = Trainer(
                *_train_model(model_cfg, device, timing_dtype, state=state), train_cfg,
                model_cfg["LOSS"])
            out["timing"] = _time_in_turns(trainers, raw, batch, card, warmup, timed, rounds)
            if on_card:  # one more step of each under the profiler: device busy and idle
                out["profile"] = {}
                for name, tr in trainers.items():
                    log(f"  {name}, profiled:")
                    out["profile"][name] = profile_train_step(
                        tr, tr.to_device(raw), out["timing"][name]["median_ms"])
            ddp_launches = _record_step(trainers["DDP world 1"], raw)["launches"]
            single_launches = _record_step(trainers["single process"], raw)["launches"]
            _check_launches("DDP world 1 step", ddp_launches, single_launches)
            quiet = [k for k in TRAIN_PATH_KERNELS if on_card and not ddp_launches[k]]
            if quiet:
                raise AssertionError(f"kernels the DDP step did not launch: {quiet}")
            del trainers
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det[:2]
            torch.use_deterministic_algorithms(det[2])
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # (iii) two gloo ranks of B/2 against the single process's B, float32, dropout 0
        model, aux = _train_model(model_cfg, device, torch.float32, dropout=0.0, state=state)
        want = _record_step(Trainer(model, aux, train_cfg, model_cfg["LOSS"]), raw)
        del model
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        cfg0 = copy.deepcopy(model_cfg)
        cfg0["HEAD"]["TRANSFORMER"]["DROPOUT"] = 0.0
        t = time.perf_counter()
        ranks = _spawn_ranks(dict(model_cfg=cfg0, train_cfg=train_cfg, state=state, batch=raw,
                                  device=device), 2, tmp)
        log(f"  two gloo ranks ran in {time.perf_counter() - t:.1f} s (process start, build "
            "and one step each)")
        _same_bits("rank 1 vs rank 0", ranks[1], ranks[0])
        out["world2"] = _hold_step(f"2 gloo ranks of B{batch // 2} vs single process B{batch}",
                                   ranks[0], want, card)
    out["launches"] = ddp_launches
    results["ddp"] = out
    return ddp_launches


def phase_no_flash(results, device="cuda", model_cfg=None, image=256, views=8, batch=8,
                   timing_dtype=torch.bfloat16, warmup=2, timed=3, rounds=2):
    """Phase 6b: the --no-flash_train step (einsum attention with probability
    dropout, gathered KNN whose bfloat16 backward is K7) at medium's full width:
    at dropout 0 in float32 against the flash step on the same batch and
    weights, with phase 6a's bounds; its launches; its step timed beside the
    flash one in ``timing_dtype``. Returns its launches per step."""
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
    from poem_v2_tpu_torch.training.trainer import Trainer

    model_cfg = model_cfg or MEDIUM["MODEL"]
    train_cfg = MEDIUM["TRAIN"]
    card = gpu_line()
    log(f"phase 6b: the --no-flash_train step, B{batch}, {views} views at {image} px")
    raw = SyntheticMultiviewDataset(batch_size=batch, view_max=views, view_range=(1, views),
                                    image_size=image, seed=3).sample_batch()
    base, _ = _train_model(model_cfg, "cpu", torch.float32)
    state = base.state_dict()
    del base
    # K6 selects by K1's packed keys, which break distance ties within 2**-11
    # relative by the lowest index; the gathered path selects exactly, as the
    # JAX package's does. At the same neighbours the two steps are one function:
    # the no-flash step is held to the flash one with its gathered path fed K1's
    # selection, then read as shipped beside it, with the share of query rows
    # whose neighbours differ
    import poem_v2_tpu_torch.models.bricks.point_transformer as tpt
    from poem_v2_tpu_torch.ops.knn_attn import knn_select
    from poem_v2_tpu_torch.ops.points import index_points

    exact = tpt.knn_points
    rows = [0, 0]

    def k1_selection(query, points, k):
        idx = knn_select(query, points, k).long()
        return None, idx, index_points(points, idx)

    def counting(query, points, k):
        d2, idx, nn_xyz = exact(query, points, k)
        k1 = knn_select(query, points, k).long()
        rows[0] += int((idx.sort(-1).values != k1.sort(-1).values).any(-1).sum())
        rows[1] += idx.shape[0] * idx.shape[1]
        return d2, idx, nn_xyz

    steps = {}
    for name, flash, select in (("flash", True, exact), ("k1", False, k1_selection),
                                ("exact", False, counting)):
        model, aux = _train_model(model_cfg, device, torch.float32, dropout=0.0,
                                  use_flash_train=flash, state=state)
        tpt.knn_points = select
        try:
            steps[name] = _record_step(Trainer(model, aux, train_cfg, model_cfg["LOSS"]), raw)
        finally:
            tpt.knn_points = exact
        del model
        gc.collect()
    out = {"float32": _hold_step("no-flash step at K1's neighbours vs flash step (float32, "
                                 "dropout 0)", steps["k1"], steps["flash"], card)}
    loss = {k: abs(steps["exact"]["metrics"][k] - v) / max(abs(v), 1e-12)
            for k, v in steps["flash"]["metrics"].items()}
    log(f"  the no-flash step as shipped (exact neighbours): {rows[0]} of {rows[1]} query rows "
        "select other neighbours than K1; loss terms vs the flash step: "
        + ", ".join(f"{k} {v:.2e}" for k, v in loss.items()))
    out["exact_selection"] = dict(rows_differing=rows[0], rows=rows[1], loss_rel=loss)
    trainers = {}
    for name, flash in (("flash step", True), ("no-flash step", False)):
        model, aux = _train_model(model_cfg, device, timing_dtype, use_flash_train=flash,
                                  state=state)
        trainers[name] = Trainer(model, aux, train_cfg, model_cfg["LOSS"])
    launches = _record_step(trainers["no-flash step"], raw)["launches"]
    _check_launches("no-flash step", launches, LAUNCHES_PER_NO_FLASH_STEP)
    out["timing"] = _time_in_turns(trainers, raw, batch, card, warmup, timed, rounds)
    out["launches"] = launches
    del trainers
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    results["no_flash"] = out
    return launches


def phase_reference_checkpoint(results, device="cuda", model_cfg=None, arch="HRNet", image=256,
                               batch=4, views=8):
    """Phase 6c: medium's random weights (``NORM: frozen_bn``) written under the
    reference names by the table of ``convert_reference.py``, converted back by
    ``scripts/torch_convert_checkpoint.py`` and served by
    ``Predictor.from_config(ckpt_path=)``: its B``batch`` mixed-view forward equals
    the source model's bit for bit, and K1-K5 launch in it."""
    import copy
    import importlib.util
    import os
    import tempfile

    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.convert_reference import to_reference
    from poem_v2_tpu_torch.models.poem import create_poem_model
    from poem_v2_tpu_torch.serving.predictor import Predictor

    cfg = copy.deepcopy(MEDIUM)
    if model_cfg is not None:
        cfg["MODEL"] = copy.deepcopy(model_cfg)
    cfg["MODEL"]["BACKBONE"]["NORM"] = "frozen_bn"
    cfg["DATA_PRESET"]["IMAGE_SIZE"] = [image, image]
    log(f"phase 6c: a reference-named checkpoint of {arch} medium (frozen_bn) through "
        "scripts/torch_convert_checkpoint.py into Predictor.from_config(ckpt_path=)")
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    src, _ = create_poem_model(cfg["MODEL"], device="cpu", generator=torch.Generator().manual_seed(4))
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_convert_checkpoint.py")
    spec = importlib.util.spec_from_file_location("torch_convert_checkpoint", script)
    convert = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(convert)
    with tempfile.TemporaryDirectory() as tmp:
        ref = to_reference(src.state_dict(), arch)
        torch.save({"state_dict": {f"module.{k}": v for k, v in ref.items()}},
                   os.path.join(tmp, "released.pth.tar"))
        cfg_path = os.path.join(tmp, "train_medium.yaml")  # read by stem without PyYAML
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)  # JSON is YAML: PyYAML, where installed, reads it too
        conv = convert.main(["-c", cfg_path, "--torch-ckpt", os.path.join(tmp, "released.pth.tar"),
                             "--out", os.path.join(tmp, "port.pt")])
        if conv["leftover"] or conv["missing"]:
            raise AssertionError(f"conversion left {conv['leftover'][:5]}, missed "
                                 f"{conv['missing'][:5]}")
        pred = Predictor.from_config(cfg, ckpt_path=os.path.join(tmp, "port.pt"), dtype=dtype,
                                     device=device, view_bucket=views)
    source = Predictor(src.to(device=device, dtype=dtype), view_bucket=views, image_size=image)
    rs = np.random.RandomState(9)
    images, intr, extr = look_at_request(rs, batch, views, image)
    mask = mixed_view_mask(rs, batch, views)
    want = source(images, intr, extr, mask)
    reset_launches()
    got = pred(images, intr, extr, mask)
    launches = read_launches()
    same = {k: bool(np.array_equal(got[k], want[k])) for k in want}
    log(f"  {conv['converted']} tensors converted; served outputs bit-identical to the source "
        f"model's: {same}; launches {', '.join(f'{k} {v}' for k, v in launches.items() if v)}")
    if not all(same.values()):
        raise AssertionError(f"the converted checkpoint serves other outputs: {same}")
    quiet = [k for k, n in LAUNCHES_PER_MIXED_FORWARD.items() if n and not launches[k]]
    if device == "cuda" and quiet:
        raise AssertionError(f"kernels the served forward did not launch: {quiet}")
    results["reference_checkpoint"] = dict(converted=conv["converted"], launches=launches)
    return launches


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(*sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
