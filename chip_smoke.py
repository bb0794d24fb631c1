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
   views of 8x8 maps, K5 on a batch of 1 and 2 views; and the DLT (float32 only)
   at the main path's B1 and B16 of 8 views and 21 joints against its plain
   chain on the card (1e-5 m), call by call and from a CUDA graph, beside the
   plain chain's two times;
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
7. the data layer and ``eval_single`` (``poem_v2_tpu_torch/data``,
   ``cli/eval_single.py``): (a) the image codecs on the card: nvJPEG
   (``csrc/jpeg.cpp``) against OpenCV's decodes of the committed fixtures
   (``tests/torch_fixtures/codec``; max and mean absolute difference and the
   share of values that differ, held to each fixture's ``NVJPEG_LIMITS``, with
   three wrong decodes planted on nvJPEG's output beside them), the PNG
   decoder bit-exact and timed (Sub and Paeth rows), a q95 nvJPEG encode and
   decode of the source over ``JPEG_PSNR_FLOOR``; (b) the port's ShardDumper
   writes 64 samples of 8 views of 640x480 (a posed MANO hand, cameras around
   it; labels in the shard schema) as two shards of 32, encoding on the card; (c) ``build_eval_cfg("DexYCB",
   "medium", ...)`` on them with a checkpoint of medium's init weights written
   by the Recorder, through ``cli/eval.py:evaluate`` in bf16 at B8 with the
   protocol's random 2-8 views, ``WORKERS`` 0 and 4 (threads): samples/s,
   launches a batch (K1 4, K2 2, K3 6, K4 1, K5 between 1 and 1 a batch),
   every view decoded by nvJPEG, finite measures, peak GiB; the serial stages
   (decode and transform ms a view, collate and H2D ms a batch); the same loop
   profiled (device busy, idle share of that loop's own time) with its first
   batch equal to a direct model call bit for bit; 2 spawn workers (each its
   own CUDA context) against 2 threads over one shard.
8. the drawing path (``viztools``, the synthetic ``RENDER``, ``DrawingHandCallback``,
   ``cli/demo.py``, ``Predictor.warmup``): ``synthetic_overfit_gate`` as shipped
   (rendered views, B8, 8 of 8 views at 128 px, ResNet-18 GN, 2 blocks of width
   64) through ``cli/train.py:train`` for 16 steps and one validation, ms a step
   (CUDA events), one more step profiled (device busy, idle share), the host
   seconds that drew the rendered fixed set apart from the epochs', launches a
   step; ``cli/eval.py:evaluate`` with ``--eval_extra draw`` on 8 samples, every
   PNG decoded back by ``csrc/png.cc`` against the array written;
   ``synthetic_overfit_render`` and ``synthetic_overfit_gate_mano`` for 2 steps
   each and ``synthetic_overfit_gate_mano_800`` resumed from the latter's
   checkpoint; ``cli/demo.py`` on medium (random weights), B2 of 4 views, bf16
   (its warmup, the request's latency, its PNGs read back, 2 forwards' launches),
   and ``Predictor.warmup`` of buckets 1, 2, 4 and 8. K1, K2, K3, K3b, K4, K6,
   K6b and K7 must launch in this phase.
9. POEM's two last head options, ``HEAD.TRANSFORMER.TYPE: PtEmbedTRv3`` (the METRO
   + point-transformer decoder) and ``HEAD.PETR_EMBEDDING`` (the frustum
   embedding), on medium, then the v1 heads and METRO (phase 1f holds K3 at the
   METRO stage's 4895-token self-attention, head dims 256 / 64 / 16, and K1 at
   the 4096-point BPS self-attention against their plain versions first): (a)
   float32 card against CPU at B1 and B2 (8 and 5 of 8 views), PETR at 1e-4 m,
   PtEmbedTRv3's coarse mesh at 1e-5 m and its refinement at 1e-3 m through K1
   and 2e-4 m on the gathered path (why: ``phase_variant_parity``); (b)
   behind the Predictor in bf16, 8-view requests at B1 / B4 / B16 and a mixed
   2-8-view one at B4, median of 3, peak GiB, the launches of every forward
   (v3: K1 7, K3 12, K4 1, K5 on the mixed one); (c) through
   ``cli/train.py:train``, 4 epochs of one fixed synthetic 256 px batch (v3 at
   B2, PETR at B8), step ms (CUDA events), peak GiB, the run's launches, and the
   batch's loss under fixed noise, which must fall over 12 steps; (d) both v1
   heads at the JAX defaults on 8 views of 32 x 32 maps, float32 card against
   CPU block by block, within 5 times the CPU's own spread under a 1e-7 nudge of
   its input, and the bf16 forward timed; (e) ``create_metro_model`` float32 card against CPU and a bf16
   forward at B16 timed; (f) K3 at the METRO stage's shapes from a CUDA graph
   beside ``F.scaled_dot_product_attention``.
10. the multi-view baselines at the JAX defaults (``configs.BASELINES``: ResNet-34
   GN, embed 256, 6 layers, 256 px, 8 views): PETR, PETR with ``PETRHeadFTL`` and
   MVP, whose paths launch none of K1-K10 (masked einsum attention, the 4-tap
   gather, as in JAX; counted and recorded as ``baseline_launches``, not
   asserted, with 10d's METRO forwards, which run K3): (a) float32 card against the port's CPU forward at B2 of 8 and 5
   valid views, each level's coordinates within 5 times the CPU's own spread
   under a 1e-7 nudge of the images and at least 1e-6 m; (b) PETR's and MVP's
   weights under the reference's names through ``convert_reference.py`` and
   through ``convert.py`` from their flax layout: card forwards bit-identical to
   the source's; (c) bf16 autocast forwards at B1 / B4 / B16 of 8 views and a
   mixed 2-8-view B4 (CUDA events, median of 3), peak GiB, one training forward +
   backward at B4 with dropout, its time and peak; (d) METRO's weights through
   ``convert_metro_network`` and back, forward bit-identical.
11. the auxiliary family, which launches none of K1-K10 (counted as
   ``aux_launches``, not asserted): (a) CMR_G at full width (ResNet-18 trunks,
   OUT_CHANNELS (32, 64, 128, 256), attention on with its gamma set to 0.5), 256
   px, B4, float32 card against the port's CPU forward, all five outputs each
   within the larger of 1e-4 of its peak and 5 times the CPU's own spread under a
   1e-7 nudge of the images; (b) IntegralPose on ResNet-50 (3 deconvs of 256)
   with its 2D softmax head and a 3D head of 64 depth bins, DarkPose on ResNet-50
   with ``dark_decode`` of the card's heatmaps against the CPU's (1e-3 px, or a
   near-tie of the blurred map), HourglassBisected (256 features, depth 4) at B2,
   as (a); each of (a) and (b) also bf16 autocast forwards at B1 / B4 (CUDA events,
   median of 3) and peak GiB; (c) the MANO fitter: its objective's value and
   gradient at the identity init and at a random state, card against CPU (1e-5,
   1e-4 of each peak), tests/test_fit.py's scenario at B4 of 8 views (one frame
   with 4 padded), 400 steps at lr 5e-2 with the 3D term: the loss falls tenfold
   and the mean joint error ends under 1.5 cm, and one ``OneFrameFitSilh`` run at S
   64 (B2 of 4 views, 30 steps) whose silhouette loss falls; (d)
   ``knn_points_bucketed`` on the 4096-point BPS cloud for B8 x 799 queries, the
   same indices and distances as on the CPU, timed beside brute force.

The lines before the kernels line are JSON objects ``{"data": ...}`` with phase
7's readings, ``{"drawing": ...}`` with phase 8's, ``{"variants": ...}`` with
phase 9's, ``{"baselines": ...}`` with phase 10's and ``{"aux": ...}`` with phase 11's.
The second-to-last line is a JSON object with one entry per kernel (``ms``
call by call; K4's also ``graph_ms``, from phase 1e's CUDA graph, the DLT's
from phase 1's, with its plain chain's ``plain_graph_ms``; K1's and
K9's also their selections' times from phase 1e under ``selection``; K3's and
K3b's their head-dim-16 cases under ``head_dim_16``; every entry its launches
on phase 5's paths under ``front_door_launches``, on phase 7's under
``data_launches``, on phase 8's under ``viz_launches``, on phase 9's under
``variant_launches``, on phase 10's under ``baseline_launches``, on phase 11's
under ``aux_launches``; K3's and K1's
phase 1f cases under ``v3_shapes``, K3's phase 9f graph times under
``metro_stage_graph``); the last
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
                                   select, triangulate, vector_attn)

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
    # a jnp chain in the JAX package, no Pallas kernel; float32 only
    "triangulate_dlt_c2m": dict(
        source="poem_v2_tpu_torch/csrc/triangulate.cu",
        replaces="poem_v2_tpu/geometry/triangulation.py:83",
        wrapper=triangulate.triangulate_dlt_c2m),
}
# K9 and K10 are functions only, as in the JAX package: no model path runs them
NO_MODEL_PATH = {"fused_knn_vector_attention_bucketed": 0, "radix_select": 0}
# launches per serving forward of a 3-block model whose samples all have 8
# valid views (every tier has 3 blocks); a batch that mixes view counts adds K5.
# Every eval forward triangulates its reference joints once
LAUNCHES_PER_FORWARD = {
    "dense_cross_attention": 6, "fused_anchor_vector_attention": 2,
    "fused_knn_vector_attention": 4, "grid_sample_points_fused": 1,
    "dense_cross_attention_bwd": 0, "knn_vector_attention_trainable": 0,
    "knn_vector_attention_trainable_bwd": 0, "scatter_add_rows": 0, "scrambled_merge_gather": 0,
    "fused_vector_attention": 0, "triangulate_dlt_c2m": 1, **NO_MODEL_PATH,
}
LAUNCHES_PER_MIXED_FORWARD = {**LAUNCHES_PER_FORWARD, "scrambled_merge_gather": 1}
# launches per train step of every tier (3 blocks each): two attentions per
# block, forward and backward; K6 (whose forward runs K1) in the self and
# cross attention of blocks 1 and 2, each backward K6b, scattering by K7. The
# remat recompute replays no kernel. Block 0's anchors and the sampler take
# plain paths in training, so K2 and K4 do not run, nor K5 (the mixed batch
# takes the differentiable gather) nor K8. The train forward jitters the
# ground-truth joints and does not triangulate.
LAUNCHES_PER_TRAIN_STEP = {
    "dense_cross_attention": 6, "dense_cross_attention_bwd": 6,
    "fused_knn_vector_attention": 4, "knn_vector_attention_trainable": 4,
    "knn_vector_attention_trainable_bwd": 4, "scatter_add_rows": 4,
    "fused_anchor_vector_attention": 0, "grid_sample_points_fused": 0, "scrambled_merge_gather": 0,
    "fused_vector_attention": 0, "triangulate_dlt_c2m": 0, **NO_MODEL_PATH,
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


def variant_kernel_cases(rs: np.random.RandomState, B=2, M=799 + 4096, Hs=(1024, 256, 64),
                         N=4096, K=32, D=256):
    """The shapes only POEM's PtEmbedTRv3 decoder gives the kernels, named ``v3/...``:
    K3 as the METRO stage's self-attention over its M tokens (799 mesh + 4096 BPS
    points) at widths ``Hs`` in 4 heads (head dims 256, 64 and 16), and K1 as
    PtEmbedTRv2's self-attention over the N-point BPS cloud at K neighbours.
    Cases as :func:`kernel_cases` makes them, held to their plain versions on
    the card."""
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    cases = {}
    for H in Hs:
        cases[f"v3/dense_cross_attention/hd{H // 4}_M{M}"] = dict(
            kernel="dense_cross_attention", args=(f(B, M, H), f(B, M, H), f(B, M, H)),
            kw=dict(num_heads=4, sm_scale=1 / math.sqrt(H // 4)),
            plain=cross_attn.plain_dense_cross_attention, flops=4.0 * B * M * M * H,
            library=library_sdpa, plain_on_card=True, lse=True)
    cloud = _ball(rs, N)[None].expand(B, N, 3).contiguous()
    fcd, fcg = _mlps(f, D)
    cases[f"v3/fused_knn_vector_attention/self_N{N}_K{K}"] = dict(
        kernel="fused_knn_vector_attention",
        args=(f(B, N, D), cloud, cloud, f(B, N, D), f(D, D) / 16, f(D, D) / 16, fcd, fcg),
        kw=dict(n_neighbor=K, return_idx=True), plain=knn_attn.plain_fused_knn_vector_attention,
        flops=knn_attention_flops(B, N, K, N, D),
        flops_five=attention_flops(B * N * K, D, 5) + 8.0 * B * N * N, plain_on_card=True)
    return cases


def phase_variant_kernels(results, **shapes):
    """Phase 1f: the kernels at the PtEmbedTRv3 decoder's shapes, before any model runs."""
    log("phase 1f: kernels at the PtEmbedTRv3 decoder's shapes vs plain versions")
    run_kernel_cases(results, variant_kernel_cases(np.random.RandomState(20), **shapes))


def phase_kernels(results, synthetic=None, dlt_batches=(1, 16), **shapes):
    log("phase 1: kernels vs plain versions")
    rs = np.random.RandomState(0)
    cases = kernel_cases(rs, **shapes)
    cases.update(synthetic_kernel_cases(np.random.RandomState(10), **(synthetic or {})))
    run_kernel_cases(results, cases)
    run_dlt_cases(results, np.random.RandomState(30), dlt_batches)


# the DLT's float32 operations a (sample, joint) system: 156 a view (the rigid
# inverse 21, K P 72, the two rows 16, the mask 8, A^T A's upper triangle 40, less
# the negation), A^T A's four accumulators summed (30), 36 rotations of 88 each
# (16 for the angle, 72 for the rows and columns of A and V), the final division (4)
def dlt_flops(V: int) -> float:
    return 156.0 * V + 30 + 36 * 88 + 4


# the DLT against its plain chain on the card, metres, on rows of two or more valid
# views: a hundredth of a millimetre (both sides run the same float32 operations in
# the same order, so they have agreed bit for bit)
DLT_TOL = 1e-5


def run_dlt_cases(results, rs: np.random.RandomState, batches, V=8, J=21, size=256):
    """The DLT at the main path's shapes (B1 and B16 of 8 views, 21 joints; a B1
    rig of 8 valid views, a B16 batch of 2-8): the kernel against the plain chain
    (``triangulate_dlt`` on ``invert_rigid``) on the same card tensors, rows of 2+
    valid views to ``DLT_TOL``, timed call by call and from a CUDA graph (the plain
    chain's graph on ``rigid_inverse_rows``, the same rows without the blocking
    copy), float32 only, into ``results["triangulate_dlt_c2m/B<B>_V<V>"]``."""
    from poem_v2_tpu_torch.geometry.camera import (invert_rigid, project_world_to_pixel,
                                                   rigid_inverse_rows)
    from poem_v2_tpu_torch.geometry.triangulation import triangulate_dlt

    wrapper = KERNELS["triangulate_dlt_c2m"]["wrapper"]
    for B in batches:
        case = f"triangulate_dlt_c2m/B{B}_V{V}"
        _, intr, extr = look_at_request(rs, B, V, size)
        joints = (rs.randn(B, J, 3) * 0.04 + [0.0, 0.0, 0.5]).astype(np.float32)
        intr, extr = torch.from_numpy(intr), torch.from_numpy(extr)
        kp = project_world_to_pixel(torch.from_numpy(joints), extr, intr)
        kp = kp + torch.from_numpy(rs.randn(B, V, J, 2).astype(np.float32))
        mask = torch.from_numpy(mixed_view_mask(rs, B, V) if B > 1 else np.ones((1, V), bool))
        args = _to((kp, intr, extr, mask), "cuda")
        with torch.no_grad():
            got = wrapper(*args)
            want = triangulate_dlt(*args[:2], invert_rigid(args[2]), args[3])
            torch.cuda.synchronize()
            err = float((got - want).abs().max())  # every row has 2 or more valid views
            same = torch.equal(got, want)
            ok = bool(torch.isfinite(got).all()) and err <= DLT_TOL
            log(f"  {case} [float32] max_abs_err={err:.3e} m (tol {DLT_TOL:.0e}), bit-identical "
                f"to the plain chain on every row: {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{case}: max_abs_err {err} m > {DLT_TOL} or non-finite")
            ms = time_cuda(lambda: wrapper(*args))
            graph_ms = time_graph(lambda: wrapper(*args))
            plain_ms = time_cuda(lambda: triangulate_dlt(*args[:2], invert_rigid(args[2]),
                                                         args[3]), iters=3, warmup=1)
            plain_graph_ms = time_graph(lambda: triangulate_dlt(
                *args[:2], rigid_inverse_rows(args[2]), args[3]), iters=2)
        nbytes = _nbytes(list(args)) + _nbytes(got)
        b_ms, b_by = bound_ms(nbytes, B * J * dlt_flops(V), torch.float32)
        log(f"  {case} [float32] kernel {ms:.4f} ms, graph {graph_ms:.4f} ms; plain chain on "
            f"card {plain_ms:.3f} ms, graph {plain_graph_ms:.3f} ms; bound {b_ms:.6f} ms "
            f"({b_by}): {100 * b_ms / graph_ms:.2f}% of it")
        results[case] = {"float32": dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
            bound_by=b_by, graph_ms=graph_ms, plain_graph_ms=plain_graph_ms, bit_identical=same)}


def run_kernel_cases(results, cases):
    """Each case, float32 and bfloat16: the kernel against its plain version, timed
    beside it, the library call and the bound, into ``results[case]``."""
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
    phase_variant_kernels(results)
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
    codec = phase_codec(results)
    data = phase_data(results)
    drawing = phase_drawing(results)
    phase_variant_parity(results)
    serving_v = phase_variant_serving(results)
    train_v = phase_variant_train(results)
    heads_v1 = phase_v1_heads(results)
    metro = phase_metro(results)
    phase_metro_k3_times(results)
    # phase 10: the multi-view baselines, which launch none of the kernels (their
    # attention is masked einsum and their gather the 4-tap one, as in JAX); 10d's two
    # METRO forwards run K3 in its 12 BERT layers each, as phase 9e's
    baseline_paths = {
        **{f"parity/{k}": v for k, v in phase_baseline_parity(results).items()},
        **{f"reference/{k}": v for k, v in phase_baseline_reference(results).items()},
        **{f"bf16/{k}": v for k, v in phase_baseline_times(results).items()},
        "metro_reference": phase_metro_reference(results)}
    # phase 11: CMR, the 2D pose models, the fitter and the bucketed KNN (no kernel of
    # their own; their launches of K1-K10 are recorded, not asserted)
    aux_paths = phase_aux(results)
    # phase 9's paths, each counted around its own run
    variant_paths = {**{f"{k}_serving": v for k, v in serving_v.items()},
                     **{f"{k}_train": v for k, v in train_v.items()},
                     **{f"v1/{k}": v for k, v in heads_v1.items()}, "metro": metro}
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
    # (a kernel of one dtype, K10's integer keys and the DLT's float32: its one row
    # stands for both dtypes)
    entries = []
    for kname, meta in KERNELS.items():
        rows = [r if len(r) > 1 else dict.fromkeys(("bfloat16", "float32"), *r.values())
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
    # the DLT likewise, from phase 1's graphs, and its plain chain's from a graph
    dlt = next(e for e in entries if e["name"] == "triangulate_dlt_c2m")
    dlt_rows = [r["float32"] for c, r in results.items() if c.startswith("triangulate_dlt_c2m/")]
    dlt["graph_ms"] = sum(r["graph_ms"] for r in dlt_rows)
    dlt["plain_graph_ms"] = sum(r["plain_graph_ms"] for r in dlt_rows)
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
        # phase 7's eval_single path on shards, WORKERS 4
        e["data_launches"] = data["eval_workers_4"]["launches"][e["name"]]
        # phase 8's drawing path: the RENDER configs' runs, the draw eval and the demo
        e["viz_launches"] = drawing["launches"][e["name"]]
        # phase 9's: the two head options served (3 requests a bucket and the mixed
        # one) and trained (steps and a validation), the v1 heads' forward, METRO's
        e["variant_launches"] = {path: n[e["name"]] for path, n in variant_paths.items()}
        # phase 10's: the baselines' card forwards (10a, 10b), their bf16 forwards and
        # training forward + backward (10c), all 0, and METRO's converter check (10d: K3
        # 24); recorded, not asserted
        e["baseline_launches"] = {path: n[e["name"]] for path, n in baseline_paths.items()}
        # phase 11's: CMR, the pose models, the fitter and knn_points_bucketed
        e["aux_launches"] = {path: n[e["name"]] for path, n in aux_paths.items()}
    # K3 and K1 at the shapes only the PtEmbedTRv3 decoder gives them (phases 1f, 9f)
    for name in ("dense_cross_attention", "fused_knn_vector_attention"):
        by_name[name]["v3_shapes"] = {
            case[len(f"v3/{name}/"):]: {k: r["bfloat16"][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
            | {"max_abs_err_f32": r["float32"]["max_abs_err"]}
            for case, r in results.items() if case.startswith(f"v3/{name}/")}
    by_name["dense_cross_attention"]["metro_stage_graph"] = results["metro_k3"]
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
    print(json.dumps({"data": {"codec": codec, **data}}), flush=True)
    print(json.dumps({"drawing": drawing}, default=float), flush=True)
    print(json.dumps({"variants": {k: results[k] for k in (
        "variant_parity", "variant_serving", "variant_train", "v1_heads", "metro", "metro_k3")}},
        default=float), flush=True)
    print(json.dumps({"baselines": {k: results[k] for k in (
        "baseline_parity", "baseline_reference", "baseline_times", "metro_reference")}},
        default=float), flush=True)
    print(json.dumps({"aux": {k: results[k] for k in (
        "aux_cmr", "aux_pose2d", "aux_fit", "aux_knn_bucketed", "aux_seconds")}},
        default=float), flush=True)
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
# twice in block 0, K1 twice in block 1, K4 once, the DLT once (K5 once more on a
# batch whose samples do not all use every view); per train step K3 / K3b in both
# blocks, K6 (its forward K1) / K6b / K7 in block 1
LAUNCHES_PER_SYNTHETIC_FORWARD = _launch_counts(
    dense_cross_attention=4, fused_anchor_vector_attention=2, fused_knn_vector_attention=2,
    grid_sample_points_fused=1, triangulate_dlt_c2m=1)
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



# phase 7 (a): nvJPEG against OpenCV's decodes of the committed fixtures
# (tests/torch_fixtures/codec, scripts/torch_make_codec_fixture.py). nvJPEG's IDCT
# and chroma upsampling are not libjpeg-turbo's "islow + fancy upsampling": the
# limits below are a decoder's difference, one set a fixture from the first
# measurement on an H100 (PERF.md, phase 7: 640x480 max 97, mean 0.935, share
# 0.602; 224x224 17, 0.739, 0.571) and not to be widened to pass
CODEC_DIR = "tests/torch_fixtures/codec"
NVJPEG_LIMITS = {"q95_640x480": dict(max_abs=100, mean_abs=1.0, share=0.65),
                 "q95_224x224": dict(max_abs=20, mean_abs=0.8, share=0.6)}
JPEG_PSNR_FLOOR = 35.0


def _ycc(img):
    """JFIF's full-range YCbCr of a uint8 RGB image (float64 planes)."""
    r, g, b = (img[..., i].astype(np.float64) for i in range(3))
    return (0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128)


def _rgb(y, cb, cr):
    rgb = np.stack([y + 1.402 * (cr - 128), y - 0.344136 * (cb - 128) - 0.714136 * (cr - 128),
                    y + 1.772 * (cb - 128)], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def planted_decodes(img):
    """Wrong decodes planted on a decoder's output, to show what the limits catch:
    the channels in BGR order; the chroma averaged over 2x2 blocks and repeated (a
    decoder's nearest-neighbour 4:2:0 upsampling); the chroma one pixel to the left
    (half a chroma sample off). The YCbCr round trip alone is exact."""
    h, w = img.shape[:2]
    y, cb, cr = _ycc(img)

    def blocks(c):
        p = np.pad(c, ((0, h % 2), (0, w % 2)), mode="edge")
        m = p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean(axis=(1, 3))
        return m.repeat(2, 0).repeat(2, 1)[:h, :w]

    def left(c):
        return np.concatenate([c[:, 1:], c[:, -1:]], axis=1)

    return {"channels_swapped": np.ascontiguousarray(img[..., ::-1]),
            "chroma_nearest": _rgb(y, blocks(cb), blocks(cr)),
            "chroma_shifted": _rgb(y, left(cb), left(cr))}


def _diff(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return dict(max_abs=int(d.max()), mean_abs=float(d.mean()), share=float((d > 0).mean()))


def paeth_png(img):
    """A PNG of ``img`` ((H, W, 3) uint8 RGB) with every row Paeth-filtered, as
    libpng's adaptive filtering stores most rows of camera frames: the PNG
    decoder's slowest path."""
    import struct
    import zlib

    from poem_v2_tpu_torch.data.codec import PNG_MAGIC

    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), cur[:-1]])
    left = np.pad(cur, ((0, 0), (c, 0)))[:, :-c]
    upleft = np.pad(up, ((0, 0), (c, 0)))[:, :-c]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.hstack([np.full((h, 1), 4, np.int16), (cur - pred) % 256]).astype(np.uint8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def _psnr(a, b):
    """Peak signal-to-noise ratio of two uint8 images in dB; None where they are equal."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return None if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def _db(x) -> str:
    return "identical" if x is None else f"{x:.2f} dB"


def phase_codec(results, device="cuda", limits=NVJPEG_LIMITS, psnr_floor=JPEG_PSNR_FLOOR,
                iters=20):
    """Phase 7a: the data layer's decoder on ``device`` (nvJPEG on the card) against
    OpenCV's decodes of the fixture JPEGs (max and mean absolute difference, share
    of values that differ, each held to the fixture's ``limits``) and three wrong
    decodes planted on its output (the channel swap must be caught); the PNG
    decoder bit-exact and timed on the fixture (Sub rows) and on the source
    Paeth-filtered; and the 640x480 source encoded at q95 on ``device`` and
    decoded again (PSNR held to ``psnr_floor``; OpenCV's q95 encode's PSNR beside
    it)."""
    import os

    from poem_v2_tpu_torch.data import codec

    log(f"phase 7a: image codecs on {device} against OpenCV's decodes of {CODEC_DIR}")
    ref = np.load(os.path.join(CODEC_DIR, "decodes.npz"))
    read = lambda name: open(os.path.join(CODEC_DIR, name), "rb").read()

    def timed(buf):
        got = codec.decode_image(buf, device)
        t = time.perf_counter()
        for _ in range(iters):
            codec.decode_image(buf, device)
        return got, (time.perf_counter() - t) * 1e3 / iters

    on_card = device.startswith("cuda")
    out, bad = {}, []
    for name in ("q95_640x480", "q95_224x224"):
        got, ms = timed(read(f"{name}.jpg"))
        want = ref[name]
        if got.shape != want.shape or got.dtype != np.uint8:
            raise AssertionError(f"{name}: decoded {got.shape} {got.dtype}, want {want.shape}")
        lim = limits[name] if limits is not None else {}
        row = dict(**_diff(got, want), ms=ms, psnr_vs_opencv=_psnr(got, want),
                   psnr_vs_source=(_psnr(got, ref["source"]) if name == "q95_640x480" else None),
                   limits=lim, planted={})
        log(f"  {name}: max |d| {row['max_abs']}, mean |d| {row['mean_abs']:.4f}, differing "
            f"{100 * row['share']:.2f}% of values (limits {lim}), PSNR vs OpenCV "
            f"{_db(row['psnr_vs_opencv'])}; {ms:.3f} ms a decode (host clock, copy to the host "
            "included)")
        bad += [f"{name} {k} {row[k]} > {v}" for k, v in lim.items() if row[k] > v]
        for kind, wrong in planted_decodes(got).items():
            p = _diff(wrong, want)
            p["caught"] = any(p[k] > v for k, v in lim.items())
            row["planted"][kind] = p
            log(f"    planted {kind}: max |d| {p['max_abs']}, mean |d| {p['mean_abs']:.4f}, "
                f"differing {100 * p['share']:.2f}%: "
                + ("caught" if p["caught"] else "NOT caught"))
        if lim and not row["planted"]["channels_swapped"]["caught"]:
            bad.append(f"{name}: the limits pass a decode with its channels swapped")
        out[name] = row
    png = {}
    for kind, buf in (("sub", read("source.png")), ("paeth", paeth_png(ref["source"]))):
        got, ms = timed(buf)
        if not np.array_equal(got, ref["source"]):
            raise AssertionError(f"the PNG decoder is not bit-exact ({kind} rows)")
        png[kind] = dict(bytes=len(buf), ms=ms)
    out["png_640x480"] = png
    enc = codec.encode_jpeg(ref["source"], 95, device)
    back = codec.decode_image(enc, device)
    out["encode_q95"] = dict(bytes=len(enc), psnr=_psnr(back, ref["source"]),
                             opencv_bytes=len(read("q95_640x480.jpg")),
                             opencv_psnr=_psnr(ref["q95_640x480"], ref["source"]))
    e = out["encode_q95"]
    log(f"  PNG 640x480 bit-exact: {png['sub']['ms']:.3f} ms a decode with Sub rows (the "
        f"fixture), {png['paeth']['ms']:.3f} ms with Paeth rows (host clock); q95 encode on "
        f"{device}: {e['bytes']} bytes, PSNR {_db(e['psnr'])} after its own decode (OpenCV's "
        f"q95: {e['opencv_bytes']} bytes, {_db(e['opencv_psnr'])})")
    if psnr_floor is not None and e["psnr"] < psnr_floor:
        bad.append(f"q95 round trip PSNR {e['psnr']:.2f} < {psnr_floor}")
    if bad:
        raise AssertionError("codec past its limits: " + "; ".join(bad))
    if on_card and codec.nvjpeg_decodes.launches < 2 * (iters + 1) + 1:
        raise AssertionError("the JPEG decodes did not go through nvJPEG")
    results["codec"] = out
    return out



def _backgrounds(rs: np.random.RandomState, views: int, width: int, height: int):
    """One smooth colour field a camera (uint8 RGB): the shards' images compress
    as camera frames do, not as noise."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    out = []
    for _ in range(views):
        img = np.empty((height, width, 3), np.float32)
        for c in range(3):
            fx, fy, ph = rs.uniform(0.004, 0.02, 3) * (1, 1, 300)
            img[..., c] = 110 + 50 * np.sin(fx * x + fy * y + ph)
        out.append(img)
    return out


def multiview_hand_sample(rs: np.random.RandomState, layer, backgrounds, width: int,
                          height: int):
    """One sample in the shard schema of ``tests/test_data.py:make_shard``: a posed
    hand of the port's MANO model (its synthetic hand where MANO_RIGHT.pkl is
    absent) 0.5 m in front of camera 0, the other cameras 0.4-0.6 m around it
    looking at it; per view the camera-to-master extrinsic, intrinsics, camera-
    frame joints and vertices, 2D joints, the box around them (centre, and twice
    the larger span, as the adapters' ``bbox_center_scale``), and an image: the
    camera's background with the projected vertices painted in."""
    pose = (rs.randn(48) * 0.25).astype(np.float32)
    shape = (rs.randn(10) * 0.5).astype(np.float32)
    with torch.no_grad():
        out = layer(torch.as_tensor(pose)[None], torch.as_tensor(shape)[None])
    joints, verts = out.joints[0].numpy().astype(np.float64), out.verts[0].numpy().astype(
        np.float64)
    target = np.array([0.0, 0.0, 0.5]) + rs.uniform(-0.02, 0.02, 3)
    shift = target - joints[9]
    joints, verts = joints + shift, verts + shift
    label = {k: [] for k in ("cam_serial", "cam_extr", "cam_intr", "joints_2d", "joints_3d",
                             "verts_3d", "joints_vis", "bbox_center", "bbox_scale", "raw_size",
                             "mano_pose", "mano_shape")}
    images = []
    for v, bg in enumerate(backgrounds):
        if v == 0:
            centre = np.zeros(3)
        else:
            d = rs.randn(3)
            d[2] = -abs(d[2])
            centre = target + rs.uniform(0.4, 0.6) * d / np.linalg.norm(d)
        z = (target - centre) / np.linalg.norm(target - centre)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2m = np.eye(4)
        c2m[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
        c2m[:3, 3] = centre
        m2c = np.linalg.inv(c2m)
        j_cam = joints @ m2c[:3, :3].T + m2c[:3, 3]
        v_cam = verts @ m2c[:3, :3].T + m2c[:3, 3]
        f = rs.uniform(550, 650)
        intr = np.array([[f, 0, width / 2 + rs.uniform(-8, 8)],
                         [0, f, height / 2 + rs.uniform(-8, 8)], [0, 0, 1]], np.float32)
        proj = lambda p: (p @ intr.T.astype(np.float64))[:, :2] / p[:, 2:]
        j2d, v2d = proj(j_cam), proj(v_cam)
        img = bg.copy()
        px = np.clip(np.rint(v2d).astype(int), 1, [width - 2, height - 2])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                img[px[:, 1] + dy, px[:, 0] + dx] = (230, 190, 160)
        images.append(np.clip(img, 0, 255).astype(np.uint8))
        label["cam_serial"].append(f"cam{v}")
        label["cam_extr"].append(c2m.astype(np.float32))
        label["cam_intr"].append(intr)
        label["joints_2d"].append(j2d.astype(np.float32))
        label["joints_3d"].append(j_cam.astype(np.float32))
        label["verts_3d"].append(v_cam.astype(np.float32))
        label["joints_vis"].append(np.ones(21, np.float32))
        label["bbox_center"].append(((j2d.max(0) + j2d.min(0)) / 2).astype(np.float32))
        label["bbox_scale"].append(np.float32((j2d.max(0) - j2d.min(0)).max() * 2.0))
        label["raw_size"].append(np.array([width, height]))
        label["mano_pose"].append(pose)
        label["mano_shape"].append(shape)
    return images, label


def _device_busy(prof):
    """Device time of a profile: the union of the device events' intervals (ms),
    their sum, and the sum by name."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    union, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e3, sum(by_name.values()), by_name


class _FirstBatch:
    """An eval callback that keeps the first batch (tensors on the device) and the
    loop's host predictions for it."""

    def __init__(self):
        self.batch = self.preds = None

    def __call__(self, preds, batch, step_idx, **kwargs):
        if self.batch is None:
            self.batch = {k: v.clone() for k, v in batch.items() if isinstance(v, torch.Tensor)}
            self.preds = {k: np.array(v) for k, v in preds.items()}

    def on_finished(self):
        pass

    def reset(self):
        pass


def phase_data(results, device="cuda", dtype="bf16", model_overrides=None, image=None,
               samples=64, per_shard=32, views=8, width=640, height=480, batch=8, workers=4,
               process_workers=2):
    """Phase 7 (b)-(c): the data layer and ``eval_single`` on ``device``. (b) the
    port's ShardDumper writes ``samples`` multi-view samples (``views`` views of
    ``width`` x ``height``, DexYCB's raw frame) as shards of ``per_shard``,
    encoding on ``device``; (c) ``build_eval_cfg("DexYCB", "medium", ...)`` on
    them, with a checkpoint of medium's init weights written by the Recorder, runs
    through ``cli/eval.py:evaluate`` at the protocol's B8 and 2-8 random views, with
    ``WORKERS`` 0 and ``workers`` (thread mode): samples/s, launches per batch
    (K5 must run), every view decoded on ``device``, finite measures, peak GiB.
    Beside them: decode and transform ms per view and collate / H2D ms per batch
    (serial, host clock); the device's busy time and idle share (one profiled run
    of the same eval loop, against the unprofiled run's seconds), the loop's first
    batch against a direct model call, bit for bit; and ``process_workers`` spawn
    workers over one shard, each with its own CUDA context, against the thread
    pool. A rehearsal on the CPU passes small sizes and ``model_overrides``."""
    import copy
    import os
    import random as pyrandom
    import tempfile

    from poem_v2_tpu_torch.cli import eval as eval_cli
    from poem_v2_tpu_torch.cli.eval_single import DATASET_META, build_eval_cfg
    from poem_v2_tpu_torch.cli.opt import parse_exp_args
    from poem_v2_tpu_torch.cli.train import build_model
    from poem_v2_tpu_torch.data import codec, collate_padded, create_dataset, native_ops
    from poem_v2_tpu_torch.data.dumper import ShardDumper
    from poem_v2_tpu_torch.data.wds import decode_sample, iter_tar_samples
    from poem_v2_tpu_torch.mano.layer import ManoLayer
    from poem_v2_tpu_torch.training.evaluator import Evaluator
    from poem_v2_tpu_torch.training.prefetch import prefetch_to_device
    from poem_v2_tpu_torch.training.trainer import Trainer
    from poem_v2_tpu_torch.utils.config import get_config
    from poem_v2_tpu_torch.utils.recorder import Recorder

    on_card = device.startswith("cuda")
    card = gpu_line()
    log(f"phase 7: the data layer and eval_single on {device}: {samples} samples of {views} "
        f"views of {width}x{height} written as shards of {per_shard}, the DexYCB protocol at "
        f"B{batch}")
    out = {}
    view_max = DATASET_META["DexYCB"]["max_view"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # (b) the shards, encoded on the device
            rs = np.random.RandomState(7)
            layer = ManoLayer()
            bgs = _backgrounds(rs, views, width, height)
            t, gen = time.perf_counter(), 0.0
            with ShardDumper(os.path.join(tmp, "tars"), "DexYCB_mv_test", per_shard,
                             device=device) as dumper:
                for i in range(samples):
                    g = time.perf_counter()
                    images, label = multiview_hand_sample(rs, layer, bgs, width, height)
                    gen += time.perf_counter() - g
                    dumper.add_sample(f"seq0/{i:06d}", images, label)
            n_shards = -(-samples // per_shard)
            shards = [os.path.join(tmp, "tars", f"DexYCB_mv_test-{k:06d}.tar")
                      for k in range(n_shards)]
            nbytes = sum(os.path.getsize(p) for p in shards)
            encode_ms = (time.perf_counter() - t - gen) * 1e3 / (samples * views)
            log(f"  (b) {n_shards} shards, {nbytes} bytes: {encode_ms:.3f} ms an image to encode "
                f"on {device} and write (host clock; drawing the samples excluded)")
            out["shards"] = dict(count=n_shards, bytes=nbytes, encode_ms_per_view=encode_ms)
            urls = os.path.join(tmp, "tars", f"DexYCB_mv_test-{{000000..{n_shards - 1:06d}}}.tar")

            cfg = build_eval_cfg("DexYCB", "medium", reload_path="", urls=urls,
                                 epoch_size=samples, model_overrides=model_overrides)
            if image is not None:
                cfg.DATA_PRESET.IMAGE_SIZE = [image, image]
            cfg.TRAIN.BATCH_SIZE = batch
            argv = ["--view_max", str(view_max), "--device", device, "--dtype", dtype,
                    "--eval_extra", "auc"]
            args = parse_exp_args(["-c", "<dict>", "--exp_id", "default", *argv])
            model, aux = build_model(get_config(cfg.to_dict(), arg=args), args)
            trainer = Trainer(model, aux, train_cfg=cfg.TRAIN, loss_cfg=cfg.MODEL.LOSS)
            ckpt = Recorder("default", root=os.path.join(tmp, "ckpt")).record_checkpoint(
                trainer, 0)["path"]
            del model, trainer
            cfg.MODEL.PRETRAINED = ckpt

            # serial costs of the pipeline's stages (host clock), the crop warp's
            # library built first (g++ at first use) so that no stage times a build
            native_ops.get_lib()
            raws = [raw for p in shards for raw in iter_tar_samples(p)]
            t = time.perf_counter()
            decoded = [decode_sample(raw, device) for raw in raws]
            decode_ms = (time.perf_counter() - t) * 1e3 / (samples * views)
            ds = create_dataset(cfg.DATASET.TEST, data_preset=cfg.DATA_PRESET, is_train=False,
                                device=device)
            t = time.perf_counter()
            processed = [ds.process_data_item(d, rng=pyrandom.Random(i))
                         for i, d in enumerate(decoded)]
            kept = sum(p["image"].shape[0] for p in processed)
            transform_ms = (time.perf_counter() - t) * 1e3 / kept
            collate_ms, h2d_ms = [], []
            for k in range(0, samples - batch + 1, batch):
                t = time.perf_counter()
                b = collate_padded(processed[k:k + batch], view_max)
                collate_ms.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                next(iter(prefetch_to_device([b], device, size=1)))
                if on_card:
                    torch.cuda.synchronize()
                h2d_ms.append((time.perf_counter() - t) * 1e3)
            out["stages"] = dict(decode_ms_per_view=decode_ms, transform_ms_per_view=transform_ms,
                                 views_kept=kept, collate_ms_per_batch=float(np.median(collate_ms)),
                                 h2d_ms_per_batch=float(np.median(h2d_ms)))
            log(f"  stages, serial [{card}]: decode {decode_ms:.3f} ms a view ({samples * views} "
                f"views), transform {transform_ms:.3f} ms a view kept ({kept}), collate "
                f"{out['stages']['collate_ms_per_batch']:.2f} ms and H2D (pinned, synchronised) "
                f"{out['stages']['h2d_ms_per_batch']:.2f} ms a B{batch} batch (median)")

            # (c) eval_single's path through evaluate, WORKERS 0 and ``workers`` threads,
            # after one batch that builds the kernels (if no phase has) and warms cuDNN
            if on_card:
                _lib.lib()
            warm = cfg.clone()
            warm.DATASET.TEST.EPOCH_SIZE = batch
            _drive_cli(eval_cli.evaluate, warm.to_dict(), argv, {})
            n_batches = samples // batch
            for w in (0, workers):
                run_cfg = cfg.clone()
                run_cfg.DATASET.TEST.WORKERS = w
                codec.nvjpeg_decodes.launches = 0
                timing = {}
                res, got, secs, peak = _drive_cli(eval_cli.evaluate, run_cfg.to_dict(), argv,
                                                  timing)
                decodes = codec.nvjpeg_decodes.launches
                bad = {k: v for k, v in res.items() if not math.isfinite(v)}
                if bad or timing["samples"] != n_batches * batch:
                    raise AssertionError(f"eval WORKERS {w}: {timing['samples']} samples, "
                                         f"measures not finite: {bad}")
                want = {k: n_batches * LAUNCHES_PER_FORWARD[k] for k in KERNELS}
                mixed = got["scrambled_merge_gather"]
                if on_card and ({k: v for k, v in got.items() if k != "scrambled_merge_gather"}
                                != {k: v for k, v in want.items()
                                    if k != "scrambled_merge_gather"}
                                or not 1 <= mixed <= n_batches):
                    raise AssertionError(f"eval WORKERS {w}: launches {got}, want {want} and "
                                         f"K5 1-{n_batches}")
                if decodes != (samples * views if on_card else 0):
                    raise AssertionError(f"eval WORKERS {w}: {decodes} nvJPEG decodes of "
                                         f"{samples * views} views")
                rate = timing["samples"] / timing["seconds"]
                log(f"  (c) eval WORKERS {w} [{card}]: {timing['samples']} samples, {rate:.1f} "
                    f"samples/s ({timing['seconds']:.2f} s in the loop, {secs:.2f} s with the "
                    f"model's build); peak {peak:.2f} GiB; {decodes} nvJPEG decodes; launches a "
                    f"batch: " + ", ".join(f"{k} {v / n_batches:g}" for k, v in got.items() if v)
                    + "; " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()))
                out[f"eval_workers_{w}"] = dict(
                    samples=timing["samples"], loop_s=timing["seconds"], samples_per_s=rate,
                    peak_gib=peak, nvjpeg_decodes=decodes, launches=got,
                    launches_per_batch={k: v / n_batches for k, v in got.items()},
                    results=res)

            # the same loop once more, profiled: device busy, idle share; its first
            # batch against a direct model call
            run_cfg = cfg.clone()
            run_cfg.DATASET.TEST.WORKERS = workers
            run_cfg = get_config(run_cfg.to_dict(), arg=args)
            model, aux = build_model(run_cfg, args)
            evaluator = Evaluator(model, aux, center_idx=run_cfg.DATA_PRESET.CENTER_IDX)
            ds = create_dataset(run_cfg.DATASET.TEST, data_preset=run_cfg.DATA_PRESET,
                                is_train=False, device=device)
            first = _FirstBatch()
            from poem_v2_tpu_torch.data import batch_iterator
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            with profile(activities=acts) as prof:
                t = time.perf_counter()
                evaluator.run(batch_iterator(ds, batch, view_max, samples), callback=first)
                if on_card:
                    torch.cuda.synchronize()
                loop_ms = (time.perf_counter() - t) * 1e3
            busy, summed, by_name = _device_busy(prof)
            idle = 100 * (1 - busy / loop_ms) if busy > 0 else None
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            log(f"  profiled eval loop (WORKERS {workers}): device busy {busy:.1f} ms (union; "
                f"{summed:.1f} ms summed over streams), {busy / n_batches:.2f} ms a batch; idle "
                + (f"{idle:.1f}%" if idle is not None else "not measured")
                + f" of this loop's {loop_ms:.1f} ms (profiler on; the unprofiled loop took "
                f"{out[f'eval_workers_{workers}']['loop_s'] * 1e3:.1f} ms); largest: "
                + "; ".join(f"{k[:50]} {v:.1f} ms" for k, v in top))
            with torch.no_grad():
                model.eval()
                b = first.batch
                direct = model(b["image"], b["view_mask"], b["cam_intr"], b["cam_extr"],
                               b["master_joints_3d"])
            same = np.array_equal(direct["pred_verts_3d"].float().cpu().numpy(),
                                  first.preds["pred_verts_3d"])
            log(f"  the loop's first batch equals a direct model call bit for bit: {same}")
            if not same:
                raise AssertionError("the eval loop's first predictions differ from a direct "
                                     "model call on the same batch")
            out["profile"] = dict(device_busy_ms=busy, device_summed_ms=summed,
                                  busy_ms_per_batch=busy / n_batches, loop_ms=loop_ms,
                                  idle_pct=idle,
                                  first_batch_bit_identical=same)
            del model, evaluator

            # spawn workers over one shard: each opens its own CUDA context (nvJPEG)
            pool_cfg = {**cfg.DATASET.TEST.to_dict(), "URLS": shards[0], "RANDOM_N_VIEWS": True,
                        "WORKERS": process_workers}
            streams = {}
            for mode in ("thread", "process"):
                free0 = torch.cuda.mem_get_info()[0] if on_card else 0
                t = time.perf_counter()
                it = iter(create_dataset({**pool_cfg, "WORKERS_MODE": mode},
                                         data_preset=cfg.DATA_PRESET, is_train=False,
                                         device=device))
                got_samples = [next(it)]
                first_s = time.perf_counter() - t
                free1 = torch.cuda.mem_get_info()[0] if on_card else 0
                got_samples += list(it)
                streams[mode] = dict(samples=got_samples, first_s=first_s,
                                     total_s=time.perf_counter() - t,
                                     device_mib=(free0 - free1) / 2 ** 20)
            same = len(streams["thread"]["samples"]) == len(streams["process"]["samples"]) and all(
                np.array_equal(a["image"], b["image"])
                and np.array_equal(a["target_cam_intr"], b["target_cam_intr"])
                for a, b in zip(streams["thread"]["samples"], streams["process"]["samples"]))
            for mode, st in streams.items():
                log(f"  {process_workers} {mode} workers over one shard ({len(st['samples'])} "
                    f"samples): first sample after {st['first_s']:.2f} s, all after "
                    f"{st['total_s']:.2f} s; device memory taken meanwhile "
                    f"{st['device_mib']:.0f} MiB")
            if not same:
                raise AssertionError("the process pool's samples differ from the thread pool's")
            out["process_workers"] = {mode: {k: v for k, v in st.items() if k != "samples"}
                                      for mode, st in streams.items()}
        finally:
            os.chdir(cwd)
    out["card"] = card
    results["data"] = out
    return out



# phase 8: the drawing path. Every kernel a synthetic model's train step or eval
# forward runs, and the medium forward's, must launch in this phase
VIZ_PATH_KERNELS = ("fused_knn_vector_attention", "fused_anchor_vector_attention",
                    "dense_cross_attention", "dense_cross_attention_bwd",
                    "grid_sample_points_fused", "knn_vector_attention_trainable",
                    "knn_vector_attention_trainable_bwd", "scatter_add_rows")


def _render_cfg(name, epochs, train_size=None, test_size=None, image=None, views=None):
    """The shipped config ``name`` (configs/<name>.yaml, as data) for ``epochs``
    epochs; depth cut by the train and test sets' sizes; a rehearsal on the CPU
    also cuts the image and the views."""
    import copy

    from poem_v2_tpu_torch.configs import SYNTHETIC

    cfg = copy.deepcopy(SYNTHETIC[name])
    cfg["TRAIN"]["EPOCH"] = epochs
    for part, size in (("TRAIN", train_size), ("TEST", test_size)):
        data = cfg["DATASET"][part]
        if size:
            data["EPOCH_SIZE"] = size
        if image:
            data["IMAGE_SIZE"] = image
        if views:
            data.update(VIEW_MAX=views, VIEW_RANGE=[views, views])
    if image:
        cfg["DATA_PRESET"]["IMAGE_SIZE"] = [image, image]
    return cfg


class _PngLog:
    """Keeps a copy of every array ``raster.write_png`` writes while it is on."""

    def __init__(self):
        self.written = {}

    def __enter__(self):
        from poem_v2_tpu_torch.viztools import raster

        self._raster, self._real = raster, raster.write_png

        def write(path, img):
            self.written[path] = np.array(img)
            self._real(path, img)

        raster.write_png = write
        return self

    def __exit__(self, *exc):
        self._raster.write_png = self._real


def _check_pngs(name, written, card):
    """Every PNG written, decoded back by the port's decoder (``csrc/png.cc``),
    equals the array written."""
    from poem_v2_tpu_torch.data.codec import decode_png

    t = time.perf_counter()
    for path, img in written.items():
        got = decode_png(open(path, "rb").read())
        want = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: {path} decodes to other pixels than were written")
    log(f"  {name} [{card}]: {len(written)} PNGs written, decoded back by csrc/png.cc equal to "
        f"the arrays written ({time.perf_counter() - t:.2f} s)")
    return len(written)


def phase_drawing(results, device="cuda", dtype="bf16", gate_epochs=2, gate_size=None,
                  batch=None, short_size=16, draw_size=8, image=None, views=None,
                  medium_model=None, medium_image=256, demo_views=4, demo_batch=2,
                  buckets=(1, 2, 4, 8)):
    """Phase 8: the drawing path through the front doors, in a temporary directory.
    (a) ``synthetic_overfit_gate`` (RENDER, ResNet-18 GN, 2 blocks, width 64, 8 of 8
    views at 128 px, B8) through ``cli/train.py:train`` for ``gate_epochs`` epochs
    of its 64-sample fixed set with one validation, then ``cli/eval.py:evaluate``
    with ``--eval_extra draw`` on ``draw_size`` test samples; then
    ``synthetic_overfit_render``, ``synthetic_overfit_gate_mano`` and, resumed from
    the latter's checkpoint, ``synthetic_overfit_gate_mano_800``, each one epoch of
    ``short_size`` samples. (b) ``cli/demo.py`` on medium (random weights from
    ``init_parameters``), B``demo_batch`` of ``demo_views`` views, bf16; then
    ``Predictor.warmup`` of each of ``buckets`` on a fresh predictor. Readings: ms a
    step (CUDA events), the device's busy share of a step, the host seconds that
    drew the fixed set (the rendering epoch) apart from the epochs' own, launches
    per step and per forward, warmup and request times, every PNG decoded back
    and compared. A rehearsal on the CPU passes small sizes (``gate_size`` samples
    in the gate's sets, ``batch``, ``image``, ``views``) and ``medium_model``."""
    import copy
    import os
    import tempfile

    from poem_v2_tpu_torch.cli import demo as demo_cli, eval as eval_cli, train as train_cli
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.data import batch_iterator, create_dataset
    from poem_v2_tpu_torch.serving.predictor import Predictor
    from poem_v2_tpu_torch.utils.config import dump_yaml

    on_card = device.startswith("cuda")
    card = gpu_line()
    log("phase 8: the drawing path: the RENDER configs through the train CLI, --eval_extra "
        "draw, and cli/demo.py on medium")
    out, viz = {}, {k: 0 for k in KERNELS}

    def add(got):
        for k, n in got.items():
            viz[k] += n

    cwd = os.getcwd()
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # (a) the gate at full width: its epochs, one validation at the end
            gate = _render_cfg("synthetic_overfit_gate", gate_epochs, gate_size, gate_size,
                               image=image, views=views)
            V = gate["DATASET"]["TRAIN"]["VIEW_MAX"]
            B = batch or gate["TRAIN"]["BATCH_SIZE"]
            argv = ["--view_max", str(V), "-b", str(B), "--device", device, "--dtype", dtype,
                    "--eval_freq", str(gate_epochs)]
            run, got, secs, peak = _drive_cli(train_cli.train, gate, argv)
            steps = len(run["losses"])
            n_val = gate["DATASET"]["TEST"]["EPOCH_SIZE"] // B
            _check_launches("gate train CLI", got, _expected(
                steps, n_val, 0, LAUNCHES_PER_SYNTHETIC_TRAIN_STEP,
                LAUNCHES_PER_SYNTHETIC_FORWARD))
            _check_measures("gate validation", run["val"][0])
            add(got)
            summary = _train_summary("synthetic_overfit_gate train", run, secs, peak, B, card)
            rest = run["epoch_s"]
            log(f"  gate [{card}]: drawing the fixed set ({gate['DATASET']['TRAIN']['EPOCH_SIZE']}"
                f" samples of {V} rendered views) took {run['feed_s']:.2f} s on the host before "
                f"the first step; the epochs then took " + ", ".join(f"{x:.2f}" for x in rest)
                + f" s; launches a step " + ", ".join(
                    f"{k} {n}" for k, n in LAUNCHES_PER_SYNTHETIC_TRAIN_STEP.items() if n))
            out["gate_train"] = dict(summary, launches=got, feed_s=run["feed_s"], epoch_s=rest,
                                     launches_per_step={k: n for k, n in
                                                        LAUNCHES_PER_SYNTHETIC_TRAIN_STEP.items()
                                                        if n})
            if on_card:  # the device's busy share: one more step, profiled
                data = dict(gate["DATASET"]["TRAIN"], EPOCH_SIZE=B)
                sample = next(iter(batch_iterator(create_dataset(data), B, V, B)))
                log(f"  the gate step profiled on {card}:")
                out["gate_train"]["profile"] = profile_train_step(
                    run["trainer"], run["trainer"].to_device(sample), summary["median_step_ms"])

            # the eval CLI with --eval_extra draw on the trained checkpoint
            drawn = copy.deepcopy(gate)
            drawn["DATASET"]["TEST"]["EPOCH_SIZE"] = draw_size
            timing = {}
            with _PngLog() as pngs:
                res, got, secs, peak = _drive_cli(
                    eval_cli.evaluate, drawn, argv + ["--eval_extra", "draw", "--reload",
                                                      run["checkpoint"]["path"]], timing)
            _check_launches("gate eval CLI (draw)", got, _expected(
                0, draw_size // B, 0, LAUNCHES_PER_SYNTHETIC_TRAIN_STEP,
                LAUNCHES_PER_SYNTHETIC_FORWARD))
            _check_measures("gate eval (draw)", res)
            add(got)
            grids = [p for p in pngs.written if os.path.basename(p).startswith("step00000_s")]
            if len(grids) != draw_size or len(pngs.written) != draw_size * (1 + 2 * V):
                raise AssertionError(f"--eval_extra draw wrote {len(pngs.written)} PNGs "
                                     f"({len(grids)} grids) for {draw_size} samples of {V} views")
            n_png = _check_pngs("gate --eval_extra draw", pngs.written, card)
            log(f"  gate eval CLI with --eval_extra draw [{card}]: {timing['samples']} samples "
                f"in {timing['seconds']:.2f} s (drawing {n_png} PNGs included), "
                f"{secs:.2f} s with the model's build; mpjpe {res['mpjpe']:.4f} m")
            out["gate_draw"] = dict(results=res, seconds=timing["seconds"], pngs=n_png,
                                    launches=got)

            # the other RENDER configs, an epoch of short_size samples each; the
            # 800-epoch parametric gate by --resume from the 480-epoch one
            for name, key in (("synthetic_overfit_render", "render"),
                              ("synthetic_overfit_gate_mano", "gate_mano")):
                cfg = _render_cfg(name, 1, short_size, short_size, image=image, views=views)
                v = cfg["DATASET"]["TRAIN"]["VIEW_MAX"]
                args_n = ["--view_max", str(v), "-b", str(B), "--device", device, "--dtype",
                          dtype, "--eval_freq", "1000"]
                run_n, got, secs, peak = _drive_cli(train_cli.train, cfg, args_n)
                _check_launches(f"{name} train CLI", got, _expected(
                    short_size // B, 0, 0, LAUNCHES_PER_SYNTHETIC_TRAIN_STEP,
                    LAUNCHES_PER_SYNTHETIC_FORWARD))
                add(got)
                out[key] = dict(_train_summary(f"{name} train", run_n, secs, peak, B, card,
                                               warmup=0), launches=got, feed_s=run_n["feed_s"])
            ext = _render_cfg("synthetic_overfit_gate_mano_800", 2, short_size, short_size,
                              image=image, views=views)
            run_e, got, secs, peak = _drive_cli(
                train_cli.train, ext, args_n + ["--resume", run_n["checkpoint"]["path"]])
            if run_e["start_epoch"] != 1 or run_e["trainer"].global_step != 2 * (short_size // B):
                raise AssertionError(f"the 800-epoch gate resumed at epoch {run_e['start_epoch']}"
                                     f", step {run_e['trainer'].global_step}")
            _check_launches("synthetic_overfit_gate_mano_800 (resumed) train CLI", got, _expected(
                short_size // B, 0, 0, LAUNCHES_PER_SYNTHETIC_TRAIN_STEP,
                LAUNCHES_PER_SYNTHETIC_FORWARD))
            add(got)
            out["gate_mano_800"] = dict(_train_summary(
                "synthetic_overfit_gate_mano_800 (resumed at epoch 1) train", run_e, secs, peak,
                B, card, warmup=0), launches=got)

            # (b) the demo on medium: its config without a test set, so that the
            # request comes from the synthetic generator at the tier's 256 px
            medium = {"MODEL": copy.deepcopy(medium_model or MEDIUM["MODEL"]),
                      "DATA_PRESET": dict(MEDIUM["DATA_PRESET"],
                                          IMAGE_SIZE=[medium_image, medium_image])}
            path = os.path.join(tmp, "demo_medium.yaml")
            with open(path, "w") as f:
                f.write(dump_yaml(medium))
            if on_card:
                torch.cuda.synchronize()
            reset_launches()
            t = time.perf_counter()
            with _PngLog() as pngs:
                demo = demo_cli.main(["-c", path, "--out", os.path.join(tmp, "demo"), "--batch",
                                      str(demo_batch), "--views", str(demo_views), "--dtype",
                                      dtype, "--device", device])
            secs = time.perf_counter() - t
            got = read_launches()
            # the warmup's forward and the request's, all views valid (no K5)
            _check_launches("demo (medium)", got, {k: 2 * n for k, n in
                                                   LAUNCHES_PER_FORWARD.items()})
            add(got)
            for key in ("joints_3d", "verts_3d", "joints_uv"):
                if not np.isfinite(demo[key]).all():
                    raise AssertionError(f"demo: {key} not finite")
            if {p for p, _ in demo["written"]} != set(pngs.written) or \
                    len(pngs.written) != demo_batch:
                raise AssertionError(f"demo wrote {sorted(pngs.written)}")
            n_png = _check_pngs("demo overlays", pngs.written, card)
            tm = demo["timing"]
            log(f"  demo medium B{demo_batch} x {demo_views} views {dtype} [{card}]: warmup of its "
                f"bucket {tm['warmup_s'] * 1e3:.1f} ms, then the request "
                f"{tm['request_s'] * 1e3:.2f} ms (host clock, outputs on the host); {secs:.2f} s "
                f"whole (model build and drawing included)")
            out["demo"] = dict(timing=tm, seconds=secs, pngs=n_png, launches=got)

            # Predictor.warmup of every bucket on a fresh predictor
            pred = Predictor.from_config(
                medium, dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
                device=device, view_bucket=demo_views)
            warm = {}
            for b in buckets:
                first = pred.warmup(b)
                warm[b] = dict(first_s=first, again_s=pred.warmup(b))
            log(f"  Predictor.warmup, medium, {demo_views} views [{card}]: " + "; ".join(
                f"B{b} {w['first_s'] * 1e3:.1f} ms, again {w['again_s'] * 1e3:.1f} ms"
                for b, w in warm.items()))
            out["warmup"] = warm
        finally:
            os.chdir(cwd)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    quiet = [k for k in VIZ_PATH_KERNELS if on_card and not viz[k]]
    if quiet:
        raise AssertionError(f"kernels phase 8 did not launch: {quiet}")
    out["launches"] = viz
    out["card"] = card
    results["drawing"] = out
    return out


# ---- phase 9: POEM's PtEmbedTRv3 and PETR_EMBEDDING options, the v1 heads, METRO ----

VARIANTS = {"v3": "HEAD.TRANSFORMER.TYPE PtEmbedTRv3", "petr": "HEAD.PETR_EMBEDDING"}
# METRO encoder layers a PtEmbedTRv3 forward runs: 3 blocks of 4 (decoder_v3.py)
METRO_LAYERS = 12


def variant_model(name, model_cfg=None):
    """``model_cfg`` (default medium's MODEL) with one of the two head options."""
    import copy

    from poem_v2_tpu_torch.configs import MEDIUM

    cfg = copy.deepcopy(model_cfg or MEDIUM["MODEL"])
    if name == "v3":
        cfg["HEAD"]["TRANSFORMER"]["TYPE"] = "PtEmbedTRv3"
    else:
        cfg["HEAD"]["PETR_EMBEDDING"] = True
    return cfg


def variant_launches(name, n_blocks, train=False, mixed=False):
    """Launches of one forward (or one train step) of a variant with ``n_blocks``
    decoder blocks. PtEmbedTRv3: K3 in each METRO layer (eval only: it trains by
    the einsum path, as JAX does), K1 in PtEmbedTRv2's BPS self-attention and in
    each block's query self- and cross-attention (K6 / K6b / K7 in training), K4
    once. PETR: the flagship decoder's counts. K5 once more on a mixed batch; the
    DLT once a forward."""
    if name == "v3":
        knn = 1 + 2 * n_blocks
        if train:
            return _launch_counts(fused_knn_vector_attention=knn,
                                  knn_vector_attention_trainable=knn,
                                  knn_vector_attention_trainable_bwd=knn, scatter_add_rows=knn)
        return _launch_counts(dense_cross_attention=METRO_LAYERS, fused_knn_vector_attention=knn,
                              grid_sample_points_fused=1, scrambled_merge_gather=int(mixed),
                              triangulate_dlt_c2m=1)
    knn = 2 * (n_blocks - 1)
    if train:
        return _launch_counts(dense_cross_attention=2 * n_blocks,
                              dense_cross_attention_bwd=2 * n_blocks,
                              fused_knn_vector_attention=knn, knn_vector_attention_trainable=knn,
                              knn_vector_attention_trainable_bwd=knn, scatter_add_rows=knn)
    return _launch_counts(dense_cross_attention=2 * n_blocks, fused_anchor_vector_attention=2,
                          fused_knn_vector_attention=knn, grid_sample_points_fused=1,
                          scrambled_merge_gather=int(mixed), triangulate_dlt_c2m=1)


def _select_exactly(module, exact=True):
    """Set the vector-attention blocks under ``module`` to the gathered path, which
    selects neighbours by full float32 distances (``exact``), or back to K1."""
    from poem_v2_tpu_torch.models.bricks.point_transformer import _VectorAttention

    for m in module.modules():
        if isinstance(m, _VectorAttention):
            m.use_fused_knn = not exact
    return module


def _set_diffs(got, want):
    """Max |got - want| of each coordinate set (the first axis), metres."""
    return [float((g.float().cpu() - w).abs().max()) for g, w in zip(got, want)]


def _n_blocks(model_cfg):
    return model_cfg["HEAD"]["TRANSFORMER"]["N_BLOCKS"]


def _request_tensors(rs, B, V, image, n_views=None):
    images, intr, extr = look_at_request(rs, B, V, image)
    n = np.full(B, V) if n_views is None else np.asarray(n_views)
    mask = np.arange(V)[None, :] < n[:, None]
    return (torch.from_numpy(images).float() / 255.0 - 0.5, torch.from_numpy(mask),
            torch.from_numpy(intr), torch.from_numpy(extr))


def phase_variant_parity(results, device="cuda", model_cfg=None, image=256, views=8,
                         part_views=5):
    """Phase 9a: medium with each option in float32 at B1 (all views) and B2 (all and
    ``part_views`` of them), the kernels on the card against the plain versions on
    the CPU, same weights and requests, TF32 off (main sets it)."""
    import copy

    from poem_v2_tpu_torch.models.poem import create_poem_model

    log("phase 9a: PtEmbedTRv3 and PETR_EMBEDDING, card (kernels) vs CPU (plain versions), "
        "float32, TF32 off")
    # phase 3's limits: float32 sums in other orders through the network. PtEmbedTRv3's
    # coarse mesh (the METRO stage) is held to 1e-5 m; its 3 refinement blocks amplify
    # float32 differences at random weights (on the gathered path, which selects by
    # full float32 distances: 6e-7, 3e-5, 3e-5, 1e-4 m by coordinate set), 2e-4 m
    # there, and on K1's path its queries also meet K1's packed keys, which tie
    # distances within 2**-11: a tie broken the other way moves a query by its
    # neighbour's difference, 1e-3 m there
    tol = {"pred_joints_uv": 1e-2, "pred_ref_joints_3d": 1e-4, "all_coords_preds": 1e-4,
           "pred_joints_3d": 1e-4, "pred_verts_3d": 1e-4}
    out = {}
    for name in VARIANTS:
        model, _ = create_poem_model(variant_model(name, model_cfg), device="cpu",
                                     generator=torch.Generator().manual_seed(0))
        dev_model = copy.deepcopy(model).to(device)
        paths = [("K1", False)] + ([("gathered", True)] if name == "v3" else [])
        for B, n_views in ((1, None), (2, [views, part_views])):
            args = _request_tensors(np.random.RandomState(30 + B), B, views, image, n_views)
            for path, exact in paths[:1 if B == 1 else None]:
                for m in (model, dev_model):
                    _select_exactly(m.head.transformer, exact)
                with torch.inference_mode():
                    t = time.time()
                    want = model(*args)
                    cpu_s = time.time() - t
                    got = dev_model(*(a.to(device) for a in args))
                    torch.cuda.synchronize()
                diffs = {}
                for key in tol:
                    g, w = got[key].float().cpu(), want[key]
                    if g.shape != w.shape or not torch.isfinite(g).all():
                        raise AssertionError(
                            f"{name} B{B} {key}: shape {tuple(g.shape)} vs {tuple(w.shape)}, "
                            f"finite {bool(torch.isfinite(g).all())}")
                    diffs[key] = float((g - w).abs().max())
                sets = _set_diffs(got["all_coords_preds"], want["all_coords_preds"])
                lim = dict(tol)
                if name == "v3":
                    refined = 2e-4 if exact else 1e-3
                    lim.update(all_coords_preds=refined, pred_joints_3d=refined,
                               pred_verts_3d=refined)
                    if sets[0] > 1e-5:
                        raise AssertionError(f"v3 B{B}: the coarse mesh {sets[0]} m apart")
                log(f"  {name} B{B} ({'all' if n_views is None else n_views} views, {path}): "
                    f"max |card - cpu| " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
                    + "; by coordinate set " + ", ".join(f"{d:.2e}" for d in sets)
                    + f" m (cpu forward {cpu_s:.1f} s)")
                bad = {k: d for k, d in diffs.items() if d > lim[k]}
                if bad:
                    raise AssertionError(f"{name} B{B} {path}: card vs cpu over the limits {bad}")
                out[f"{name}/B{B}/{path}"] = dict(diffs, by_set=sets)
        del model, dev_model
        torch.cuda.empty_cache()
    results["variant_parity"] = out


def _check_request(name, out, bs, views):
    for key, shape in (("joints_3d", (bs, 21, 3)), ("verts_3d", (bs, 778, 3)),
                       ("joints_uv", (bs, views, 21, 2))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{name} {key}: shape {out[key].shape}, "
                                 f"finite {np.isfinite(out[key]).all()}")


def phase_variant_serving(results, device="cuda", dtype="bf16", model_cfg=None, image=256,
                          views=8, buckets=(1, 4, 16), mixed_batch=4):
    """Phase 9b: each option behind the Predictor in bfloat16: requests of all views
    at each batch bucket and a mixed 2-``views`` request; latency (median of 3,
    host clock, synchronised), peak GiB and the launches of every forward."""
    from poem_v2_tpu_torch.serving.predictor import Predictor

    log("phase 9b: serving PtEmbedTRv3 and PETR_EMBEDDING behind Predictor")
    card = gpu_line()
    out, launches = {}, {}
    for name in VARIANTS:
        cfg = {"MODEL": variant_model(name, model_cfg),
               "DATA_PRESET": {"IMAGE_SIZE": [image, image]}}
        n_blocks = _n_blocks(cfg["MODEL"])
        pred = Predictor.from_config(cfg, dtype=torch.bfloat16 if dtype == "bf16"
                                     else torch.float32, device=device, seed=0,
                                     view_bucket=views)
        rs = np.random.RandomState(40)
        reqs = {f"B{b}": (look_at_request(rs, b, views, image), None) for b in buckets}
        reqs[f"mixed B{mixed_batch}"] = (look_at_request(rs, mixed_batch, views, image),
                                         mixed_view_mask(rs, mixed_batch, views))
        for req, mask in reqs.values():  # first call a bucket: cuDNN, the allocator, builds
            pred(*req, view_mask=mask)
        on_card = device.startswith("cuda")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rows = {}
        for key, (req, mask) in reqs.items():
            want = variant_launches(name, n_blocks, mixed=mask is not None)
            times = []
            for _ in range(3):
                before = read_launches()
                t = time.perf_counter()
                res = pred(*req, view_mask=mask)  # host arrays: the call ends synchronised
                times.append((time.perf_counter() - t) * 1e3)
                after = read_launches()
                _check_launches(f"{name} {key} forward", {k: after[k] - before[k] for k in after},
                                want)
                _check_request(f"{name} {key}", res, req[0].shape[0], views)
            rows[key] = dict(median_ms=float(np.median(times)), runs_ms=times)
        launches[name] = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
        log(f"  {name} [{card}]: " + "; ".join(
            f"{k} {r['median_ms']:.2f} ms ({', '.join(f'{t:.1f}' for t in r['runs_ms'])})"
            for k, r in rows.items()) + f"; peak {peak:.2f} GiB; launches a forward "
            + ", ".join(f"{k} {v}" for k, v in variant_launches(name, n_blocks).items() if v))
        out[name] = dict(requests=rows, peak_gib=peak, card=card,
                         launches_per_forward=variant_launches(name, n_blocks))
        del pred
        torch.cuda.empty_cache()
    results["variant_serving"] = out
    return launches


def phase_variant_train(results, device="cuda", dtype="bf16", model_cfg=None, image=256,
                        views=8, batches=(("v3", 2), ("petr", 8)), steps=4):
    """Phase 9c: each option through ``cli/train.py:train`` on synthetic ``image`` px
    data (1-``views`` valid views), ``steps`` epochs of one fixed batch, validation
    and a checkpoint after the last: step ms (CUDA events), peak GiB, the launches
    of the run; then ``2 * steps`` more steps of the Trainer on the batch, and its
    train-mode loss under fixed noise (the same jitter draws and dropout seed)
    before the run and after them, which must fall (4 steps from random weights
    do not always lower it)."""
    import copy
    import os
    import tempfile

    from poem_v2_tpu_torch.cli import train as train_cli
    from poem_v2_tpu_torch.cli.opt import parse_exp_args
    from poem_v2_tpu_torch.configs import MEDIUM
    from poem_v2_tpu_torch.data import batch_iterator, create_dataset
    from poem_v2_tpu_torch.models.poem import draw_ref_noise
    from poem_v2_tpu_torch.training.trainer import Trainer
    from poem_v2_tpu_torch.utils.config import get_config

    log("phase 9c: training PtEmbedTRv3 and PETR_EMBEDDING through the train CLI")
    card = gpu_line()
    out, launches = {}, {}
    cwd = os.getcwd()
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name, B in batches:
                cfg = copy.deepcopy(MEDIUM)
                cfg["MODEL"] = variant_model(name, model_cfg)
                cfg["TRAIN"]["EPOCH"] = steps
                cfg["DATA_PRESET"]["IMAGE_SIZE"] = [image, image]
                data = {"TYPE": "Synthetic", "VIEW_MAX": views, "VIEW_RANGE": [1, views],
                        "IMAGE_SIZE": image, "EPOCH_SIZE": B, "FIXED_SET": True, "SEED": 7}
                cfg["DATASET"] = {"TRAIN": data, "TEST": dict(data)}
                argv = ["--view_max", str(views), "-b", str(B), "--device", device, "--dtype",
                        dtype, "--eval_freq", str(steps), "--ckpt_freq", str(steps),
                        "--snapshot", "0"]
                # the CLI's initial model (its build_model, same seed) on its fixed batch
                args = parse_exp_args(["-c", "<dict>", "--exp_id", "default", *argv])
                ccfg = get_config(cfg, arg=args, merge=True)
                model0, aux = train_cli.build_model(ccfg, args)
                probe = Trainer(model0, aux, cfg["TRAIN"], cfg["MODEL"]["LOSS"])
                ds = create_dataset(ccfg.DATASET.TRAIN, data_preset=ccfg.DATA_PRESET,
                                    is_train=True, device="cpu")
                batch = probe.to_device(next(iter(batch_iterator(ds, B, views, B))))
                draws = draw_ref_noise(torch.Generator().manual_seed(5), B)
                before = _probe_loss(probe, batch, draws)
                del model0, probe
                run, got, secs, peak = _drive_cli(train_cli.train, cfg, argv)
                # as phase 4c: the loss under fixed noise over 3 * steps steps of the batch
                for _ in range(2 * steps):
                    run["trainer"].step(batch)
                after = _probe_loss(run["trainer"], batch, draws)
                n_blocks = _n_blocks(cfg["MODEL"])
                mixed = _mixed_batches(cfg["DATASET"]["TEST"], B, views, B)
                want = {k: steps * v for k, v in variant_launches(name, n_blocks, True).items()}
                fwd = variant_launches(name, n_blocks, mixed=bool(mixed))
                _check_launches(f"{name} train CLI", got, {k: want[k] + fwd[k] for k in want})
                summary = _train_summary(f"{name} train B{B}", run, secs, peak, B, card,
                                         warmup=1)
                log(f"  {name}: the batch's loss under fixed noise {before:.5f} -> {after:.5f} "
                    f"after {3 * steps} steps")
                if not after < before:
                    raise AssertionError(f"{name}: the fixed batch's loss under fixed noise did "
                                         f"not fall: {before} -> {after}")
                _check_measures(f"{name} validation", run["val"][0])
                out[name] = dict(summary, batch=B, launches=got, probe=(before, after))
                launches[name] = got
                torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
            # the train CLI makes cuDNN deterministic; the phases after time as before
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    results["variant_train"] = out
    return launches


def phase_v1_heads(results, device="cuda", dtype="bf16", batch=2, views=8, hw=32, image=256,
                   in_channels=128, head_kw=None, tol_m=1e-4):
    """Phase 9d: the two POEM v1 heads at the JAX defaults (embed 256, 2048 ball
    points in 0.2 m, 32 depth bins, 6 blocks, K 16) on ``views`` maps of
    ``hw`` x ``hw``, the second sample with 5 valid views: float32 card vs CPU
    (launches counted), then the card's bfloat16 forward timed (CUDA events).
    At these random weights the 6-block decoder amplifies float32 rounding: the
    CPU against itself, its input features moved by 1e-7 relative, parts by up to
    ~1e-3 m at block 1 and ~1e-2 m at block 5. So each block's card - CPU
    difference is held to 5 times that CPU self-difference, and to at least
    1e-4 m (block 0, which runs the whole head and one decoder block, agrees to
    ~1e-7 m)."""
    import copy

    from poem_v2_tpu_torch.mano.layer import ManoLayer
    from poem_v2_tpu_torch.models.heads import v1_heads
    from poem_v2_tpu_torch.models.poem import init_parameters

    log("phase 9d: the POEM v1 heads, card vs CPU in float32, bfloat16 timed")
    card = gpu_line()
    rs = np.random.RandomState(50)
    _, intr, extr = look_at_request(rs, batch, views, image)
    n = np.full(batch, views)
    n[1:] = min(5, views)
    mask = np.arange(views)[None, :] < n[:, None]
    mano = ManoLayer(center_idx=9)
    m = mano(torch.zeros(1, 48), torch.zeros(1, 10))
    template = torch.cat([m.joints, m.verts], 1)[0]
    ref = template[None] + torch.tensor([0.0, 0.0, 0.5]) + torch.from_numpy(
        rs.randn(batch, 1, 3).astype(np.float32)) * 0.01
    feat = torch.from_numpy(rs.randn(batch, views, hw, hw, in_channels).astype(np.float32))
    args = (feat, torch.from_numpy(mask), torch.from_numpy(intr), torch.from_numpy(extr), ref,
            template, (image, image))
    kw = dict(in_channels=in_channels, **(head_kw or {}))
    out, launches = {}, {}
    for cls in (v1_heads.POEMPositionEmbeddedAggregationHead,
                v1_heads.POEMProjectiveSelfAggregationHead):
        head = cls(**kw)
        init_parameters(head, torch.Generator().manual_seed(0))
        head.eval()
        dev_head = copy.deepcopy(head).to(device)
        dev_args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
        with torch.inference_mode():
            t = time.time()
            want = head(*args)["all_coords_preds"]
            cpu_s = time.time() - t
            reset_launches()
            got = dev_head(*dev_args)["all_coords_preds"]
            torch.cuda.synchronize()
            got_launches = read_launches()
            _check_launches(cls.__name__, got_launches, _launch_counts(
                fused_knn_vector_attention=1 + 2 * head.transformer.n_blocks))
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{cls.__name__}: shapes {tuple(got.shape)}, "
                                     f"{tuple(want.shape)}, finite {bool(torch.isfinite(got).all())}")
            nudge = 1.0 + 1e-7 * torch.from_numpy(np.random.RandomState(51).randn(
                *feat.shape).astype(np.float32))
            self_diff = _set_diffs(head(feat * nudge, *args[1:])["all_coords_preds"], want)
            diff = _set_diffs(got, want)
            lim = [max(tol_m, 5 * d) for d in self_diff]
            log(f"  {cls.__name__}: max |card - cpu| by block " + ", ".join(
                f"{d:.2e}" for d in diff) + " m; the CPU against itself, input moved by 1e-7: "
                + ", ".join(f"{d:.2e}" for d in self_diff) + f" m (cpu {cpu_s:.1f} s)")
            if any(d > lm for d, lm in zip(diff, lim)):
                raise AssertionError(f"{cls.__name__}: card vs cpu by block {diff} over {lim}")
            if dtype == "bf16":
                dev_head.to(torch.bfloat16)
            ms = time_cuda(lambda: dev_head(*dev_args), iters=5, warmup=1)
        log(f"  {cls.__name__}: {dtype} forward through K1 {ms:.2f} ms at B{batch} of {views} "
            f"views [{card}]")
        out[cls.__name__] = dict(by_block=diff, cpu_self_by_block=self_diff, ms=ms,
                                 batch=batch, launches=got_launches)
        launches[cls.__name__] = got_launches
        del head, dev_head
    results["v1_heads"] = out
    return launches


def phase_metro(results, device="cuda", dtype="bf16", cfg=None, image=224, batch=2,
                time_batch=16):
    """Phase 9e: ``create_metro_model`` (ResNet-50 GN and the default widths unless
    ``cfg``) in float32 on the card against the CPU (1e-4 of each output's
    largest), then one ``dtype`` forward at ``time_batch`` timed (CUDA events)."""
    import copy

    from poem_v2_tpu_torch.models.metro import create_metro_model

    log("phase 9e: METRO, card vs CPU in float32, bfloat16 timed")
    card = gpu_line()
    model, _ = create_metro_model(cfg, device="cpu")
    rs = np.random.RandomState(60)
    img = torch.from_numpy(rs.uniform(-0.5, 0.5, (batch, image, image, 3)).astype(np.float32))
    dev = copy.deepcopy(model).to(device)
    layers = sum(getattr(dev, f"block_{i}").num_layers for i in range(dev.n_blocks))
    with torch.inference_mode():
        want = model(img)
        reset_launches()
        got = dev(img.to(device))
        torch.cuda.synchronize()
        got_launches = read_launches()
        _check_launches("METRO", got_launches, _launch_counts(dense_cross_attention=layers))
        errs = {k: compare(f"METRO {k}", got[k], want[k], torch.float32) for k in want}
        if dtype == "bf16":
            dev.to(torch.bfloat16)
        big = torch.from_numpy(rs.uniform(-0.5, 0.5, (time_batch, image, image, 3))
                               .astype(np.float32)).to(device)
        ms = time_cuda(lambda: dev(big), iters=5, warmup=2)
    log(f"  METRO {dtype} forward at B{time_batch} of {image} px: {ms:.2f} ms [{card}]")
    results["metro"] = dict(max_abs_err=errs, ms=ms, batch=time_batch, launches=got_launches)
    del model, dev
    return got_launches


def phase_metro_k3_times(results, B=2, M=799 + 4096, Hs=(1024, 256, 64), device="cuda"):
    """Phase 9f: K3 at the METRO stage's self-attention shapes, bfloat16, from a CUDA
    graph, beside ``F.scaled_dot_product_attention`` on the same heads and the bound."""
    log("phase 9f: K3 at the METRO stage's shapes from a CUDA graph, beside SDPA")
    card = gpu_line()
    rs = np.random.RandomState(70)
    out = {}
    for H in Hs:
        q, k, v = (torch.from_numpy(rs.randn(B, M, H).astype(np.float32)).to(
            device, torch.bfloat16) for _ in range(3))
        kw = dict(num_heads=4, sm_scale=1 / math.sqrt(H // 4))
        ms = time_graph(lambda: cross_attn.dense_cross_attention(q, k, v, **kw))
        sdpa_ms = time_graph(library_sdpa((q, k, v), kw))
        b_ms, b_by = bound_ms(4 * q.numel() * q.element_size(), 4.0 * B * M * M * H,
                              torch.bfloat16)
        log(f"  K3 B{B} M=N={M} head dim {H // 4}: graph {ms:.4f} ms, SDPA {sdpa_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}): {100 * b_ms / ms:.1f}% of it [{card}]")
        out[f"hd{H // 4}"] = dict(graph_ms=ms, sdpa_graph_ms=sdpa_ms, bound_ms=b_ms,
                                  bound_by=b_by, batch=B, tokens=M)
    results["metro_k3"] = out


# phase 10: the multi-view baselines (models/petr.py, models/mvp.py) at the JAX
# defaults (configs.BASELINES); PETR with its FTL head is PETR's model with
# PETRHeadFTL built directly, as the JAX factory builds PETRHead whatever HEAD.TYPE says
BASELINE_NAMES = ("petr", "petr_ftl", "mvp")
# card vs CPU in float32, each level of ``all_coords_preds``: within 5 times the
# CPU's own spread under a 1e-7 relative nudge of the input images (phase 9d's rule
# for the v1 heads), and never under 1e-6 m, 8 float32 ulps at 1 m (the first
# H100 run: spreads 1.2e-7 to 3.0e-7 m, card - CPU 1.2e-7 to 4.2e-7 m)
BASELINE_SPREAD_FACTOR = 5.0
BASELINE_FLOOR_M = 1e-6


def baseline_model(name, cfgs=None, dtype=torch.float32, device="cuda", param_dtype=None):
    """One of the phase-10 models, weights from seed 0 (the FTL head from seed 1)."""
    from poem_v2_tpu_torch.configs import BASELINES
    from poem_v2_tpu_torch.models import mvp, petr
    from poem_v2_tpu_torch.models.poem import init_parameters

    cfgs = cfgs or BASELINES
    if name == "mvp":
        return mvp.create_mvp_model(cfgs["MVP"], dtype=dtype, device=device,
                                    param_dtype=param_dtype)[0]
    model, _ = petr.create_petr_model(cfgs["PETR"], dtype=dtype, device="cpu",
                                      param_dtype=param_dtype)
    if name == "petr_ftl":
        head = petr.PETRHeadFTL(**petr.petr_head_kwargs(cfgs["PETR"]["HEAD"],
                                                        model.backbone.feat_size[1]))
        init_parameters(head, torch.Generator().manual_seed(1))
        model.head = head.to(param_dtype or dtype)
    return model.to(device).eval()


def _baseline_request(rs, B, V, image, n_views=None, device="cpu"):
    return tuple(t.to(device) for t in _request_tensors(rs, B, V, image, n_views))


def phase_baseline_parity(results, device="cuda", cfgs=None, image=256, views=8, part_views=5,
                          batch=2):
    """Phase 10a: PETR, PETR-FTL and MVP in float32, TF32 off, on the card against
    the port's CPU forward with the same weights, B``batch`` with all and
    ``part_views`` valid views (padded to ``views``): max |card - CPU| of each
    level's coordinates (metres) held to 5 times the CPU's own spread under a 1e-7
    nudge of the images, at least 1e-6 m. Returns each model's launches."""
    import copy

    log("phase 10a: PETR, PETR-FTL and MVP, card vs CPU in float32")
    rs = np.random.RandomState(80)
    n = [views] + [part_views] * (batch - 1)
    args = _baseline_request(rs, batch, views, image, n)
    nudge = 1.0 + 1e-7 * torch.from_numpy(np.random.RandomState(81).randn(
        *args[0].shape).astype(np.float32))
    out, launches = {}, {}
    for name in BASELINE_NAMES:
        model = baseline_model(name, cfgs, device="cpu")
        dev_model = copy.deepcopy(model).to(device)
        with torch.inference_mode():
            t = time.time()
            want = model(*args)["all_coords_preds"]
            cpu_s = time.time() - t
            self_diff = _set_diffs(model(args[0] * nudge, *args[1:])["all_coords_preds"], want)
            reset_launches()
            got = dev_model(*(a.to(device) for a in args))["all_coords_preds"]
            torch.cuda.synchronize()
            launches[name] = read_launches()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: shapes {tuple(got.shape)}, {tuple(want.shape)}, "
                                 f"finite {bool(torch.isfinite(got).all())}")
        diff = _set_diffs(got, want)
        lim = [max(BASELINE_FLOOR_M, BASELINE_SPREAD_FACTOR * d) for d in self_diff]
        log(f"  {name}: max |card - cpu| by level " + ", ".join(f"{d:.2e}" for d in diff)
            + " m; the CPU against itself, images moved by 1e-7: "
            + ", ".join(f"{d:.2e}" for d in self_diff) + f" m (cpu {cpu_s:.1f} s); launches "
            + (", ".join(f"{k} {v}" for k, v in launches[name].items() if v) or "none"))
        if any(d > lm for d, lm in zip(diff, lim)):
            raise AssertionError(f"{name}: card vs cpu by level {diff} over {lim}")
        out[name] = dict(by_level=diff, cpu_self_by_level=self_diff, limit_by_level=lim,
                         batch=batch, views=n, launches=launches[name])
        del model, dev_model
    results["baseline_parity"] = out
    return launches


def flax_variables_of(module):
    """A module's state dict as the flax variables ``convert.py`` reads: kernels
    HWIO / (in, out), norm scales ``scale``, a ``bn`` norm's statistics in
    ``batch_stats`` and a FrozenBatchNorm's in ``params`` (numpy, no JAX)."""
    bn = {name for name, m in module.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    tree = {"params": {}, "batch_stats": {}}
    for key, v in module.state_dict().items():
        mod, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        a = v.detach().cpu().numpy()
        part, name = "params", leaf
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            part, name = ("batch_stats" if mod in bn else "params"), leaf[len("running_"):]
        elif leaf == "weight" and a.ndim == 4:
            name, a = "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 2:
            name, a = "kernel", a.T
        elif leaf == "weight":
            name = "scale"
        node = tree[part]
        for seg in mod.split(".") if mod else ():
            node = node.setdefault(seg, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def _load_fresh(name, cfgs, device, state, fill):
    """A new model of ``name``, every parameter set to ``fill``, then ``state``
    loaded (strict)."""
    model = baseline_model(name, cfgs, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(fill)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    return model.to(device)


def phase_baseline_reference(results, device="cuda", cfgs=None, image=256, views=8, batch=2):
    """Phase 10b: PETR's and MVP's weights under the reference's names (the head's
    table of ``convert_reference.py`` read backwards, with the reference's aliases
    and counters), loaded back through the table into a fresh model, and the same
    weights through ``convert.py`` from their flax layout into another: both card
    forwards equal the source model's, bit for bit."""
    from poem_v2_tpu_torch import convert_reference as cr
    from poem_v2_tpu_torch.convert import flax_to_state_dict

    log("phase 10b: reference-named PETR and MVP weights through convert_reference.py, "
        "and the same weights through convert.py")
    rs = np.random.RandomState(82)
    args = _baseline_request(rs, batch, views, image, [views] + [views - 3] * (batch - 1),
                             device)
    out, launches = {}, {}
    for name, table_of in (("petr", cr.convert_petr_head), ("mvp", cr.convert_mvp_head)):
        src = baseline_model(name, cfgs, device=device)
        sd = {k: v.detach().cpu() for k, v in src.state_dict().items()}
        table = table_of(sd.keys())
        ref = cr.table_to_reference(sd, table)
        for key, (port, _) in table.items():  # a released dict also holds the reg branch's
            if port is None and key.startswith("reg_branches."):  # aliases at every level
                ref[key] = ref["reg_branches.0." + key.split(".", 2)[2]]
        head_sd, left = cr.apply_table(ref, table)
        via_ref = _load_fresh(name, cfgs, device, {**{k: v for k, v in sd.items()
                                                      if not k.startswith("head.")}, **head_sd},
                              fill=3.0)
        via_flax = _load_fresh(name, cfgs, device, flax_to_state_dict(flax_variables_of(src)),
                               fill=4.0)
        with torch.inference_mode():
            reset_launches()
            want = src(*args)
            got_ref, got_flax = via_ref(*args), via_flax(*args)
            torch.cuda.synchronize()
            launches[name] = read_launches()
        same = {route: all(torch.equal(got[k], want[k]) for k in want)
                for route, got in (("convert_reference", got_ref), ("convert.py", got_flax))}
        n_ref = sum(1 for k in table if k in ref)
        log(f"  {name}: {n_ref} reference keys, {len(head_sd)} head tensors, leftover {left}; "
            f"forward bit-identical to the source: {same}")
        if left or not all(same.values()):
            raise AssertionError(f"{name}: leftover {left}, bit-identical {same}")
        out[name] = dict(reference_keys=n_ref, head_tensors=len(head_sd), same=same,
                         launches=launches[name])
        del src, via_ref, via_flax
    results["baseline_reference"] = out
    return launches


def phase_baseline_times(results, device="cuda", dtype="bf16", cfgs=None, image=256, views=8,
                         buckets=(1, 4, 16), mixed_batch=4, train_batch=4):
    """Phase 10c: each baseline with float32 parameters under ``dtype`` autocast: the
    eval forward at B``buckets`` of all views and at a mixed 2-``views`` B
    ``mixed_batch`` (CUDA events, median of 3 after one warm-up) and its peak GiB;
    one training-mode forward + backward of the summed coordinates at
    B``train_batch`` (mixed views; dropout on, seeded), its time and peak."""
    log("phase 10c: PETR, PETR-FTL and MVP forwards in bf16, and a training forward + backward")
    card = gpu_line()
    on_card = device.startswith("cuda")
    cdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    out, launches = {}, {}
    for name in BASELINE_NAMES:
        model = baseline_model(name, cfgs, dtype=cdt, device=device, param_dtype=torch.float32)
        rs = np.random.RandomState(83)
        reqs = {f"B{b}": _baseline_request(rs, b, views, image, device=device) for b in buckets}
        mixed = mixed_view_mask(rs, mixed_batch, views).sum(1)
        reqs[f"mixed B{mixed_batch}"] = _baseline_request(rs, mixed_batch, views, image, mixed,
                                                          device)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rows = {}
        with torch.inference_mode():
            for key, req in reqs.items():
                res = model(*req)
                if not torch.isfinite(res["pred_verts_3d"]).all():
                    raise AssertionError(f"{name} {key}: non-finite vertices")
                runs = [time_cuda(lambda: model(*req), iters=1, warmup=int(i == 0))
                        for i in range(3)]
                rows[key] = dict(median_ms=float(np.median(runs)), runs_ms=runs)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
        model.train()
        req = reqs[f"mixed B{mixed_batch}"] if train_batch == mixed_batch else \
            _baseline_request(rs, train_batch, views, image, device=device)

        def step():
            with torch.random.fork_rng(devices=[torch.device(device)] if on_card else []):
                torch.manual_seed(84)
                model(*req)["all_coords_preds"].float().sum().backward()

        step()  # warm-up: the backward's kernels and the allocator
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        train_ms = time_cuda(step, iters=1, warmup=0)
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if not grads or not all(torch.isfinite(g).all() for g in grads):
            raise AssertionError(f"{name}: training backward gave no or non-finite gradients")
        launches[name] = read_launches()
        log(f"  {name} {dtype} [{card}]: " + "; ".join(
            f"{k} {r['median_ms']:.2f} ms ({', '.join(f'{t:.2f}' for t in r['runs_ms'])})"
            for k, r in rows.items()) + f"; peak {peak:.2f} GiB; train forward + backward "
            f"B{train_batch} {train_ms:.2f} ms, peak {train_peak:.2f} GiB; launches "
            + (", ".join(f"{k} {v}" for k, v in launches[name].items() if v) or "none"))
        out[name] = dict(requests=rows, peak_gib=peak, train_ms=train_ms,
                         train_peak_gib=train_peak, train_batch=train_batch, card=card,
                         launches=launches[name])
        del model
        if on_card:
            torch.cuda.empty_cache()
    results["baseline_times"] = out
    return launches


def phase_metro_reference(results, device="cuda", cfg=None, image=224, batch=2):
    """Phase 10d: ``create_metro_model``'s weights under the reference's names through
    ``convert_metro_network`` (the blocks' dead BERT embeddings and pooler in the
    reference dict, consumed and dropped) into a fresh model on the card: its
    forward equals the source's bit for bit."""
    from poem_v2_tpu_torch import convert_reference as cr
    from poem_v2_tpu_torch.models.metro import create_metro_model

    log("phase 10d: METRO's weights under the reference names through convert_metro_network")
    src, _ = create_metro_model(cfg, device=device)
    sd = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    table = cr.convert_metro_network(sd.keys())
    ref = cr.table_to_reference(sd, table)
    dead = [k for k, (port, _) in table.items() if port is None]
    ref.update({k: torch.zeros(2) for k in dead})
    converted, left = cr.apply_table(ref, table)
    fresh, _ = create_metro_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    fresh.load_state_dict({**{k: v for k, v in sd.items() if k.startswith("backbone.")},
                           **converted}, strict=True)
    fresh = fresh.to(device)
    img = torch.from_numpy(np.random.RandomState(85).uniform(
        -0.5, 0.5, (batch, image, image, 3)).astype(np.float32)).to(device)
    with torch.inference_mode():
        reset_launches()
        want, got = src(img), fresh(img)
        torch.cuda.synchronize()
        launches = read_launches()
    same = all(torch.equal(got[k], want[k]) for k in want)
    log(f"  {len(converted)} tensors from {len(ref)} reference keys ({len(dead)} dead, dropped), "
        f"leftover {left}; forward bit-identical: {same}")
    if left or not same:
        raise AssertionError(f"METRO converter round trip: leftover {left}, bit-identical {same}")
    results["metro_reference"] = dict(converted=len(converted), reference_keys=len(ref),
                                      dead=len(dead), same=same, launches=launches)
    return launches


# phase 11: the auxiliary models, the MANO fitter and the bucketed KNN. None of them
# reaches a TPU kernel in the JAX package; their launches of K1-K10 are counted and
# printed as ``aux_launches`` (each should be 0)
AUX_SPREAD_FACTOR = 5.0
AUX_TOL = TOL[torch.float32]
FIT_ERR_M = 0.015  # tests/test_fit.py's bound on the mean joint error after the fit


def _outputs(out, prefix=""):
    """A model's outputs as {name: tensor}: dict entries, list / tuple items by index."""
    if isinstance(out, torch.Tensor):
        return {prefix or "out": out}
    items = out.items() if isinstance(out, dict) else enumerate(out)
    flat = {}
    for k, v in items:
        flat.update(_outputs(v, f"{prefix}{k}" if isinstance(out, dict) else f"{prefix}[{k}]"))
    return flat


def _card_vs_cpu(name, model, inputs, device, seed):
    """``model`` (float32, on the CPU) against a copy of it on ``device`` on the same
    inputs, TF32 off: every output within the larger of 1e-4 of its peak and 5 times
    the CPU's own spread when the first input moves by 1e-7 relative. Returns
    (the CPU outputs, the card outputs, rows by output, launches of the card run)."""
    import copy

    nudge = 1.0 + 1e-7 * torch.from_numpy(np.random.RandomState(seed).randn(
        *inputs[0].shape).astype(np.float32))
    dev_model = copy.deepcopy(model).to(device)
    with torch.inference_mode():
        t = time.time()
        want = _outputs(model(*inputs))
        cpu_s = time.time() - t
        nudged = _outputs(model(inputs[0] * nudge, *inputs[1:]))
        reset_launches()
        got = _outputs(dev_model(*(a.to(device) for a in inputs)))
        torch.cuda.synchronize()
        launches = read_launches()
    rows, bad = {}, []
    for k, w in want.items():
        g = got[k].float().cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name} {k}: shape {tuple(g.shape)} vs {tuple(w.shape)}, "
                                 f"finite {bool(torch.isfinite(g).all())}")
        err = float((g - w).abs().max())
        spread = float((nudged[k] - w).abs().max())
        peak = float(w.abs().max())
        lim = max(AUX_TOL * peak, AUX_SPREAD_FACTOR * spread)
        rows[k] = dict(max_abs_err=err, cpu_self=spread, peak=peak, limit=lim)
        if not err <= lim:
            bad.append(k)
    log(f"  {name}: card vs cpu " + ", ".join(
        f"{k} {r['max_abs_err']:.2e} (lim {r['limit']:.2e})" for k, r in rows.items())
        + f"; cpu {cpu_s:.1f} s; launches "
        + (", ".join(f"{k} {v}" for k, v in launches.items() if v) or "none"))
    if bad:
        raise AssertionError(f"{name}: card vs cpu over the limit in {bad}: "
                             f"{ {k: rows[k] for k in bad} }")
    del dev_model
    return want, got, rows, launches


def _time_forwards(name, model, make_input, buckets, dtype, device):
    """bf16 (autocast over float32 parameters) or float32 forwards at each batch of
    ``buckets``: CUDA events, median of 3 after a warm-up; peak GiB; launches."""
    on_card = device.startswith("cuda")
    model = model.to(device)
    cast = torch.autocast(device_type="cuda" if on_card else "cpu", dtype=torch.bfloat16,
                          enabled=dtype == "bf16")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = {}
    with torch.inference_mode(), cast:
        for b in buckets:
            x = make_input(b).to(device)
            runs = [time_cuda(lambda: model(x), iters=1, warmup=int(i == 0)) for i in range(3)]
            rows[f"B{b}"] = dict(median_ms=float(np.median(runs)), runs_ms=runs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    launches = read_launches()
    log(f"  {name} {dtype}: " + "; ".join(
        f"{k} {r['median_ms']:.2f} ms ({', '.join(f'{t:.2f}' for t in r['runs_ms'])})"
        for k, r in rows.items()) + f"; peak {peak:.2f} GiB")
    return dict(requests=rows, peak_gib=peak), launches


def _images(seed, B, size):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        -0.5, 0.5, (B, size, size, 3)).astype(np.float32))


def phase_cmr(results, device="cuda", dtype="bf16", cfg=None, image=256, batch=4,
              buckets=(1, 4), gamma=0.5):
    """Phase 11a: CMR_G at full width (ResNet-18 trunks, OUT_CHANNELS (32, 64, 128,
    256), attention on, with ``gamma`` set nonzero so the attention branch counts)
    in float32, card against the port's CPU forward with the same weights, all five
    outputs (the four mesh levels apart); then bf16 forwards at ``buckets``."""
    from poem_v2_tpu_torch.models.cmr import create_cmr_model

    log(f"phase 11a: CMR_G, {image} px, B{batch}: card vs CPU in float32, then {dtype} forwards")
    model, _ = create_cmr_model(cfg, device="cpu")
    with torch.no_grad():
        model.attention.gamma.fill_(gamma)
    _, _, rows, par_launches = _card_vs_cpu("CMR_G", model, (_images(90, batch, image),),
                                            device, 91)
    times, launches = _time_forwards("CMR_G", model, lambda b: _images(92, b, image), buckets,
                                     dtype, device)
    results["aux_cmr"] = dict(parity=rows, batch=batch, image=image, gamma=gamma, **times,
                              card=gpu_line())
    return {"parity": par_launches, "forwards": launches}


def _darkpose_decode_check(hm_card, hm_cpu):
    """``dark_decode`` on the card's heatmaps against the CPU's: equal to 1e-3 px, except
    where the blurred CPU map's value at the card's argmax ties its maximum to 1e-5
    relative (a near-tie that float32 rounding may flip). Returns (max |d| px over the
    agreeing joints, the near-ties)."""
    from poem_v2_tpu_torch.models.pose2d import dark_decode, gaussian_blur_reflect101

    a, b = dark_decode(hm_card.float().cpu()), dark_decode(hm_cpu)
    d = np.abs(a - b).max(-1)
    ties = 0
    for bi, j in zip(*np.nonzero(d > 1e-3)):
        m = gaussian_blur_reflect101(hm_cpu[bi, j].double().numpy())
        y, x = (int(round(v)) for v in (a[bi, j, 1], a[bi, j, 0]))
        near = [m[yy, xx] for yy in range(max(y - 1, 0), min(y + 2, m.shape[0]))
                for xx in range(max(x - 1, 0), min(x + 2, m.shape[1]))]
        if max(near) < m.max() * (1 - 1e-5):
            raise AssertionError(f"dark_decode: joint ({bi}, {j}) card {a[bi, j]} vs cpu "
                                 f"{b[bi, j]} and no near-tie")
        ties += 1
    return float(d[d <= 1e-3].max()) if (d <= 1e-3).any() else 0.0, ties


def phase_pose2d(results, device="cuda", dtype="bf16", image=256, batch=2, buckets=(1, 4),
                 backbone=None, deconv=256, depth=64, hg=None):
    """Phase 11b: IntegralPose on ResNet-50 (3 deconvs of ``deconv``) with its 2D
    softmax head and a 3D head at ``depth`` depth bins, DarkPose on ResNet-50 with
    ``dark_decode`` of the card's heatmaps against the CPU's, and HourglassBisected
    (``hg``: 256 features, depth 4): float32 card against CPU at B``batch``, then
    bf16 forwards at ``buckets``."""
    from poem_v2_tpu_torch.models import pose2d
    from poem_v2_tpu_torch.models.backbones.hourglass import HourglassBisected
    from poem_v2_tpu_torch.models.poem import init_parameters

    log(f"phase 11b: IntegralPose 2D / 3D, DarkPose, HourglassBisected at {image} px")
    bb = backbone or {"TYPE": "resnet50", "NORM": "gn"}
    head = {"TYPE": "IntegralDeconvHead", "NCLASSES": 21, "NUM_DECONV": 3,
            "DECONV_FEATURES": deconv, "NORM_TYPE": "softmax"}
    hg = hg or {"FEATURES": 256, "DEPTH": 4}
    models = {
        "integral_2d": pose2d.create_integral_pose({"BACKBONE": bb, "HEAD": head}, device="cpu"),
        "integral_3d": pose2d.create_integral_pose(
            {"BACKBONE": bb, "HEAD": {**head, "DEPTH_RESOLUTION": depth}}, device="cpu"),
        "darkpose": pose2d.create_darkpose({"BACKBONE": bb}, device="cpu"),
    }
    hourglass = HourglassBisected.from_config(hg)
    init_parameters(hourglass, torch.Generator().manual_seed(0))
    models["hourglass"] = hourglass.eval()
    out, launches = {}, {}
    for i, (name, model) in enumerate(models.items()):
        nchw = name == "hourglass"

        def make(b, seed=93 + i):
            x = _images(seed, b, image)
            return x.permute(0, 3, 1, 2).contiguous() if nchw else x

        want, got, rows, par = _card_vs_cpu(name, model, (make(batch),), device, 97 + i)
        entry = dict(parity=rows)
        if name == "darkpose":
            err, ties = _darkpose_decode_check(got["heatmap"], want["heatmap"])
            entry["dark_decode"] = dict(max_abs_px=err, near_ties=ties)
            log(f"  dark_decode card vs cpu heatmaps: max {err:.2e} px, near-ties {ties}")
        times, fwd = _time_forwards(name, model, make, buckets, dtype, device)
        out[name] = {**entry, **times}
        launches[f"{name}/parity"], launches[f"{name}/forwards"] = par, fwd
        del model
    results["aux_pose2d"] = dict(out, batch=batch, image=image, card=gpu_line())
    return launches


def fit_scenario(rs: np.random.RandomState, mano, B: int, V: int, image: int = 256):
    """tests/test_fit.py's scenario for B frames of V views: a random pose (0.15 rad)
    and shape (0.2) translated 0.55 m in front of view 0, seen by ``look_at_request``'s
    cameras; the 2D targets are the exact projections. Arrays (target_2d, intr, extr,
    joints, verts)."""
    pose = torch.from_numpy(rs.randn(B, 48).astype(np.float32) * 0.15)
    betas = torch.from_numpy(rs.randn(B, 10).astype(np.float32) * 0.2)
    out = mano(pose, betas)
    tsl = np.array([0.02, -0.01, 0.55], np.float32)
    joints, verts = out.joints.numpy() + tsl, out.verts.numpy() + tsl
    _, intr, extr = look_at_request(rs, B, V, image)
    m2c = np.linalg.inv(extr)
    j_cam = np.einsum("bvij,bnj->bvni", m2c[..., :3, :3], joints) + m2c[..., :3, 3][:, :, None]
    proj = np.einsum("bvni,bvji->bvnj", j_cam, intr)
    return (proj[..., :2] / proj[..., 2:]).astype(np.float32), intr, extr, joints, verts


def phase_fit(results, device="cuda", batch=4, views=8, steps=400, lr=5e-2, silh_size=64,
              silh_batch=2, silh_views=4, silh_steps=30):
    """Phase 11c: the MANO fitter. (1) The objective and its gradient at the identity
    init and at a random state, float32, card against CPU (loss 1e-5 relative, each
    gradient 1e-4 of its peak); (2) tests/test_fit.py's scenario on the card, B
    ``batch`` frames of ``views`` views, ``steps`` steps at ``lr`` with the 3D term:
    the loss falls tenfold and the mean joint error ends under 1.5 cm; (3) one
    ``OneFrameFitSilh`` run at S ``silh_size``: the silhouette loss falls."""
    from poem_v2_tpu_torch.fit import OneFrameFit, OneFrameFitSilh
    from poem_v2_tpu_torch.fit.frame_fit import FitParams, _init_params
    from poem_v2_tpu_torch.fit.soft_raster import (multiview_silhouette_loss, project_to_raster,
                                                   soft_silhouette)
    from poem_v2_tpu_torch.mano.layer import ManoLayer

    log(f"phase 11c: the MANO fitter, B{batch} of {views} views, {steps} steps")
    mano = ManoLayer()
    rs = np.random.RandomState(100)
    target_2d, intr, extr, joints, _ = fit_scenario(rs, mano, batch, views)
    mask = np.ones((batch, views), bool)
    mask[-1, views // 2:] = False  # a frame with padded views
    grads_out = {}
    reset_launches()
    for state in ("identity", "random"):
        init = _init_params(batch)
        if state == "random":
            init = FitParams(init.quat + torch.from_numpy(rs.randn(batch, 16, 4).astype(
                np.float32) * 0.3), torch.from_numpy(rs.randn(batch, 10).astype(np.float32)
                                                     * 0.3), init.tsl)
        init = init._replace(tsl=torch.from_numpy(joints.mean(1)))
        per_dev = {}
        for dev in ("cpu", device):
            fitter = OneFrameFit(mano, lr=lr, steps=steps, w_joint3d=1.0, device=dev)
            p = FitParams(*(a.detach().to(dev, copy=True).requires_grad_(True) for a in init))
            args = [torch.from_numpy(a).to(dev) for a in (target_2d, intr, extr, mask)]
            loss = fitter.loss(p, *args, torch.from_numpy(joints).to(dev))
            loss.backward()
            per_dev[dev] = (float(loss.detach()), [a.grad.cpu() for a in p])
        (lc, gc), (lg, gg) = per_dev["cpu"], per_dev[device]
        errs = [float((g - c).abs().max()) for g, c in zip(gg, gc)]
        peaks = [float(c.abs().max()) for c in gc]
        ok = (abs(lg - lc) <= 1e-5 * abs(lc) and all(torch.isfinite(g).all() for g in gg)
              and all(e <= AUX_TOL * pk for e, pk in zip(errs, peaks)))
        log(f"  {state}: loss card {lg:.7g} cpu {lc:.7g}; gradient error / peak (quat, shape, "
            f"tsl) " + ", ".join(f"{e:.2e} / {pk:.2e}" for e, pk in zip(errs, peaks)))
        if not ok:
            raise AssertionError(f"fit objective at the {state} state: loss {lg} vs {lc}, "
                                 f"gradient errors {errs} over peaks {peaks}")
        grads_out[state] = dict(loss_card=lg, loss_cpu=lc, grad_err=errs, grad_peak=peaks)
    grad_launches = read_launches()

    fitter = OneFrameFit(mano, lr=lr, steps=steps, w_joint3d=1.0, device=device)
    reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    res = fitter.fit(target_2d, intr, extr, mask, target_joints_3d=joints)
    torch.cuda.synchronize()
    fit_s = time.time() - t
    fit_launches = read_launches()
    losses = res.losses.float().cpu().numpy()
    err = float(np.linalg.norm(res.joints.float().cpu().numpy() - joints, axis=-1).mean())
    log(f"  fit {steps} steps in {fit_s:.2f} s: loss {losses[0]:.5g} -> {losses[-1]:.5g}, "
        f"mean joint error {err * 1e3:.3f} mm")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] * 0.1 and err < FIT_ERR_M):
        raise AssertionError(f"fit: losses {losses[0]} -> {losses[-1]}, error {err} m")

    target_s, intr_s, extr_s, joints_s, verts_s = fit_scenario(rs, mano, silh_batch,
                                                                silh_views)
    silh = OneFrameFitSilh(mano, lr=2e-2, steps=silh_steps, img_size=256, device=device)
    faces = silh.faces

    def dev_t(a):
        return torch.as_tensor(a).to(device)

    with torch.no_grad():  # the targets: the true hand's soft silhouettes
        masks = soft_silhouette(project_to_raster(dev_t(verts_s), dev_t(intr_s), dev_t(extr_s),
                                                  256, silh_size), faces, size=silh_size)
    reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    res_s = silh.fit(target_s, intr_s, extr_s, target_joints_3d=joints_s, masks=masks)
    torch.cuda.synchronize()
    silh_s = time.time() - t
    silh_launches = read_launches()
    with torch.no_grad():
        before = float(multiview_silhouette_loss(
            dev_t(intr_s), dev_t(extr_s), dev_t(joints_s.mean(1, keepdims=True)).expand(
                silh_batch, 778, 3), masks, faces, img_size=256))
        after = float(multiview_silhouette_loss(dev_t(intr_s), dev_t(extr_s), res_s.verts,
                                                masks, faces, img_size=256))
    silh_losses = res_s.losses.float().cpu().numpy()
    log(f"  silhouette fit S {silh_size}, B{silh_batch} of {silh_views} views, {silh_steps} "
        f"steps in {silh_s:.2f} s: silhouette loss {before:.4f} -> {after:.4f}, objective "
        f"{silh_losses[0]:.5g} -> {silh_losses[-1]:.5g}")
    if not (np.isfinite(silh_losses).all() and after < before
            and silh_losses[-1] < silh_losses[0]):
        raise AssertionError(f"silhouette fit: {before} -> {after}, objective {silh_losses}")
    results["aux_fit"] = dict(
        objective=grads_out, fit=dict(batch=batch, views=views, steps=steps, seconds=fit_s,
                                      loss_first=float(losses[0]), loss_last=float(losses[-1]),
                                      mean_joint_err_m=err),
        silhouette=dict(size=silh_size, batch=silh_batch, views=silh_views, steps=silh_steps,
                        seconds=silh_s, silhouette_before=before, silhouette_after=after),
        card=gpu_line())
    return {"objective": grad_launches, "fit": fit_launches, "silhouette_fit": silh_launches}


def phase_knn_points_bucketed(results, device="cuda", B=8, Q=799, N=4096, k=32):
    """Phase 11d: ``knn_points_bucketed`` on the 4096-point BPS cloud (the normalised
    ball) for B``B`` x ``Q`` queries, some outside the table's margin: the same
    indices and distances on the card as on the CPU; its time beside the brute-force
    ``knn_points`` (CUDA events)."""
    from poem_v2_tpu_torch.models.heads.ptemb_head import generate_bps_basis

    log(f"phase 11d: knn_points_bucketed, B{B} x {Q} queries on {N} BPS points")
    cloud = generate_bps_basis(N, 0.1) / 0.1
    table = points.VoxelBucketTable(cloud, cell_size=0.25)
    rs = np.random.RandomState(101)
    q = rs.randn(B, Q, 3).astype(np.float32) * 0.5
    q[0, :10] *= 3.0
    want = points.knn_points_bucketed(torch.from_numpy(q), table, k)
    qd = torch.from_numpy(q).to(device)
    reset_launches()
    got = points.knn_points_bucketed(qd, table, k)
    torch.cuda.synchronize()
    launches = read_launches()
    same_idx = torch.equal(got[1].cpu(), want[1])
    same_d = torch.equal(got[0].cpu(), want[0])
    ms = time_cuda(lambda: points.knn_points_bucketed(qd, table, k))
    cloud_d = torch.from_numpy(cloud.astype(np.float32)).to(device)[None].expand(B, N, 3)
    brute_ms = time_cuda(lambda: points.knn_points(qd, cloud_d, k))
    log(f"  indices identical {same_idx}, distances identical {same_d}; {ms:.3f} ms, "
        f"brute-force knn_points {brute_ms:.3f} ms [{gpu_line()}]")
    if not (same_idx and same_d):
        raise AssertionError("knn_points_bucketed: the card's neighbours differ from the CPU's")
    results["aux_knn_bucketed"] = dict(B=B, Q=Q, N=N, k=k, width=table.width, same_indices=True,
                                       ms=ms, brute_force_ms=brute_ms, card=gpu_line())
    return launches


def phase_aux(results, device="cuda", dtype="bf16"):
    """Phase 11: 11a-11d; returns their launches of K1-K10 by path."""
    t = time.time()
    paths = {**{f"cmr/{k}": v for k, v in phase_cmr(results, device, dtype).items()},
             **{f"pose2d/{k}": v for k, v in phase_pose2d(results, device, dtype).items()},
             **{f"fit/{k}": v for k, v in phase_fit(results, device).items()},
             "knn_points_bucketed": phase_knn_points_bucketed(results, device)}
    results["aux_seconds"] = time.time() - t
    log(f"phase 11: {results['aux_seconds']:.1f} s")
    return paths

if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(*sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
