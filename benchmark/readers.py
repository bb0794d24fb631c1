"""What the per-layer metrics read from a traced run (``benchmark/metrics/<name>.py``
each call one of these). A reader that finds nothing to read returns None and
the metric is left out of the result line; no reader returns 0 for a share."""

from __future__ import annotations

from typing import Optional

from .counts.kernels import anchor_attention_flops, bound_ms, knn_attention_flops, vector_block_bytes
from .counts.model import forward_flops
from .counts.peaks import PEAK_FLOPS


def idle_pct(out) -> Optional[float]:
    """Share of an untraced step in which the device is idle: 1 - the device's
    busy time a step on the timeline (the union of the kernels', copies' and
    sets' intervals) over the host-clock time a step of the window's untraced
    steps after the profiles. The traced steps themselves run slower by the
    profiler's cost a launch, which is no idle time of the program's."""
    t, steps, seconds = out.trace, out.facts.get("tail_steps", 0), out.facts.get("tail_seconds", 0.0)
    if t is None or t.busy_s <= 0 or steps <= 0 or seconds <= 0:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.steps) / (seconds / steps))


def per_step_ms(out, *spans: str) -> Optional[float]:
    """Device ms a profiled step of the kernels launched inside the named spans."""
    t = out.trace
    if t is None or not any(t.span_calls.get(s) for s in spans):
        return None
    total = sum(t.span_device_s.get(s, 0.0) for s in spans)
    return 1e3 * total / t.steps if total > 0 else None


def launches_per_step(out) -> Optional[float]:
    t = out.trace
    return t.launches / t.steps if t is not None and t.launches else None


def mfu(out, cell) -> Optional[float]:
    """The model's forward operations (valid views only) of every sample the
    window completed after its profiles, over the
    host-clock seconds those steps took, as a share of the bf16 peak. Those
    steps ran untraced: the profiled ones run slower by the profiler's cost."""
    views, seconds = out.facts.get("tail_views", []), out.facts.get("tail_seconds", 0.0)
    if out.trace is None or not views or seconds <= 0:
        return None
    cfg = cell.config["MODEL"]
    size = cell.traffic["image_size"]
    shapes = out.facts["param_shapes"]
    ops = sum(forward_flops(cfg, shapes, v, size) for v in views)
    return 100.0 * ops / seconds / PEAK_FLOPS["bfloat16"]


def _dims(cell):
    head = cell.config["MODEL"]["HEAD"]
    tr = head["TRANSFORMER"]
    return (cell.traffic["batch"], head["NUM_QUERY"], head["N_SAMPLE"],
            head["EMBED_DIMS"], tr["N_NEIGHBOR_QUERY"], tr["N_NEIGHBOR"], tr["N_BLOCKS"])


def vector_modules_least_ms(cell, anchors: int = 32) -> float:
    """Least bf16 time of one forward's vector-attention modules: per block the
    self module (queries among themselves) and the cross module (queries over
    the BPS cloud), each its fc1 / w_qs / fc2 products and the attention's least
    work (block 0 over the fixed anchors, K2; the others over K nearest, K1)."""
    B, M, N, D, k_self, k_cross, blocks = _dims(cell)
    total = 0.0
    for i in range(blocks):
        for n_cloud, k in ((M, k_self), (N, k_cross)):
            lin = 2.0 * D * D * B * (2 * M + n_cloud)          # w_qs and fc2 on queries, fc1 on the cloud
            att = anchor_attention_flops(B, M, anchors, D) if i == 0 else \
                knn_attention_flops(B, M, k, n_cloud, D)
            total += bound_ms(vector_block_bytes(B, M, n_cloud, D, 2), lin + att)[0]
    return total


def knn_roofline(out, cell) -> Optional[float]:
    """The vector-attention modules' least time over their device time (%)."""
    t = out.trace
    dev_s = t.span_device_s.get("vector_attention", 0.0) if t is not None else 0.0
    if dev_s <= 0:
        return None
    return 100.0 * vector_modules_least_ms(cell) * t.steps / 1e3 / dev_s
