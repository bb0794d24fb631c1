"""Offline batches of the PtEmbedTRv3 model through ``Predictor.__call__``: the set-up
and the window of ``serve_batches`` (one caller that always has the next batch ready,
cycling a pool of distinct batches made at set-up), the check against the v3
reference (``serving_v3.judge``), and with ``--trace 1`` also the spans ``metro``
(each METRO encoder block) and ``metro_attention`` (each of its attention modules).

End to end: ``serve_samples_per_s``, every sample returned in the window over
the window's time."""

from __future__ import annotations

import time

from benchmark.drivers.serve_batches import call
from benchmark.generator import make_pool
from benchmark.harness import BoundedProfile, Outcome, Spans
from benchmark.serving import build_predictor, checks_and_failures, free_program
from benchmark.serving_v3 import judge


def attach_metro(spans: Spans, model) -> None:
    tr = model.head.transformer
    for i in range(tr.n_metro):
        block = getattr(tr, f"metro_block_{i}")
        spans.attach(block, "metro")
        for j in range(block.num_layers):
            spans.attach(getattr(block, f"layer{j}_attn"), "metro_attention")


def run(ctx) -> Outcome:
    wl, tr = ctx.cell.workload, ctx.cell.traffic
    pool = make_pool(tr, ctx.seed, ctx.device)
    pred, shapes = build_predictor(ctx.cell.config, tr, ctx.seed, ctx.device)
    for i in range(wl["warmup_calls"]):
        call(pred, pool[i % len(pool)])
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    spans = Spans()
    if ctx.trace:
        spans.attach_model(pred.model)
        attach_metro(spans, pred.model)
    answers, n = [], 0
    prof = BoundedProfile(ctx.trace, wl["profile_steps"])
    ends = []  # each window step's end, host clock
    with prof:
        t0 = time.perf_counter()
        while True:
            i = n % len(pool)
            with prof.step_range():
                answers.append((i, call(pred, pool[i])))
            prof.step()
            ends.append(time.perf_counter())
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        elapsed = time.perf_counter() - t0
    spans.remove()
    peak = ctx.memory_peak()
    tail = prof.untraced_tail(
        ends, t0 + elapsed, lambda k: pool[k % len(pool)]["view_mask"].sum(1).tolist())
    del pred
    free_program()

    per_answer = judge(answers, pool, ctx.cell.config, ctx.seed, shapes, ctx.device,
                       wl["reference_chunk"])
    checks, failed = checks_and_failures(per_answer, wl["limits"])
    B = tr["batch"]
    return Outcome(attempted=n * B, failed=failed * B, setup_s=setup_s,
                   end_to_end={"serve_samples_per_s": n * B / elapsed},
                   checks=checks,
                   memory_peak_bytes=peak, trace=prof.trace,
                   facts=dict(tail, param_shapes=shapes))
