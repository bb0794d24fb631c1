"""One client that sends a request through ``Predictor.__call__`` and sends the
next only once it holds the reply (a closed loop of one), over a pool of
distinct requests made at set-up.

End to end: ``request_ms_p95`` over every request of the window, each timed
from its send to its numpy outputs in hand."""

from __future__ import annotations

import time

import numpy as np

from benchmark.generator import make_pool
from benchmark.harness import BoundedProfile, Outcome, Spans
from benchmark.serving import build_predictor, checks_and_failures, free_program, judge


def run(ctx) -> Outcome:
    wl, tr = ctx.cell.workload, ctx.cell.traffic
    pool = make_pool(tr, ctx.seed, ctx.device)
    pred, shapes = build_predictor(ctx.cell.config, tr, ctx.seed, ctx.device)

    def send(b):
        return pred(b["image"], b["cam_intr"], b["cam_extr"], b["view_mask"])

    for i in range(wl["warmup_calls"]):
        send(pool[i % len(pool)])
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    spans = Spans()
    if ctx.trace:
        spans.attach_model(pred.model)
    answers, lat_ms, n = [], [], 0
    prof = BoundedProfile(ctx.trace, wl["profile_steps"])
    ends = []  # each window step's end, host clock
    with prof:
        t0 = time.perf_counter()
        while True:
            i = n % len(pool)
            with prof.step_range():
                t = time.perf_counter()
                out = send(pool[i])
                lat_ms.append((time.perf_counter() - t) * 1e3)
            answers.append((i, out))
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
    del pred, send
    free_program()

    per_answer = judge(answers, pool, ctx.cell.config, ctx.seed, shapes, ctx.device,
                       wl["reference_chunk"])
    checks, failed = checks_and_failures(per_answer, wl["limits"])
    return Outcome(attempted=n, failed=failed, setup_s=setup_s,
                   end_to_end={"request_ms_p95": float(np.percentile(lat_ms, 95))},
                   checks=checks,
                   memory_peak_bytes=peak, trace=prof.trace,
                   facts=dict(tail, param_shapes=shapes))
