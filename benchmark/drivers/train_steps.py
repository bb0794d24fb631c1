"""Train steps through ``Trainer.step_sharded``, as the train CLI's loop runs them
(``cli/train.py``): a pool of batches held on the device, one step after
another, the metrics read back every ``TRAIN.LOG_INTERVAL`` steps.

Set-up: the pool, the model and Trainer with the seed's weights, and the
first ``warmup_steps`` steps, recorded for the check (``benchmark/training.py``).
The window: the same Trainer on the pool from the next batch on, ended by a
synchronise. End to end: ``train_samples_per_s``, the samples stepped in the
window over the window's seconds. The check: the warm-up steps against the
plain reference once the window has closed and the program is freed, and the
window's own steps by the parameters they moved (``window_unmoved_leaves``).
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from benchmark.harness import Outcome
from benchmark.serving import free_program
from benchmark.train_generator import make_train_pool
from benchmark.train_profile import TrainProfile
from benchmark.training import (StepRecorder, build_trainer, change_norms, first_gradients,
                                judge, leaf_digests, program_record)


def run(ctx) -> Outcome:
    wl, tr, cfg = ctx.cell.workload, ctx.cell.traffic, ctx.cell.config
    if ctx.device.type == "cuda":
        # the train CLI's CONV_REPEATABLE default: deterministic convolutions
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    pool = make_train_pool(tr, ctx.seed, ctx.device)
    trainer, shapes = build_trainer(cfg, ctx.seed, ctx.device, wl["compute_dtype"])
    rec = StepRecorder(trainer)
    warm = wl["warmup_steps"]
    for i in range(warm):
        rec.step(pool[i % len(pool)])
        if i == 0:
            grads = first_gradients(trainer)
    rec.detach()
    change = change_norms(trainer.model, shapes, ctx.seed, ctx.device)
    program = program_record(rec, grads, change)
    before = leaf_digests(trainer.model)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    optimizer = trainer.optimizer
    if ctx.trace:
        step = optimizer.step

        def traced_step():
            with torch.profiler.record_function("bench.optim"):
                step()

        optimizer.step = traced_step
    log_every = int(cfg["TRAIN"].get("LOG_INTERVAL", 10))
    prof = TrainProfile(ctx.trace, wl["profile_steps"])
    ends, n, pending, seen = [], 0, [], []
    ctx.mark_window()
    with prof:
        t0 = time.perf_counter()
        while True:
            with prof.step_range():
                pending.append(trainer.step_sharded(pool[(warm + n) % len(pool)]))
            if n % log_every == 0:
                seen += [float(m["loss"]) for m in pending]  # the CLI's read-back at a log step
                pending.clear()
            prof.step()
            ends.append(time.perf_counter())
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        elapsed = time.perf_counter() - t0
    peak = ctx.memory_peak()
    program["window"] = (before, leaf_digests(trainer.model))
    B = tr["batch"]
    tail = prof.untraced_tail(
        ends, t0 + elapsed,
        lambda k: pool[(warm + k) % len(pool)]["view_mask"].sum(1).tolist())
    seen += [float(m["loss"]) for m in pending]
    finite = all(math.isfinite(v) for v in seen)
    steps = rec.steps
    del trainer, rec, optimizer, pending
    pool = None
    free_program()

    checks = judge(program, steps, cfg, shapes, ctx.seed, ctx.device, wl["reference_chunk"])
    limits = wl["limits"]
    print("looks " + json.dumps({"numbers": checks, "phases_s": prof.phases,
                                 "device_groups_s": prof.groups}), file=sys.stderr)
    return Outcome(attempted=n * B, failed=0 if finite else n * B, setup_s=setup_s,
                   end_to_end={"train_samples_per_s": n * B / elapsed},
                   checks={k: (checks[k], lim) for k, lim in limits.items()},
                   memory_peak_bytes=peak, trace=prof.trace,
                   facts=dict(tail, param_shapes=shapes, device_groups_s=prof.groups,
                              phases=prof.phases))
