"""Readings that the training cells' check limits are set from, for one cell, in
one process (the model built once; weights, traffic and Trainer anew a seed):

* ``program``: the timed path's first steps (``Trainer.step_sharded`` through
  :class:`~benchmark.training.StepRecorder`, as a run's set-up drives them)
  against the float32 reference, each number of ``training.compare``;
* ``control_fp8``: the reference with every product's operands in fp8 e4m3,
  choosing its neighbours by the packed key from fp8-rounded coordinates, in
  the program's place (the same steps, draws and dropout masks);
* ``fault_half_batch``: the reference with each step's loss taken over the
  first half of its batch alone, the mean over those samples, in the program's
  place.

    python benchmark/calibrate_train.py --workload <cell> --seeds 12 --control-seeds 6 \\
        --fault-seeds 3

Prints one JSON line a reading and a summary line. Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

harness.set_cache_env()

import torch  # noqa: E402

from benchmark.train_generator import make_train_pool  # noqa: E402
from benchmark.training import (StepRecorder, build_model, change_norms, compare,  # noqa: E402
                                first_gradients, program_record, run_reference,
                                seeded_trainer)

OUT = None  # a file that keeps every line besides standard output


def line(**kw):
    text = json.dumps(kw)
    print(text, flush=True)
    if OUT is not None:
        with open(OUT, "a") as f:
            f.write(text + "\n")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def record_program(built, cell, seed, dev, steps):
    """The program's first ``steps`` steps on the seed's pool, recorded."""
    model, aux, shapes = built
    pool = make_train_pool(cell.traffic, seed, dev)
    trainer = seeded_trainer(model, aux, shapes, cell.config, seed, dev)
    rec = StepRecorder(trainer)
    grads = None
    for i in range(steps):
        rec.step(pool[i])
        if i == 0:
            grads = first_gradients(trainer)
    rec.detach()
    change = change_norms(model, shapes, seed, dev)
    return program_record(rec, grads, change), rec.steps


def training_readings(cell, seeds, control_seeds, fault_seeds, dev):
    cfg, wl = cell.config, cell.workload
    built = build_model(cfg, dev, wl["compute_dtype"])
    shapes, chunk = built[2], wl["reference_chunk"]
    out = {"program": [], "control_fp8": [], "fault_half_batch": []}
    for s in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t = time.perf_counter()
        program, steps = record_program(built, cell, s, dev, wl["warmup_steps"])
        sync(dev)
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        ref = run_reference(cfg, shapes, s, steps, dev, chunk)
        sync(dev)
        t_ref = time.perf_counter() - t
        if s in seeds:
            r = compare(program, ref)
            out["program"].append(r)
            line(kind="program", seed=s, program_s=t_prog, reference_s=t_ref,
                 loss=program["loss"], ref_loss=ref["loss"], **r)
        if s in control_seeds:
            ctl = run_reference(cfg, shapes, s, steps, dev, chunk, precision="fp8",
                                select="packed", select_rounded=True)
            held = [dict(st, indices=[i for _, _, i in ch]) for st, ch in zip(steps, ctl["chosen"])]
            ref_c = run_reference(cfg, shapes, s, held, dev, chunk)
            r = compare(ctl, ref_c)
            out["control_fp8"].append(r)
            line(kind="control_fp8", seed=s, **r)
        if s in fault_seeds:
            half = run_reference(cfg, shapes, s, steps, dev, chunk, half=True)
            r = compare(half, ref)
            out["fault_half_batch"].append(r)
            line(kind="fault_half_batch", seed=s, **r)
        del program, steps, ref
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=6)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_100_000_000)
    ap.add_argument("--out", default=None, help="also append every line to this file")
    args = ap.parse_args()
    global OUT
    OUT = args.out
    if not torch.cuda.is_available():
        print("calibrate_train needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    t = time.perf_counter()
    out = training_readings(cell, seeds, seeds[:args.control_seeds], seeds[:args.fault_seeds],
                            dev)
    summary = {}
    for kind, rows in out.items():
        for key in (rows[0] if rows else {}):
            vals = [r[key] for r in rows]
            summary[f"{kind}.{key}"] = {"min": min(vals), "max": max(vals)}
    line(kind="summary", workload=args.workload, seconds=time.perf_counter() - t,
         card=torch.cuda.get_device_name(0), **summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
