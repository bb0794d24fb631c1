"""Readings that the output checks' limits are set from, for one cell, in one
process (set-up once, weights and traffic anew for each seed):

* the program's numbers over many seeds: the timed path (``Predictor.__call__``
  over every batch of the pool) against the float32 reference, as a run
  compares them, and a look at each sample's absolute gap beside its valid
  views and its DLT's sensitivity to 2D noise (:func:`dlt_look`);
* the control's numbers on a few seeds: the reference in the precision below
  the configuration's (fp8 products for bf16 compute) in the program's place.

    python benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3

Prints one JSON line a reading and a summary line. Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

harness.set_cache_env()

import torch  # noqa: E402

from benchmark.generator import make_pool  # noqa: E402
from benchmark.reference.poem_ref import Precision, Reference, float32_matmuls, load_constants  # noqa: E402
from benchmark.serving import (DTYPES, build_predictor, gaps, judge, reference_outputs,  # noqa: E402
                               reference_weights, summarize, weight_seed)
from benchmark.weights import load_into, make_weights  # noqa: E402


OUT = None  # a file that keeps every line besides standard output


def line(**kw):
    text = json.dumps(kw)
    print(text, flush=True)
    if OUT is not None:
        with open(OUT, "a") as f:
            f.write(text + "\n")


def serve_readings(cell, seeds, control_seeds, dev):
    tr, wl, cfg = cell.traffic, cell.workload, cell.config
    pred, shapes = build_predictor(cfg, tr, seeds[0], dev)
    out = {"program": [], "control": []}
    for s in seeds:
        load_into(pred.model, make_weights(shapes, weight_seed(s), dev))
        pool = make_pool(tr, s, dev)
        answers = [(i, pred(b["image"], b["cam_intr"], b["cam_extr"], b["view_mask"]))
                   for i, b in enumerate(pool)]
        wanted = {}
        r = summarize(judge(answers, pool, cfg, s, shapes, dev, wl["reference_chunk"],
                            wanted=wanted))
        out["program"].append(r)
        line(kind="program", seed=s, **r)
        line(kind="dlt_look", seed=s, **dlt_look(answers, wanted, pool, s, dev))
    del pred
    for s in control_seeds:
        pool = make_pool(tr, s, dev)
        w = reference_weights(shapes, s, dev, DTYPES[cfg["serve_dtype"]])
        consts = load_constants(cfg["MODEL"], dev)
        ref32 = Reference(w, cfg["MODEL"], consts, Precision("float32"))
        ref8 = Reference(w, cfg["MODEL"], consts, Precision("fp8"))
        per = []
        with float32_matmuls():
            for b in pool:
                want = reference_outputs(ref32, b, dev, wl["reference_chunk"])
                got = reference_outputs(ref8, b, dev, wl["reference_chunk"])
                per.append(gaps(got, want, b["view_mask"]))
        r = summarize(per)
        out["control"].append(r)
        line(kind="control_fp8", seed=s, **r)
    return out


def dlt_look(answers, wanted, pool, seed, dev, noise_px: float = 0.2):
    """Each sample's absolute RMS gap (m) beside its valid views and its DLT's
    sensitivity: the RMS shift (m) of the reference's triangulated joints when
    its 2D joints move by seeded Gaussian noise of ``noise_px``. Gives, by valid
    views, the largest gap and the largest sensitivity, and the worst samples."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for i, ans in answers:
        b, want = pool[i], wanted[i]
        mask = torch.as_tensor(b["view_mask"], device=dev)
        m2c = Reference.world_to_cam(torch.as_tensor(b["cam_extr"], device=dev))
        intr = torch.as_tensor(b["cam_intr"], device=dev)
        uv = torch.as_tensor(want["joints_uv"], device=dev)
        tri = Reference.dlt(uv, intr, m2c, mask)
        moved = Reference.dlt(uv + noise_px * torch.randn(uv.shape, generator=gen, device=dev),
                              intr, m2c, mask)
        shift = ((moved - tri).double() ** 2).sum(-1).mean(-1).sqrt().cpu().numpy()
        for s in range(len(mask)):
            d = np.concatenate([(ans[k][s] - want[k][s]).ravel() for k in ("joints_3d", "verts_3d")])
            rows.append((int(b["view_mask"][s].sum()), float(np.sqrt(np.mean(d.astype(np.float64) ** 2))),
                         float(shift[s])))
    by_views = {}
    for v, gap, sens in rows:
        g, se = by_views.get(v, (0.0, 0.0))
        by_views[v] = (max(g, gap), max(se, sens))
    worst = sorted(rows, key=lambda r: -r[1])[:5]
    return {"max_rms_gap_and_sensitivity_by_views": {str(k): v for k, v in sorted(by_views.items())},
            "worst_samples_views_gap_sensitivity": worst}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None, help="also append every line to this file")
    args = ap.parse_args()
    global OUT
    OUT = args.out
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    control = seeds[:args.control_seeds]
    t = time.perf_counter()
    out = serve_readings(cell, seeds, control, torch.device("cuda"))
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
