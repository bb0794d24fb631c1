"""Set-up and the output check of the serving cells (drivers ``serve_batches``
and ``closed_loop``): the Predictor over a model with seeded weights in the
served dtype, and the plain reference over the same weights, judged answer by
answer once the window has closed."""

from __future__ import annotations

import gc
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference.poem_ref import Precision, Reference, float32_matmuls, load_constants
from .weights import load_into, make_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def weight_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)[0] >> 1)


def build_predictor(config: dict, traffic: dict, seed: int, device):
    """(Predictor, parameter shapes): the program's serving path with the seed's
    weights, rounded to the served dtype."""
    from poem_v2_tpu_torch.models.poem import create_poem_model
    from poem_v2_tpu_torch.serving.predictor import Predictor

    dtype = DTYPES[config["serve_dtype"]]
    model, _ = create_poem_model(config["MODEL"], dtype=dtype, device=device)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    load_into(model, make_weights(shapes, weight_seed(seed), device))
    return Predictor(model, view_bucket=traffic["view_bucket"],
                     image_size=traffic["image_size"]), shapes


def reference_weights(shapes, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The served values (the seed's weights rounded to ``dtype``) as float32."""
    return {k: v.to(dtype).float() for k, v in make_weights(shapes, weight_seed(seed), device).items()}


def free_program() -> None:
    """Return the program's freed memory to the card (the caller drops its references)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def images_as_float(img: np.ndarray, device) -> torch.Tensor:
    t = torch.as_tensor(img).to(device)
    return t.float() / 255.0 - 0.5 if t.dtype == torch.uint8 else t.float()


@torch.no_grad()
def reference_outputs(ref: Reference, batch: Dict[str, np.ndarray], device, chunk: int):
    """joints_3d, verts_3d (B, ...) and joints_uv (B, V, 21, 2) of the reference, numpy."""
    B = batch["image"].shape[0]
    outs = {"joints_3d": [], "verts_3d": [], "joints_uv": []}
    for s in range(0, B, chunk):
        rows = slice(s, s + chunk)
        t = lambda k, dt=torch.float32: torch.as_tensor(batch[k][rows]).to(device, dt)
        o = ref.forward(images_as_float(batch["image"][rows], device), t("view_mask", torch.bool),
                        t("cam_intr"), t("cam_extr"))
        last = o["coords"][-1]
        outs["joints_3d"].append(last[:, :21].cpu().numpy())
        outs["verts_3d"].append(last[:, 21:].cpu().numpy())
        outs["joints_uv"].append(o["joints_uv"].cpu().numpy())
    return {k: np.concatenate(v) for k, v in outs.items()}


def gaps(answer: Dict[str, np.ndarray], want: Dict[str, np.ndarray], mask: np.ndarray):
    """One answer's gaps to the reference: the widest and the root-mean-square 3D
    gap (m) over joints and vertices, the same over the samples of 3 or more
    valid views alone (``coords3_``; NaN where there are none), the same of the
    root-relative joints and vertices, and the widest 2D gap (px) over valid views."""
    def flat(d, rel):
        root = d["joints_3d"][:, :1] if rel else 0.0
        return np.concatenate([(d[k] - root).reshape(len(mask), -1)
                               for k in ("joints_3d", "verts_3d")], axis=1)

    out = {}
    three = mask.sum(1) >= 3
    for rel, tag, rows in ((False, "coords", slice(None)), (False, "coords3", three),
                           (True, "rel_coords", slice(None))):
        d3 = (flat(answer, rel) - flat(want, rel)).astype(np.float64)[rows]
        out[f"{tag}_gap_m"] = float(np.abs(d3).max()) if d3.size else math.nan
        out[f"{tag}_rms_gap_m"] = float(np.sqrt(np.mean(d3 ** 2))) if d3.size else math.nan
    d2 = np.abs(answer["joints_uv"] - want["joints_uv"]).max(axis=(2, 3))
    out["uv_gap_px"] = float(d2[mask].max())
    return out


INF = {k: math.inf for k in ("coords_gap_m", "coords_rms_gap_m", "coords3_gap_m",
                             "coords3_rms_gap_m", "rel_coords_gap_m", "rel_coords_rms_gap_m",
                             "uv_gap_px")}


def summarize(per_answer: List[Dict[str, float]]) -> Dict[str, float]:
    """The window's numbers: each widest gap over all answers, each RMS over all
    (answers with no sample of a number's kind left out of it)."""
    out = {}
    for k in INF:
        vals = [a[k] for a in per_answer if not math.isnan(a[k])]
        out[k] = math.nan if not vals else max(vals) if "_rms_" not in k else \
            math.sqrt(sum(v ** 2 for v in vals) / len(vals))
    return out


def checks_and_failures(per_answer: List[Dict[str, float]], limits: Dict[str, float]):
    """(name -> (the window's number, its limit) for each number the cell limits,
    the answers that are not finite)."""
    total = summarize(per_answer)
    failed = sum(1 for a in per_answer
                 if not all(math.isfinite(v) for k, v in a.items() if not k.startswith("coords3")))
    return {k: (total[k], lim) for k, lim in limits.items()}, failed


def judge(answers: List[Tuple[int, Dict[str, np.ndarray]]], pool, config: dict, seed: int,
          shapes, device, chunk: int, precision: str = "float32", wanted=None):
    """The gaps (:func:`gaps`) of every answer against the reference of its batch;
    an answer that is not finite reads infinite. ``wanted``, a dict, if given,
    receives the reference's outputs by pool index."""
    consts = load_constants(config["MODEL"], device)
    ref = Reference(reference_weights(shapes, seed, device, DTYPES[config["serve_dtype"]]),
                    config["MODEL"], consts, Precision(precision))
    wanted, out = ({} if wanted is None else wanted), []
    with float32_matmuls():
        for i, ans in answers:
            if i not in wanted:
                wanted[i] = reference_outputs(ref, pool[i], device, chunk)
            if not all(np.isfinite(v).all() for v in ans.values()):
                out.append(dict(INF))
            else:
                out.append(gaps(ans, wanted[i], pool[i]["view_mask"]))
    return out
