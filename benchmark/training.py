"""Set-up and the output check of the training cells (driver ``train_steps``).

Set-up builds one Trainer over a model with the seed's weights, as the train
CLI builds them (float32 parameters, compute in the workload's dtype, the dense
attention kernel and K6 in training), and drives it through its first steps by
``Trainer.step_sharded`` on the first batches of the pool, the window's own call
and feed. While those steps run, :class:`StepRecorder` keeps what the reference
needs to follow them (each step's jitter draws, the decoder's dropout masks and
neighbour choices) and what is judged (each step's loss and last-block
predictions, the first gradient as the optimiser holds it, the parameters'
change). The same Trainer then runs the window. Once the window has closed and
the program is freed, :func:`judge` runs the plain reference over the same
steps and compares (:func:`compare`).
"""

from __future__ import annotations

import collections
import math
import statistics
from typing import Dict, List

import numpy as np
import torch

from .reference.poem_ref import Precision, float32_matmuls, load_constants
from .reference.train_ref import GROUPS, follow_steps, group_of, invalid_rows
from .serving import DTYPES, weight_seed
from .weights import load_into, make_weights

B1 = 0.9  # Adam's first-moment decay: its state after one step holds (1 - B1) x the gradient


def trainer_seed(seed: int) -> int:
    """The seed of the Trainer's generator (jitter draws and dropout seeds)."""
    return int(np.random.SeedSequence([seed, 3]).generate_state(1, np.uint64)[0] >> 2)


def steps_per_epoch(config: dict) -> int:
    """The release's steps an epoch (``cli/train.py``): EPOCH_SIZE // BATCH_SIZE."""
    return int(config.get("steps_per_epoch", 210000 // config["TRAIN"]["BATCH_SIZE"]))


def build_model(config: dict, device, dtype: str):
    """(model, aux, parameter shapes): the train CLI's model (float32 parameters,
    compute in ``dtype``), before the seed's weights."""
    from poem_v2_tpu_torch.models.poem import create_poem_model

    model, aux = create_poem_model(config["MODEL"], dtype=DTYPES[dtype],
                                   param_dtype=torch.float32, device=device,
                                   use_flash_train=True,
                                   generator=torch.Generator().manual_seed(
                                       int(config["TRAIN"].get("MANUAL_SEED", 1))))
    return model, aux, [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def seeded_trainer(model, aux, shapes, config: dict, seed: int, device):
    """A new Trainer over ``model`` with the seed's weights loaded."""
    from poem_v2_tpu_torch.training.trainer import Trainer

    load_into(model, make_weights(shapes, weight_seed(seed), device))
    return Trainer(model, aux, train_cfg=config["TRAIN"], loss_cfg=config["MODEL"]["LOSS"],
                   steps_per_epoch=steps_per_epoch(config), seed=trainer_seed(seed))


def build_trainer(config: dict, seed: int, device, dtype: str):
    """(Trainer, parameter shapes): the train CLI's model and Trainer with the
    seed's float32 weights."""
    model, aux, shapes = build_model(config, device, dtype)
    return seeded_trainer(model, aux, shapes, config, seed, device), shapes


def draw_ref_noise(generator: torch.Generator, batch: int, num_joints: int = 21):
    """A copy of the train step's jitter draws (``models/poem.py:draw_ref_noise``):
    normal (B, J, 3), normal (1,), uniform (1,) from the generator."""
    dev = generator.device
    return (torch.randn((batch, num_joints, 3), generator=generator, device=dev),
            torch.randn((1,), generator=generator, device=dev),
            torch.rand((1,), generator=generator, device=dev))


class StepRecorder:
    """Keeps, for each step run while it is attached, what the reference needs and
    what is judged. Dropout masks come from forward hooks on the decoder's dropout
    modules (kept where the output is not zero, or the input was), the neighbour
    choices from the K-nearest-neighbour calls of the forward (the trainable
    attention's selection), the predictions from a forward hook on the model. The
    recompute of the checkpointed blocks in the backward repeats the forward's
    masks and replays its kernel outputs; it records nothing."""

    def __init__(self, trainer):
        from poem_v2_tpu_torch.ops import knn_attn

        self.trainer, self.model = trainer, trainer.model
        self.steps: List[dict] = []
        self.recording = False
        self.handles = []
        self._knn_attn = knn_attn
        self._select = knn_attn.fused_knn_vector_attention
        self._knn = self._wrap_select()
        blocks = [m for n, m in sorted(self.model.head.transformer.named_children())]
        for i, blk in enumerate(blocks):
            sites = [("q_emb", blk.drop), ("attn", blk.attn.drop),
                     ("cross_attn", blk.cross_attn.drop), ("ffn", blk.ffn.drop)]
            for site, mod in sites:
                self.handles.append(mod.register_forward_hook(self._mask_hook(i, site)))
        self.handles.append(self.model.register_forward_pre_hook(self._start))
        self.handles.append(self.model.register_forward_hook(self._stop))
        # the kernel's wrapper counts its launches on the module's function
        self._knn.launches = self._select.launches
        knn_attn.fused_knn_vector_attention = self._knn
        self.n_blocks = len(blocks)

    def _mask_hook(self, i, site):
        def hook(_m, args, out):
            if not self.recording:
                return
            keep = ((out != 0) | (args[0] == 0)).cpu()
            masks = self.steps[-1]["masks"][i]
            # a block's shared embedding dropout runs on the queries, then the cloud
            masks["k_emb" if site == "q_emb" and "q_emb" in masks else site] = keep
        return hook

    def _start(self, _m, _args):
        self.recording = True

    def _stop(self, _m, _args, out):
        self.recording = False
        self.steps[-1]["coords"] = out["all_coords_preds"][-1].detach().float().cpu()

    def _record_knn(self, query_xyz, pt_xyz, idx) -> None:
        if self.recording:
            self.steps[-1]["indices"].append(idx.detach().long().cpu())
            self.steps[-1]["knn"].append((query_xyz.detach().float().cpu(),
                                          pt_xyz.detach().float().cpu()))

    def _wrap_select(self):
        select, record = self._select, self._record_knn

        def fused_knn_vector_attention(q, query_xyz, pt_xyz, *args, **kwargs):
            out = select(q, query_xyz, pt_xyz, *args, **kwargs)
            if kwargs.get("return_idx"):
                record(query_xyz, pt_xyz, out[1])
            return out

        return fused_knn_vector_attention

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One ``Trainer.step_sharded`` on ``batch``, recorded."""
        gen = torch.Generator(device=self.trainer.generator.device)
        gen.set_state(self.trainer.generator.get_state())
        draws = draw_ref_noise(gen, batch["image"].shape[0])
        self.steps.append({"batch": batch, "draws": [d.cpu() for d in draws],
                           "masks": [{} for _ in range(self.n_blocks)], "indices": [],
                           "knn": []})
        metrics = self.trainer.step_sharded(batch)
        self.steps[-1]["loss"] = float(metrics["loss"])
        return metrics

    def detach(self) -> None:
        for h in self.handles:
            h.remove()
        self._select.launches = self._knn.launches
        self._knn_attn.fused_knn_vector_attention = self._select


@torch.no_grad()
def first_gradients(trainer) -> Dict[str, torch.Tensor]:
    """The first gradient as the optimiser holds it after one step (Adam's first
    moment over 1 - b1: the clipped gradient), a parameter, on the host."""
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    return {n: (m / (1 - B1)).cpu() for n, m in zip(names, trainer.optimizer.mu)}


@torch.no_grad()
def change_norms(model, shapes, seed: int, device) -> Dict[str, float]:
    """The norm of each parameter's change from the seed's weights."""
    start = make_weights(shapes, weight_seed(seed), device)
    out = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    del start
    return out


@torch.no_grad()
def leaf_digests(model) -> torch.Tensor:
    """(parameters, 2): each parameter's sum and sum of squares in float64, on the
    host. A step that moves a parameter changes its row."""
    rows = [torch.stack([p.double().sum(), p.double().square().sum()])
            for p in model.parameters()]
    return torch.stack(rows).cpu()


def program_record(rec: StepRecorder, grads: Dict[str, torch.Tensor],
                   change: Dict[str, float]) -> dict:
    """The program's side in :func:`compare`'s terms."""
    return {"loss": [s["loss"] for s in rec.steps], "coords": [s["coords"] for s in rec.steps],
            "grad_clipped": {k: float(g.norm()) for k, g in grads.items()},
            "grad_tensors": grads, "change": change,
            "chosen": [[(q, c, i) for (q, c), i in zip(s["knn"], s["indices"])]
                       for s in rec.steps]}


def leaf_gaps(test: Dict[str, float], ref: Dict[str, float], keys) -> List[float]:
    """The gap between the two sides' norms of each parameter ``keys``, against the
    larger of the reference's norm of that parameter and the median parameter's."""
    med = statistics.median(ref.values())
    return [abs(test[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def group_diff(test: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> float:
    """The norm of the two sides' difference over the parameters ``keys`` against
    the norm of the reference's."""
    num = den = 0.0
    for k in keys:
        r = ref[k].double()
        num += float(((test[k].to(r.device).double() - r) ** 2).sum())
        den += float((r ** 2).sum())
    return math.sqrt(num / den) if den > 0 else math.nan


def compare(test: dict, ref: dict, center_idx: int = 0) -> Dict[str, float]:
    """The numbers of the side under test against the reference (both
    :func:`~benchmark.reference.train_ref.follow_steps`' layout); a workload's
    ``limits`` choose those that decide ``correct``, the others are looks:

    * ``loss_gap_rel``: the first step's loss, relative gap (``.all_steps``: the
      widest over the steps, which carry Adam's amplified round-off);
    * ``rel_coords_gap_m``: the first step's widest gap of a root-relative
      last-block prediction (joints and vertices), metres (``.all_steps``);
    * the first gradient as the optimiser gets it (clipped), by module group:
      ``grad_gap.<group>`` the worst parameter's gap of norms, ``grad_diff.<group>``
      the norm of the difference over the group against the reference's;
    * ``update_gap`` / ``update_gap_median``: the worst / median parameter's gap
      of the norms of the change over the steps, over the parameters whose first
      raw gradient in the reference reaches a thousandth of the median
      parameter's (the others move under Adam by round-off alone);
    * ``knn_invalid_rows``: rows of the side's neighbour choices that are not a
      K-nearest set up to ties (``train_ref.invalid_rows``);
    * ``window_unmoved_leaves`` (where the side has ``window``: its
      :func:`leaf_digests` before and after the timed window): parameters that
      the reference's first step moves (the rule of ``update_gap``) and that
      the window's steps left bit for bit as they were."""
    out = {}
    losses = [abs(a - b) / abs(b) for a, b in zip(test["loss"], ref["loss"])]
    ok = len(test["loss"]) == len(ref["loss"])
    out["loss_gap_rel"] = losses[0] if ok else math.inf
    out["loss_gap_rel.all_steps"] = max(losses) if ok else math.inf
    gaps = []
    for a, b in zip(test["coords"], ref["coords"]):
        if a.shape != b.shape or not torch.isfinite(a).all():
            gaps.append(math.inf)
            continue
        rel = lambda c: c.double() - c.double()[:, center_idx:center_idx + 1]
        gaps.append(float((rel(a) - rel(b)).abs().max()))
    out["rel_coords_gap_m"] = gaps[0] if gaps else math.inf
    out["rel_coords_gap_m.all_steps"] = max(gaps) if gaps else math.inf
    for g in GROUPS:
        keys = [k for k in ref["grad_clipped"] if group_of(k) == g]
        leaf = leaf_gaps(test["grad_clipped"], ref["grad_clipped"], keys)
        out[f"grad_gap.{g}"] = max(leaf)
        if "grad_tensors" in test and "grad_tensors" in ref:
            out[f"grad_diff.{g}"] = group_diff(test["grad_tensors"], ref["grad_tensors"], keys)
    med = statistics.median(ref["grad_raw"].values())
    moved = [k for k, v in ref["grad_raw"].items() if v >= 1e-3 * med]
    leaf = leaf_gaps(test["change"], {k: ref["change"][k] for k in moved}, moved)
    out["update_gap"], out["update_gap_median"] = max(leaf), statistics.median(leaf)
    out["knn_invalid_rows"] = float(sum(invalid_rows(q, c, i) for step in test["chosen"]
                                        for q, c, i in step))
    if "window" in test:
        before, after = test["window"]
        same = dict(zip(ref["grad_raw"], (before == after).all(1).tolist()))
        out["window_unmoved_leaves"] = float(sum(same[k] for k in moved))
    return out


def run_reference(config: dict, shapes, seed: int, steps: List[dict], device, chunk: int,
                  precision: str = "float32", select: str = "given",
                  select_rounded: bool = False, **kwargs) -> dict:
    """The reference (or, with a lower ``precision``, the control) over ``steps``
    (:class:`StepRecorder`'s, on ``device``) from the seed's weights."""
    model_cfg = config["MODEL"]
    consts = load_constants(model_cfg, device)
    weights = make_weights(shapes, weight_seed(seed), device)
    with float32_matmuls():
        return follow_steps(weights, model_cfg, config["TRAIN"], consts, steps, chunk,
                            steps_per_epoch(config), Precision(precision), select,
                            select_rounded,
                            center_idx=config.get("DATA_PRESET", {}).get("CENTER_IDX", 0),
                            ref_noise=float(config.get("REF_NOISE", 0.01)),
                            dropout=model_cfg["HEAD"]["TRANSFORMER"].get("DROPOUT", 0.1),
                            **kwargs)


def judge(program: dict, rec_steps: List[dict], config: dict, shapes, seed: int, device,
          chunk: int) -> Dict[str, float]:
    """The numbers of :func:`compare`: the program's record against the reference
    over the same steps, the program's neighbour choices held. A step whose
    record does not cover its batch (masks, choices or predictions of other rows)
    reads infinite on every number."""
    for s in rec_steps:
        B = s["batch"]["image"].shape[0]
        rows = [m.shape[0] for blk in s["masks"] for m in blk.values()] + \
            [i.shape[0] for i in s["indices"]] + [s["coords"].shape[0]]
        if any(r != B for r in rows):
            return collections.defaultdict(lambda: math.inf)
    ref = run_reference(config, shapes, seed, rec_steps, device, chunk)
    return compare(program, ref, config.get("DATA_PRESET", {}).get("CENTER_IDX", 0))

