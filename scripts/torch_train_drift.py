"""How fast two float32 training runs of the port part: the same model, weights, batches
and draws, trained twice with different CPU thread counts (which changes only the
summation order of the products), step by step.

    python scripts/torch_train_drift.py [--config synthetic_overfit_gate_mano] [--steps 8]

Prints one JSON line per step: the two runs' losses, their relative difference
and the largest parameter difference in learning rates. The model is the config's
as shipped (``configs.SYNTHETIC[name]``, weights from seed 0) on the CPU; the
data are 2 samples of 1-3 of 3 views at 64 px, a new batch each step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from poem_v2_tpu_torch import configs  # noqa: E402
from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset  # noqa: E402
from poem_v2_tpu_torch.models.poem import create_poem_model  # noqa: E402
from poem_v2_tpu_torch.training.trainer import Trainer  # noqa: E402


def run(cfg, batches, threads, steps_per_epoch):
    torch.set_num_threads(threads)
    model, aux = create_poem_model(cfg["MODEL"], device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, aux, cfg["TRAIN"], cfg["MODEL"]["LOSS"],
                      steps_per_epoch=steps_per_epoch)
    out = []
    for batch in batches:
        loss = float(trainer.step(batch)["loss"])
        out.append((loss, [p.detach().clone() for p in model.parameters()]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="synthetic_overfit_gate_mano")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--threads", type=int, nargs=2, default=(1, 8))
    args = ap.parse_args()
    cfg = configs.SYNTHETIC[args.config]
    data = SyntheticMultiviewDataset(batch_size=2, view_max=3, view_range=(1, 3),
                                     image_size=64, seed=11)
    batches = [data.sample_batch() for _ in range(args.steps)]
    steps_per_epoch = cfg["DATASET"]["TRAIN"]["EPOCH_SIZE"] // cfg["TRAIN"]["BATCH_SIZE"]
    a, b = (run(cfg, batches, t, steps_per_epoch) for t in args.threads)
    lr = cfg["TRAIN"]["LR"]
    for i, ((la, pa), (lb, pb)) in enumerate(zip(a, b)):
        diff = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
        print(json.dumps({"step": i, "loss": [la, lb], "loss_rel_diff": abs(la - lb) / abs(la),
                          "max_param_diff_in_lr": diff / lr, "threads": list(args.threads)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
