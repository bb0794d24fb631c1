"""Evaluation entry point (counterpart of ``poem_v2_tpu/cli/eval.py``).

Usage:
  python -m poem_v2_tpu_torch.cli.eval -c configs/synthetic_smoke.yaml --exp_id default \\
      --view_max 2 -b 4 --eval_extra auc [--reload exp/.../checkpoints/checkpoint.pt]

The model of ``cfg.MODEL`` (weights from ``--reload`` / ``MODEL.PRETRAINED``,
else from ``TRAIN.MANUAL_SEED``) evaluated on ``DATASET.TEST`` by the
Evaluator; ``--eval_extra auc`` adds PCK-AUC, ``save`` dumps predictions,
``draw`` writes drawings of the predictions over every view
(``DrawingHandCallback``, PNGs under ``<exp>/draws``).
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

from ..data import batch_iterator, create_dataset
from ..training.draw_callback import DrawingHandCallback
from ..training.evaluator import AUCCallback, Evaluator, IdleCallback, PredictionSaverCallback
from ..utils.config import get_config
from ..utils.logger import get_logger
from ..utils.recorder import Recorder
from .opt import parse_exp_args
from .train import build_model


def make_callback(extra: str, exp_dir: str):
    if extra == "auc":
        return AUCCallback(exp_dir=exp_dir)
    if extra == "save":
        return PredictionSaverCallback(exp_dir=exp_dir)
    if extra == "draw":
        return DrawingHandCallback(exp_dir=exp_dir)
    return IdleCallback()


def evaluate(cfg, args, timing: Optional[dict] = None) -> Dict[str, float]:
    """The measures of ``cfg``'s model on ``DATASET.TEST`` (metres), AUC included
    with ``--eval_extra auc``. A ``timing`` dict receives the samples evaluated
    and the seconds the evaluation loop took (the model's build excluded)."""
    logger = get_logger()
    callback_kind = args.eval_extra
    model, aux = build_model(cfg, args)
    dataset = create_dataset(cfg.DATASET.TEST, data_preset=cfg.DATA_PRESET, is_train=False,
                             device=args.device)
    batch_size = cfg.TRAIN.get("VAL_BATCH_SIZE", cfg.TRAIN.BATCH_SIZE)
    recorder = Recorder(f"{args.exp_id}_eval", cfg=cfg, eval_only=True)
    cb = make_callback(callback_kind, recorder.dump_path)
    evaluator = Evaluator(model, aux, center_idx=cfg.DATA_PRESET.CENTER_IDX)
    epoch_size = cfg.DATASET.TEST.get("EPOCH_SIZE", 0)
    t = time.perf_counter()
    results = evaluator.run(batch_iterator(dataset, batch_size, args.view_max, epoch_size),
                            callback=cb)
    if timing is not None:  # the measures are host floats: the device is done
        timing.update(samples=evaluator.samples, seconds=time.perf_counter() - t)
    if isinstance(cb, AUCCallback):
        results.update(auc_j=cb.auc_j, auc_v=cb.auc_v)
    logger.info("eval results: " + json.dumps(results, indent=2))
    recorder.record_metric([f"{k}: {v:.6f}" for k, v in results.items()], epoch_idx=0,
                           comment="eval")
    return results


def main(argv=None):
    args = parse_exp_args(argv)
    cfg = get_config(args.cfg, arg=args, merge=True)
    return evaluate(cfg, args)


if __name__ == "__main__":
    main()
