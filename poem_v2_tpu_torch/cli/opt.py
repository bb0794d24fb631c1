"""CLI arguments (counterpart of ``poem_v2_tpu/cli/opt.py``): the same flags, and
``--device``.

Flags the port cannot honour raise in :func:`check_args` instead of being
ignored: a data or model mesh larger than one card (data parallel is not
ported yet), ``--no-flash_train`` (the port has no attention-probability
dropout path) and ``--multihost``.
"""

from __future__ import annotations

import argparse


def parse_exp_args(argv=None):
    p = argparse.ArgumentParser("POEM-v2 on PyTorch")
    p.add_argument("-c", "--cfg", type=str, required=True, help="experiment config yaml")
    p.add_argument("--exp_id", type=str, default="default", help="experiment id")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume from: a checkpoint .pt, or an experiment "
                        "directory holding checkpoints/checkpoint.pt")
    p.add_argument("--reload", type=str, default=None, help="checkpoint to load weights from")
    p.add_argument("-b", "--batch_size", type=int, default=None, help="batch size")
    p.add_argument("--val_batch_size", type=int, default=None)
    p.add_argument("-w", "--workers", type=int, default=4,
                   help="accepted for the JAX CLI's command lines; the synthetic feed runs "
                        "in the main process")
    p.add_argument("--snapshot", type=int, default=1, help="epochs between ckpt snapshots")
    p.add_argument("--ckpt_freq", type=int, default=1,
                   help="epochs between rolling-checkpoint writes; the final epoch always "
                        "checkpoints")
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--log_freq", type=int, default=None,
                   help="steps between summary/console logs (default: cfg.TRAIN.LOG_INTERVAL)")
    p.add_argument("--eval_extra", type=str, default="", help="auc | save (draw: not ported)")
    p.add_argument("--view_max", type=int, default=8, help="padded view count")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel size: 1 (or unset) only until data parallel is ported")
    p.add_argument("--mesh_model", type=int, default=1, help="model-parallel size: 1 only")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"],
                   help="compute dtype; parameters stay float32")
    p.add_argument("--flash_train", action=argparse.BooleanOptionalAction, default=True,
                   help="the dense attention kernel (K3 / K3b) in training, without dropout on "
                        "the attention probabilities: the port's only training path, so "
                        "--no-flash_train raises")
    p.add_argument("--exact_knn", action="store_true",
                   help="accepted and without effect: the port always selects neighbours "
                        "exactly, in eval and in training")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training: not ported (raises)")
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler trace of epoch 0's first 20 steps into this dir")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda by default; cpu runs the kernels' plain "
                        "versions)")
    return check_args(p.parse_args(argv))


def check_args(args):
    """Raise for a flag the port cannot honour (see the module docstring)."""
    if args.mesh_data not in (None, 1) or args.mesh_model != 1:
        raise NotImplementedError(
            f"--mesh_data {args.mesh_data} --mesh_model {args.mesh_model}: the port runs on "
            "one device until data parallel is ported (ROADMAP queue 1, item 3)")
    if not args.flash_train:
        raise NotImplementedError(
            "--no-flash_train: the port trains through the dense attention kernel only; it has "
            "no attention-probability dropout path")
    if args.multihost:
        raise NotImplementedError("--multihost: multi-host training is not ported")
    if args.eval_extra not in ("", "auc", "save", "draw"):
        raise ValueError(f"--eval_extra {args.eval_extra!r}: one of auc, save, draw")
    return args
