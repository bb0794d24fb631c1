"""CLI arguments (counterpart of ``poem_v2_tpu/cli/opt.py``): the same flags, and
``--device``.

Data parallel runs one process per card under torchrun
(``torchrun --nproc_per_node N -m poem_v2_tpu_torch.cli.train ...``); ``-b`` stays
the global batch. Flags the port cannot honour raise in :func:`check_args`
instead of being ignored: a ``--mesh_data`` other than torchrun's world size, a
model mesh (tensor parallel is not ported), and ``--multihost`` outside
torchrun's environment.
"""

from __future__ import annotations

import argparse
import os

from ..parallel import mesh


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
                   help="accepted for the JAX CLI's command lines and without effect: a "
                        "shard dataset's decode workers are its config's WORKERS")
    p.add_argument("--snapshot", type=int, default=1, help="epochs between ckpt snapshots")
    p.add_argument("--ckpt_freq", type=int, default=1,
                   help="epochs between rolling-checkpoint writes; the final epoch always "
                        "checkpoints")
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--log_freq", type=int, default=None,
                   help="steps between summary/console logs (default: cfg.TRAIN.LOG_INTERVAL)")
    p.add_argument("--eval_extra", type=str, default="", help="auc | save | draw")
    p.add_argument("--view_max", type=int, default=8, help="padded view count")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel ranks: torchrun's world size (the default; another "
                        "value raises)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel size: 1 only (tensor parallel is not ported)")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"],
                   help="compute dtype; parameters stay float32")
    p.add_argument("--flash_train", action=argparse.BooleanOptionalAction, default=True,
                   help="train through the dense attention kernel (K3 / K3b, no dropout on the "
                        "attention probabilities) and K6 / K6b; --no-flash_train trains the "
                        "reference's way: attention with probability dropout, gathered KNN "
                        "neighbourhoods whose backward is K7")
    p.add_argument("--exact_knn", action="store_true",
                   help="accepted and without effect: the port always selects neighbours "
                        "exactly, in eval and in training")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training: torchrun's multi-node environment forms the "
                        "process group")
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler trace of epoch 0's first 20 steps into this dir")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda by default; cpu runs the kernels' plain "
                        "versions)")
    return check_args(p.parse_args(argv))


def check_args(args):
    """Raise for a flag the port cannot honour (see the module docstring)."""
    world = mesh.launched_world_size()
    if args.mesh_model != 1:
        raise NotImplementedError(
            f"--mesh_model {args.mesh_model}: tensor parallel is not ported (the widest tier "
            "trains on one card); data parallel takes --mesh_data")
    if args.mesh_data not in (None, world):
        raise NotImplementedError(
            f"--mesh_data {args.mesh_data}: data parallel runs one rank a process, and this "
            f"process was launched into a world of {world}; start {args.mesh_data} with "
            f"torchrun --nproc_per_node {args.mesh_data}")
    if args.multihost and not (mesh.in_group() or "WORLD_SIZE" in os.environ):
        raise NotImplementedError(
            "--multihost: multi-host training forms its process group from torchrun's "
            "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), and none is set")
    if args.eval_extra not in ("", "auc", "save", "draw"):
        raise ValueError(f"--eval_extra {args.eval_extra!r}: one of auc, save, draw")
    return args
