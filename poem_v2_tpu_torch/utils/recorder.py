"""Experiment recorder: directories, config dump, checkpoints, metrics
(counterpart of ``poem_v2_tpu/utils/recorder.py``).

A checkpoint is one ``torch.save`` file holding what :meth:`Trainer.state_dict`
returns (parameters, optimiser state, step and the Trainer's generator) and
the epoch: ``exp/<exp_id>_<time>/checkpoints/checkpoint.pt``, with a copy
``checkpoint_<epoch + 1>.pt`` every ``snapshot_every`` epochs. The JAX
package's orbax checkpoint directories are not read here (ROADMAP queue 1,
item 6).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from typing import Any, Dict, Optional

import torch

from .logger import get_logger, is_master, master_only

CKPT_NAME = "checkpoint.pt"


def resolve_checkpoint(path: str) -> str:
    """The checkpoint file that ``path`` names: the file itself, or
    ``checkpoint.pt`` in it, or in its ``checkpoints/``. An orbax directory raises."""
    for cand in (path, os.path.join(path, CKPT_NAME),
                 os.path.join(path, "checkpoints", CKPT_NAME)):
        if os.path.isfile(cand):
            return cand
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} holds no {CKPT_NAME}: the port reads its own torch.save checkpoints; "
            "orbax checkpoints of the JAX package wait for the export script (ROADMAP queue 1, "
            "item 6)")
    raise FileNotFoundError(f"no checkpoint at {path}")


class Recorder:
    def __init__(self, exp_id: str, cfg=None, root: str = "exp", eval_only: bool = False,
                 timestamp: Optional[str] = None):
        self.exp_id = exp_id
        skip_git = os.environ.get("POEM_SKIP_GIT_CHECK") == "1"
        if exp_id not in ("default", "tmp") and not eval_only and not skip_git:
            self._assert_clean_git()
        ts = timestamp or time.strftime("%Y_%m%d_%H%M_%S")
        self.dump_path = os.path.join(root, f"{exp_id}_{ts}")
        self.eval_only = eval_only
        if is_master():
            for sub in ("checkpoints", "evaluations", "runs"):
                os.makedirs(os.path.join(self.dump_path, sub), exist_ok=True)
            self.logger = get_logger("poem_tpu", log_file=os.path.join(self.dump_path, "log.txt"))
        else:
            self.logger = get_logger()
        if cfg is not None:
            self.dump_cfg(cfg)

    @staticmethod
    def _assert_clean_git() -> None:
        """Named experiments require a clean tree (reference recorder.py:38)."""
        try:
            out = subprocess.run(["git", "status", "--porcelain"], capture_output=True,
                                 text=True, timeout=10)
        except Exception:
            return
        if out.returncode == 0 and out.stdout.strip():
            raise RuntimeError("git tree is dirty; commit your changes or use --exp_id default")

    @master_only
    def dump_cfg(self, cfg) -> None:
        with open(os.path.join(self.dump_path, "dump_cfg.yaml"), "w") as f:
            cfg.dump(f)

    # -- checkpointing ------------------------------------------------------
    def ckpt_path(self, tag: str = "checkpoint") -> str:
        return os.path.abspath(os.path.join(self.dump_path, "checkpoints", f"{tag}.pt"))

    @master_only
    def record_checkpoint(self, trainer, epoch: int, snapshot_every: int = 0) -> Dict[str, Any]:
        """Save the Trainer's state and the epoch; returns the bytes written and
        the seconds the write took (the device-to-host copy included)."""
        t = time.perf_counter()
        path = self.ckpt_path()
        tmp = path + ".tmp"
        torch.save({**trainer.state_dict(), "epoch": epoch}, tmp)
        os.replace(tmp, path)
        secs = time.perf_counter() - t
        if snapshot_every and (epoch + 1) % snapshot_every == 0:
            shutil.copyfile(path, self.ckpt_path(f"checkpoint_{epoch + 1}"))
        with open(os.path.join(self.dump_path, "checkpoints", "meta.json"), "w") as f:
            json.dump({"epoch": epoch, "step": trainer.global_step}, f)
        return {"path": path, "bytes": os.path.getsize(path), "write_s": secs}

    @staticmethod
    def resume(trainer, path: str) -> Dict[str, Any]:
        """Restore a Trainer saved by :meth:`record_checkpoint` (parameters,
        optimiser state, step, generator); returns the checkpoint's epoch, step
        and the seconds the read took."""
        t = time.perf_counter()
        path = resolve_checkpoint(path)
        # on the CPU: the generator state must stay a CPU tensor; the rest is copied over
        state = torch.load(path, map_location="cpu", weights_only=False)
        trainer.load_state_dict(state)
        return {"path": path, "epoch": state.get("epoch"), "step": trainer.global_step,
                "read_s": time.perf_counter() - t}

    @staticmethod
    def load_params(path: str, model: torch.nn.Module) -> None:
        """Weights only (``--reload`` / ``MODEL.PRETRAINED``): the checkpoint's
        parameters into ``model``, every key once."""
        state = torch.load(resolve_checkpoint(path), map_location="cpu", weights_only=False)
        model.load_state_dict(state["params"] if "params" in state else state)

    # -- metric text dumps (reference recorder.py:140-159) ------------------
    @master_only
    def record_metric(self, metrics, epoch_idx: int, comment: str = "") -> None:
        path = os.path.join(self.dump_path, "evaluations", f"metric_{comment}.txt")
        with open(path, "a") as f:
            f.write(f"epoch {epoch_idx}: " + " | ".join(str(m) for m in metrics) + "\n")

    @master_only
    def record_loss(self, loss_metric, epoch_idx: int, comment: str = "") -> None:
        path = os.path.join(self.dump_path, "evaluations", f"loss_{comment}.txt")
        with open(path, "a") as f:
            f.write(f"epoch {epoch_idx}: {loss_metric}\n")
