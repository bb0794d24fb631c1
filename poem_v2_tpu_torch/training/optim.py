"""Optimiser and LR schedules (counterpart of ``poem_v2_tpu/training/optim.py``).

The JAX package chains optax transformations: gradient clipping (per
parameter, as the reference's ``clip_gradient``, or by the global norm),
then Adam / AdamW / SGD with a schedule. This module computes the same
updates with the same step counting: the n-th update (n = 0, 1, ...) uses
``schedule(n)``, Adam's bias correction uses n + 1, and a StepLR boundary
at step b applies from update b on (optax ``piecewise_constant_schedule``).
Parameters without a gradient take a zero gradient, as optax sees them.
``GRAD_ACCUM_STEPS`` = k > 1 is optax ``MultiSteps``: each call folds the
gradients into their running mean (``acc + (g - acc) / (n + 1)``, optax's
formula); the k-th call applies the whole chain (clip, optimiser, schedule)
to that mean and the others leave the parameters alone, so the update count
advances once per k calls.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Mapping

import torch

Schedule = Callable[[int], float]


def build_schedule(cfg: Mapping, steps_per_epoch: int) -> Schedule:
    """StepLR / MultiStepLR, cosine or constant, from the config's ``TRAIN`` section."""
    sched = cfg.get("SCHEDULER", "StepLR")
    lr = cfg["LR"]
    if sched in ("StepLR", "MultiStepLR"):
        decay_steps = cfg.get("LR_DECAY_STEP", [7])
        if isinstance(decay_steps, int):
            decay_steps = [decay_steps]
        gamma = cfg.get("LR_DECAY_GAMMA", 0.1)
        boundaries = sorted(int(e) * steps_per_epoch for e in decay_steps)
        return lambda n: lr * gamma ** sum(n >= b for b in boundaries)
    if sched in ("CosineLR", "cosine", "CosineAnnealingLR"):
        total = cfg["EPOCH"] * steps_per_epoch
        alpha = cfg.get("LR_MIN", 0.0) / lr if lr else 0.0
        return lambda n: lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(n, total) / total))
                               + alpha)
    if sched in ("constant", "none"):
        return lambda n: lr
    raise ValueError(f"unknown scheduler {sched!r}")


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2.0)))


def clip_by_per_param_norm_(grads: List[torch.Tensor], max_norm: float,
                            norm_type: float = 2.0) -> None:
    """Scale each tensor by min(max_norm / (norm + 1e-6), 1), in place (optim.py:17-42)."""
    norms = torch.stack(torch._foreach_norm(grads, norm_type))
    coefs = torch.clamp(max_norm / (norms + 1e-6), max=1.0)
    torch._foreach_mul_(grads, list(coefs.unbind()))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale all tensors by max_norm / global norm where that norm reaches max_norm."""
    g = global_norm(grads)
    torch._foreach_mul_(grads, torch.where(g < max_norm, torch.ones_like(g), max_norm / g))


class Optimizer:
    """Clipping + Adam / AdamW / SGD over ``params``, built from ``TRAIN``.

    ``step()`` reads each parameter's ``.grad`` (clipping it in place) and
    updates the parameters in place."""

    def __init__(self, params: Iterable[torch.Tensor], cfg: Mapping, steps_per_epoch: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = build_schedule(cfg, steps_per_epoch)
        self.name = cfg.get("OPTIMIZER", "adam").lower()
        self.weight_decay = cfg.get("WEIGHT_DECAY", 0.0)
        if self.name == "adam" and self.weight_decay:
            self.name = "adamw"  # optax.adam takes no decay: build_optimizer switches to adamw
        if self.name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {self.name!r}")
        self.momentum = cfg.get("MOMENTUM", 0.9)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.clip = None
        if cfg.get("GRAD_CLIP_ENABLED", True):
            clip = cfg.get("GRAD_CLIP", {}) or {}
            self.clip = (clip.get("MODE", "per_param"), clip.get("NORM", 1.0),
                         float(clip.get("TYPE", 2)))
        self.accum = int(cfg.get("GRAD_ACCUM_STEPS", 1) or 1)
        self.count = 0       # updates applied
        self.mini_step = 0   # gradients folded into acc since the last update
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        self.mu = zeros()
        self.nu = zeros() if self.name != "sgd" else []
        self.acc = zeros() if self.accum > 1 else []

    def grads(self) -> List[torch.Tensor]:
        """Each parameter's gradient (zeros where it has none)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = self.grads()
        if self.accum > 1:
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < self.accum:
                return
            self.mini_step = 0
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.clip is not None:
            mode, max_norm, norm_type = self.clip
            if mode == "global":
                clip_by_global_norm_(grads, max_norm)
            else:
                clip_by_per_param_norm_(grads, max_norm, norm_type)
        lr = self.schedule(self.count)
        if self.name == "sgd":
            torch._foreach_mul_(self.mu, self.momentum)
            torch._foreach_add_(self.mu, grads)
            torch._foreach_add_(self.params, self.mu, alpha=-lr)
        else:
            t = self.count + 1
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
            torch._foreach_mul_(self.nu, self.b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
            denom = torch._foreach_div(self.nu, 1 - self.b2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(self.mu, 1 - self.b1 ** t)
            torch._foreach_div_(update, denom)
            if self.name == "adamw":
                torch._foreach_add_(update, self.params, alpha=self.weight_decay)
            torch._foreach_add_(self.params, update, alpha=-lr)
        self.count += 1

    def state_dict(self) -> dict:
        """The moments, the accumulator and the counters (tensors on their device)."""
        return {"count": self.count, "mini_step": self.mini_step, "mu": list(self.mu),
                "nu": list(self.nu), "acc": list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Copy a :meth:`state_dict` of an optimiser over the same parameters into this one."""
        for key in ("mu", "nu", "acc"):
            mine = getattr(self, key)
            if len(state[key]) != len(mine):
                raise ValueError(f"optimiser state {key!r} has {len(state[key])} tensors, "
                                 f"this optimiser {len(mine)}")
            for t, v in zip(mine, state[key]):
                t.copy_(v)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
