"""The train step and the Trainer (counterpart of ``poem_v2_tpu/training/trainer.py``).

One step: the train forward (reference-joint jitter from explicit draws,
dropout on, remat'd decoder), the POEM loss, the backward, the global
gradient norm (a metric, taken before clipping), clipping and the
optimiser update.

Data parallel: in a ``torch.distributed`` process group (``parallel/mesh.py``)
the Trainer runs the model through ``DistributedDataParallel``, each rank on
its rows of the global batch, and a step computes what the JAX package's
sharded step computes on the whole batch: the losses divide by the global
batch's counts (``models/losses.py``), DDP averages the gradients, and the
metrics are the global batch's on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from ..models.losses import poem_loss
from ..models.poem import RefDraws, draw_ref_noise
from ..parallel import mesh
from .optim import Optimizer, global_norm

BATCH_KEYS = ("image", "view_mask", "cam_intr", "cam_extr", "master_joints_3d",
              "master_verts_3d", "target_joints_2d", "mano_pose", "mano_shape")


def make_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer: Optimizer) -> Callable:
    """(batch of tensors on the model's device, ref draws) -> metrics: the loss
    dict plus ``grad_norm``, as 0-d tensors on the device. Under data parallel
    the loss terms are averaged over the ranks, which makes them the global
    batch's (``models/losses.py``)."""

    def train_step(batch: Mapping[str, torch.Tensor], ref_draws: RefDraws
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        preds = model(batch["image"], batch["view_mask"], batch["cam_intr"], batch["cam_extr"],
                      batch["master_joints_3d"], ref_draws=ref_draws)
        loss, loss_dict = loss_fn(preds, batch)
        loss.backward()
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        world = mesh.world_size()
        if world > 1:
            mean = mesh.all_reduce_sum(torch.stack(list(metrics.values()))) / world
            metrics = dict(zip(metrics, mean.unbind()))
        metrics["grad_norm"] = global_norm(optimizer.grads())
        optimizer.step()
        return metrics

    return train_step


class Trainer:
    """Owns the optimiser, the step and the generator of its random draws.

    Every step draws the reference jitter and then a dropout seed from
    ``self.generator`` (seeded from ``seed`` or ``TRAIN.MANUAL_SEED``), and
    runs under a fork of the global generators (the CPU's and the model's
    device's) seeded with it: dropout is a function of the seed and the step,
    as the JAX Trainer splits its dropout key from the state's key every
    step, and the caller's generators come out as they went in.

    In a process group (of any size) the step runs through
    ``DistributedDataParallel``. Every rank draws the jitter of the global
    batch and keeps its own rows (the two scalar draws are shared), so the
    ranks' generators stay in lockstep and a checkpoint of any rank resumes
    all; rank r seeds its dropout with the step's seed + r, so the ranks draw
    different masks. Parameters outside a step's autograd graph take no
    gradient there (JAX gives them zeros): the heatmap neck's ``uv_in`` at every
    tier, and the last decoder block's FFN, whose features no output reads,
    in the non-parametric ones. They are what ``find_unused_parameters`` is for."""

    def __init__(self, model: torch.nn.Module, aux: Mapping[str, Any], train_cfg: Mapping,
                 loss_cfg: Mapping, steps_per_epoch: int = 1000, seed: Optional[int] = None):
        self.model = model
        self.global_step = 0  # steps taken, as the JAX TrainState.step
        self.device = next(model.parameters()).device
        self.rank, self.world = mesh.rank(), mesh.world_size()
        net = model
        if mesh.in_group():
            net = DistributedDataParallel(
                model, device_ids=[self.device.index] if self.device.type == "cuda" else None,
                find_unused_parameters=True)
        self.net = net  # what the step runs: the model, or its DDP wrapper
        self.optimizer = Optimizer(model.parameters(), train_cfg, steps_per_epoch)
        seed = seed if seed is not None else train_cfg.get("MANUAL_SEED", 1)
        self.generator = torch.Generator().manual_seed(seed)
        j_reg = aux["j_regressor"].to(self.device)
        center = aux.get("transformer_center_idx", 9)
        parametric = aux.get("parametric_output", False)

        def loss_fn(preds, batch):
            return poem_loss(preds, batch, j_regressor=j_reg, loss_cfg=loss_cfg,
                             transformer_center_idx=center, parametric=parametric)

        self.loss_fn = loss_fn
        self._train_step = make_train_step(net, loss_fn, self.optimizer)

    def to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in BATCH_KEYS if k in batch}

    def step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """One train step on a global batch of numpy arrays or tensors (this rank
        keeps its rows); returns the metrics."""
        if self.world > 1:
            batch = mesh.shard_batch(batch, self.rank, self.world)
        return self.step_sharded(self.to_device(batch))

    def step_sharded(self, dev_batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One train step on this rank's rows of the global batch, already on the
        device (``training/prefetch.py``); returns the metrics."""
        local = dev_batch["image"].shape[0]
        normal_joints, shift, uniform = draw_ref_noise(self.generator, local * self.world)
        draws = (normal_joints[self.rank * local:(self.rank + 1) * local], shift, uniform)
        dropout_seed = int(torch.randint(0, 2 ** 62, (), generator=self.generator)) + self.rank
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(dropout_seed)
            metrics = self._train_step(dev_batch, draws)
        self.global_step += 1
        return metrics

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint must hold to resume: the parameters (and buffers), the
        optimiser's state, the step and the generator of the jitter and dropout draws."""
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "step": self.global_step, "generator": self.generator.get_state()}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.global_step = int(state["step"])
        self.generator.set_state(state["generator"])
