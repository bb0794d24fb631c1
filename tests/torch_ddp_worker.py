"""One rank of the port's data-parallel checks in tests/test_torch_ddp.py.

    python tests/torch_ddp_worker.py <job> <rank> <world> <rendezvous file> <in.pt> <out.pt>

Joins a gloo process group through a rendezvous file (no TCP port to collide
with other test processes), runs ``job`` on what ``in.pt`` holds and writes the
rank's results to ``out.pt``. Imports torch and the port only, never JAX: the
test process hands weights and batches over as files. One intra-op thread.

Jobs:
  step  one train step of the rank's rows through the Trainer's DDP step, fed the
        caller's reference-jitter draws; then, with the step's body replaced by a
        recorder, one ``Trainer.step`` on the global batch, which records the
        rank's jitter draws and a dropout mask of its seed.
  cli   ``cli/train.py``'s main on the caller's command line, from its directory.
"""

import os
import sys

import torch
import torch.distributed as dist
import torch.nn.functional as F


def step_job(inp, rank, world):
    from poem_v2_tpu_torch.models import losses
    from poem_v2_tpu_torch.models.poem import create_poem_model
    from poem_v2_tpu_torch.parallel.mesh import shard_batch
    from poem_v2_tpu_torch.training.trainer import Trainer

    if inp["local_denominator"]:  # what DDP with per-rank loss denominators computes
        losses.count_over_ranks = lambda count: (count, 1)
    cfg = inp["cfg"]
    model, aux = create_poem_model(cfg, device="cpu")
    model.load_state_dict(inp["state_dict"])
    trainer = Trainer(model, aux, cfg["TRAIN"], cfg["LOSS"], inp["steps_per_epoch"])
    local = shard_batch(inp["batch"], rank, world)
    n = len(local["image"])
    joints, shift, uniform = (torch.from_numpy(d) for d in inp["draws"])
    draws = (joints[rank * n:(rank + 1) * n], shift, uniform)
    grads = {}
    optimizer_step = trainer.optimizer.step

    def step():  # the gradients DDP averaged, before clipping scales them in place
        grads.update({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
        optimizer_step()

    trainer.optimizer.step = step
    metrics = trainer._train_step(trainer.to_device(local), draws)
    seen = {}

    def record(dev_batch, ref_draws):
        seen.update(rows=dev_batch["master_joints_3d"].clone(), draws=ref_draws,
                    mask=F.dropout(torch.ones(4096), 0.5, training=True))
        return {}

    trainer._train_step = record
    trainer.step(inp["batch"])
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                params={k: p.detach().clone() for k, p in model.named_parameters()}, **seen)


def cli_job(inp, rank, world):
    from poem_v2_tpu_torch.cli import train

    os.chdir(inp["workdir"])
    run = train.main(inp["argv"])
    return dict(losses=run["losses"], checkpoint=run["checkpoint"], val=run["val"],
                world=run["world"], rank=run["rank"])


JOBS = {"step": step_job, "cli": cli_job}


def main(job, rank, world, rendezvous, inp, out):
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world)
    try:
        result = JOBS[job](torch.load(inp, weights_only=False), rank, world)
    finally:
        dist.destroy_process_group()
    torch.save(result, out + ".tmp")
    os.replace(out + ".tmp", out)


if __name__ == "__main__":
    main(*sys.argv[1:])
