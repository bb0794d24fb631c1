"""Training entry point (counterpart of ``poem_v2_tpu/cli/train.py``).

Usage:
  python -m poem_v2_tpu_torch.cli.train -c configs/synthetic_smoke.yaml --exp_id default \\
      --view_max 2 -b 4 [--resume exp/default_<time>] [--device cpu] [--no-flash_train]
  torchrun --nproc_per_node N -m poem_v2_tpu_torch.cli.train -c ... -b <global batch>

Epochs of ``DATASET.TRAIN.EPOCH_SIZE // BATCH_SIZE`` steps of the port's
Trainer, fed by :func:`prefetch_to_device` (or, for a ``FIXED_SET`` that
fits, from batches cached on the device once); the loss terms every
``--log_freq`` steps to the log and TensorBoard; a checkpoint every
``--ckpt_freq`` epochs and the last, a snapshot every ``--snapshot``;
validation on ``DATASET.TEST`` every ``--eval_freq`` epochs through one
Evaluator built once. ``--resume`` restores parameters, optimiser state,
step and the Trainer's generator, and the epoch follows from the step.
``MODEL.PRETRAINED_BACKBONE`` warm-starts the backbone from a port file
holding ``backbone.*`` (``scripts/torch_prepare_hrnet.py``), and
``MODEL.PRETRAINED`` loads the whole model's weights.

Under torchrun every rank draws the global batch a single process would draw
and keeps its rows on ``cuda:<LOCAL_RANK>``, so an R-rank run repeats the
single-process one. Rank 0 alone records (log, summaries, checkpoints) and
validates, as the reference's DDP loop does; ``--resume`` loads on every
rank. The JAX CLI's train-image summary waits for the viztools (ROADMAP
queue 1, item 8).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

import torch

from ..data import batch_iterator, create_dataset
from ..metrics import LossMetric
from ..models.poem import create_poem_model
from ..parallel import mesh
from ..training.evaluator import Evaluator
from ..training.prefetch import (FIXED_FEED_CACHE_CAP_BYTES, batch_nbytes, cache_on_device,
                                 prefetch_to_device)
from ..training.trainer import Trainer
from ..utils.config import get_config
from ..utils.logger import get_logger
from ..utils.recorder import Recorder
from ..utils.summary_writer import SummaryWriter
from .opt import parse_exp_args

# steps of the first epoch that --profile traces
PROFILE_STEPS = 20


def build_model(cfg, args, device=None):
    """The POEMNet of ``cfg.MODEL`` on ``device`` (default ``args.device``): float32
    parameters, compute in ``args.dtype``, training through the dense attention
    kernel unless ``--no-flash_train``; weights from ``TRAIN.MANUAL_SEED``, the
    backbone's from ``MODEL.PRETRAINED_BACKBONE`` and all from ``MODEL.PRETRAINED``."""
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model, aux = create_poem_model(
        cfg.MODEL.to_dict(), dtype=dtype, param_dtype=torch.float32,
        device=device or args.device, use_flash_train=bool(args.flash_train),
        generator=torch.Generator().manual_seed(int(cfg.TRAIN.get("MANUAL_SEED", 1))))
    pretrained_bb = cfg.MODEL.get("PRETRAINED_BACKBONE", None)
    if pretrained_bb:
        Recorder.load_backbone(pretrained_bb, model)
        get_logger().info(f"warm-started the backbone from {pretrained_bb}")
    pretrained = cfg.MODEL.get("PRETRAINED", None)
    if pretrained:
        Recorder.load_params(pretrained, model)
        get_logger().info(f"loaded weights from {pretrained}")
    return model, aux


def train(cfg, args) -> Dict[str, Any]:
    """Run the training that ``cfg`` and ``args`` describe. Returns what a caller
    checks: the Trainer, every step's loss, the validations' measures, the last
    checkpoint's path, bytes and write seconds, and per-step device times (CUDA
    events around each step; host times on the CPU)."""
    logger = get_logger()
    device = torch.device(args.device)
    own_group = not mesh.in_group()
    rank, world = mesh.init_distributed(device.type)
    on_card = device.type == "cuda"
    if on_card and mesh.in_group():  # one card a rank
        if device.index is None:
            device = torch.device("cuda", mesh.local_rank())
        torch.cuda.set_device(device)
    if on_card:
        # the reference's CONV_REPEATABLE: deterministic convolutions, so a resumed
        # run repeats an uninterrupted one
        repeatable = bool(cfg.TRAIN.get("CONV_REPEATABLE", True))
        torch.backends.cudnn.deterministic = repeatable
        torch.backends.cudnn.benchmark = not repeatable
    model, aux = build_model(cfg, args, device)

    batch_size = cfg.TRAIN.BATCH_SIZE  # the global batch, as in the JAX CLI
    epoch_size = cfg.DATASET.TRAIN.get("EPOCH_SIZE", 210_000)
    steps_per_epoch = max(1, epoch_size // batch_size)
    trainer = Trainer(model, aux, train_cfg=cfg.TRAIN, loss_cfg=cfg.MODEL.LOSS,
                      steps_per_epoch=steps_per_epoch)
    recorder = Recorder(args.exp_id, cfg=cfg)
    summary = SummaryWriter(log_dir=f"{recorder.dump_path}/runs")
    dataset = create_dataset(cfg.DATASET.TRAIN, data_preset=cfg.DATA_PRESET, is_train=True)
    if world > 1:
        logger.info(f"data parallel over {world} ranks, {batch_size // world} samples a rank")

    def batches():
        """This rank's rows of the global batches a single process would draw."""
        for b in batch_iterator(dataset, batch_size, args.view_max, epoch_size):
            yield mesh.shard_batch(b, rank, world) if world > 1 else b

    start_epoch, resumed = 0, None
    if args.resume:
        resumed = Recorder.resume(trainer, args.resume)
        start_epoch = trainer.global_step // steps_per_epoch
        logger.info(f"resumed from {resumed['path']} at step {trainer.global_step} "
                    f"(epoch {start_epoch}) in {resumed['read_s']:.3f} s")

    log_interval = args.log_freq if args.log_freq is not None else cfg.TRAIN.LOG_INTERVAL
    loss_metric = LossMetric()

    # a fixed set replays the same batches every epoch: hold them on the device once
    dev_cache = None
    if bool(cfg.DATASET.TRAIN.get("FIXED_SET", False)):
        first = next(iter(batches()))
        if batch_nbytes(first) * steps_per_epoch <= FIXED_FEED_CACHE_CAP_BYTES:
            dev_cache = cache_on_device(batches(), device)
            logger.info(f"fixed-set feed cached on {device}: {len(dev_cache)} batches, "
                        f"{batch_nbytes(first) * len(dev_cache) / 1e6:.0f} MB")

    evaluator = val_ds = val_feed = None
    losses, val_results, ckpt, step_ms = [], [], None, []
    for epoch in range(start_epoch, cfg.TRAIN.EPOCH):
        t0 = time.time()
        prof = None
        if args.profile and epoch == start_epoch:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.__enter__()
        pending, events = [], []

        def drain():
            for m in pending:
                host = {k: float(v) for k, v in m.items()}
                loss_metric.feed(host, batch_size)
                losses.append(host["loss"])
            pending.clear()

        def stop_profile():
            prof.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            path = os.path.join(args.profile, f"trace_epoch{epoch}.json")
            prof.export_chrome_trace(path)
            logger.info(f"profiler trace written to {path}")

        feed = dev_cache if dev_cache is not None else prefetch_to_device(batches(), device)
        t_log, n_log = time.perf_counter(), 0
        for step_idx, dev_batch in enumerate(feed):
            if on_card:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
            else:
                t_step = time.perf_counter()
            pending.append(trainer.step_sharded(dev_batch))
            if on_card:
                end.record()
                events.append((start, end))
            else:
                step_ms.append((time.perf_counter() - t_step) * 1e3)
            if prof is not None and step_idx + 1 >= PROFILE_STEPS:
                stop_profile()
                prof = None
            n_log += 1
            if step_idx % log_interval == 0:
                metrics = pending[-1]
                drain()  # reads the metrics back: the host waits for the step here
                global_step = epoch * steps_per_epoch + step_idx
                for k, v in metrics.items():
                    summary.add_scalar(k, float(v), global_step)
                dt = (time.perf_counter() - t_log) / n_log
                logger.info(f"epoch {epoch} step {step_idx}/{steps_per_epoch} "
                            f"loss {float(metrics['loss']):.4f} "
                            f"({batch_size / dt:.1f} samples/s, {dt * 1e3:.1f} ms/step)")
                t_log, n_log = time.perf_counter(), 0
        drain()
        if prof is not None:
            stop_profile()
        if on_card:
            torch.cuda.synchronize(device)
            step_ms += [s.elapsed_time(e) for s, e in events]
        recorder.record_loss(loss_metric, epoch, comment="train")
        if (epoch + 1) % max(1, args.ckpt_freq) == 0 or epoch == cfg.TRAIN.EPOCH - 1:
            ckpt = recorder.record_checkpoint(trainer, epoch, snapshot_every=args.snapshot)
            if ckpt is not None:  # rank 0 writes
                logger.info(f"checkpoint {ckpt['path']}: {ckpt['bytes']} bytes in "
                            f"{ckpt['write_s']:.3f} s")
        loss_metric.reset()
        logger.info(f"epoch {epoch} done in {time.time() - t0:.1f}s")

        # validation on rank 0 alone; the others go on into the next epoch's first
        # step, where DDP's all-reduce waits for rank 0
        if "TEST" in cfg.DATASET and (epoch + 1) % args.eval_freq == 0 and rank == 0:
            if evaluator is None:
                # built once: the model, its kernels and the data stream are reused
                val_ds = create_dataset(cfg.DATASET.TEST, data_preset=cfg.DATA_PRESET,
                                        is_train=False)
                evaluator = Evaluator(model, aux, center_idx=cfg.DATA_PRESET.CENTER_IDX)
            val_size = cfg.DATASET.TEST.get("EPOCH_SIZE", 1000)
            if val_feed is None and bool(cfg.DATASET.TEST.get("FIXED_SET", False)):
                cached = cache_on_device(
                    batch_iterator(val_ds, batch_size, args.view_max, val_size), device,
                    keys=None)
                if sum(t.numel() * t.element_size() for t in cached[0].values()) \
                        * len(cached) <= FIXED_FEED_CACHE_CAP_BYTES:
                    val_feed = cached
            results = evaluator.run(val_feed if val_feed is not None else
                                    batch_iterator(val_ds, batch_size, args.view_max, val_size))
            val_results.append(results)
            recorder.record_metric([f"{k}: {v:.6f}" for k, v in results.items()], epoch,
                                   comment="val")
            logger.info(f"val epoch {epoch}: "
                        + ", ".join(f"{k}={v:.4f}" for k, v in results.items()))
    summary.close()
    logger.info("training finished")
    if own_group and mesh.in_group():
        torch.distributed.destroy_process_group()
    return dict(trainer=trainer, losses=losses, val=val_results, checkpoint=ckpt,
                resumed=resumed, start_epoch=start_epoch, step_ms=step_ms,
                dump_path=recorder.dump_path, steps_per_epoch=steps_per_epoch,
                rank=rank, world=world)


def main(argv=None):
    args = parse_exp_args(argv)
    cfg = get_config(args.cfg, arg=args, merge=True)
    return train(cfg, args)


if __name__ == "__main__":
    main()
