"""Demo: run the predictor on sample frames and write overlays (counterpart of
``poem_v2_tpu/cli/demo.py``).

Loads a config (and optionally a checkpoint), builds a ``Predictor``, warms
up the request's bucket, runs one batch (from the config's test set, or the
synthetic generator) and writes per-view mesh and keypoint overlays, one PNG
a sample, with the raster core::

    python -m poem_v2_tpu_torch.cli.demo -c configs/release/train_medium.yaml \\
        --reload exp/poem_medium/checkpoints/checkpoint.pt --out demo_out

``--device`` is the card by default (``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data import SyntheticMultiviewDataset, collate_padded, create_dataset
from ..mano.model import default_mano
from ..serving.predictor import Predictor
from ..utils.config import Config, load_config_file
from ..utils.logger import get_logger
from ..viztools import denormalize_image, draw_joints_2d, raster, tile_views
from ..viztools.renderer import draw_batch_mesh_images


def main(argv=None):
    p = argparse.ArgumentParser("POEM-v2 demo on PyTorch")
    p.add_argument("-c", "--cfg", type=str, required=True)
    p.add_argument("--reload", type=str, default=None)
    p.add_argument("--out", type=str, default="demo_out")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda by default; cpu runs the kernels' plain "
                        "versions)")
    args = p.parse_args(argv)
    logger = get_logger()

    cfg = Config(load_config_file(args.cfg))
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    predictor = Predictor.from_config(cfg.to_dict(), args.reload, view_bucket=args.views,
                                      dtype=dtype, device=args.device)

    if "DATASET" in cfg and "TEST" in cfg.DATASET:
        ds = create_dataset(cfg.DATASET.TEST, data_preset=cfg.get("DATA_PRESET"), is_train=False,
                            device=args.device)
        it = iter(ds)
        batch = collate_padded([next(it) for _ in range(args.batch)], view_max=args.views)
    else:
        size = cfg.DATA_PRESET.IMAGE_SIZE[0] if "DATA_PRESET" in cfg else 256
        batch = SyntheticMultiviewDataset(batch_size=args.batch, view_max=args.views,
                                          image_size=size, seed=0,
                                          random_views=False).sample_batch()

    warmup_s = predictor.warmup(args.batch)
    t = time.perf_counter()
    out = predictor(batch["image"], batch["cam_intr"], batch["cam_extr"],
                    view_mask=batch["view_mask"])  # host arrays: the device is done
    request_s = time.perf_counter() - t
    logger.info(f"warmup of the B{args.batch} bucket {warmup_s:.3f} s, then the request "
                f"{request_s * 1e3:.1f} ms on {args.device}")

    os.makedirs(args.out, exist_ok=True)
    faces = np.asarray(default_mano().faces)
    images = np.stack([np.stack([denormalize_image(v) for v in sample])
                       for sample in np.asarray(batch["image"])])
    view_mask = np.asarray(batch["view_mask"])
    overlays = draw_batch_mesh_images(images, out["verts_3d"], np.asarray(batch["cam_intr"]),
                                      np.asarray(batch["cam_extr"]), faces, view_mask=view_mask)
    paths = []
    for b in range(overlays.shape[0]):
        panels = [draw_joints_2d(overlays[b, v], out["joints_uv"][b, v])
                  for v in range(args.views) if view_mask[b][v]]
        grid = tile_views(np.stack(panels), cols=min(4, len(panels)))
        path = os.path.join(args.out, f"demo_{b}.png")
        raster.write_png(path, grid)
        paths.append((path, grid))
        logger.info(f"wrote {path}")
    out["timing"] = {"warmup_s": warmup_s, "request_s": request_s}
    out["written"] = paths
    return out


if __name__ == "__main__":
    main()
