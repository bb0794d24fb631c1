"""Dump multi-view webdataset shards with the PyTorch port (counterpart of
``scripts/dump_shards.py``).

Samples of the port's synthetic generator (``poem_v2_tpu_torch/data/synthetic.py``)
written by its shard dumper (``poem_v2_tpu_torch/data/dumper.py``) in the
reference's tar layout, images encoded on ``--device`` (nvJPEG on a CUDA card,
OpenCV on the CPU); for smoke-testing the streaming path end to end.

  python scripts/torch_dump_shards.py --out data/dataset_tars/Synth_mv \\
      --prefix Synth_mv_train --num 64 [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true",
                   help="accepted for scripts/dump_shards.py's command lines: the synthetic "
                        "generator is the only source")
    p.add_argument("--out", required=True)
    p.add_argument("--prefix", required=True)
    p.add_argument("--num", type=int, default=64)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--per-shard", type=int, default=32)
    p.add_argument("--device", default="cuda", help="where JPEG is encoded (cuda: nvJPEG)")
    args = p.parse_args(argv)

    from poem_v2_tpu_torch.data import SyntheticMultiviewDataset
    from poem_v2_tpu_torch.data.dumper import ShardDumper

    ds = SyntheticMultiviewDataset(batch_size=1, view_max=args.views,
                                   image_size=args.image_size, random_views=False)
    V = range(args.views)
    with ShardDumper(args.out, args.prefix, args.per_shard, device=args.device) as dumper:
        for i in range(args.num):
            b = ds.sample_batch()
            m2c = [np.linalg.inv(b["cam_extr"][0, v]) for v in V]
            label = {
                "cam_serial": [f"cam{v}" for v in V],
                "cam_extr": [b["cam_extr"][0, v] for v in V],
                "cam_intr": [b["cam_intr"][0, v] for v in V],
                "joints_2d": [b["target_joints_2d"][0, v] for v in V],
                # per-view camera-space labels
                "joints_3d": [b["master_joints_3d"][0] @ m2c[v][:3, :3].T + m2c[v][:3, 3]
                              for v in V],
                "verts_3d": [b["master_verts_3d"][0] @ m2c[v][:3, :3].T + m2c[v][:3, 3]
                             for v in V],
                "joints_vis": [np.ones(21, np.float32)] * args.views,
                "bbox_center": [b["target_joints_2d"][0, v].mean(0) for v in V],
                "bbox_scale": [np.float32(args.image_size * 0.6)] * args.views,
                "raw_size": [np.array([args.image_size, args.image_size])] * args.views,
                "mano_pose": [b["mano_pose"][0].reshape(-1)] * args.views,
                "mano_shape": [b["mano_shape"][0]] * args.views,
            }
            imgs = [np.clip((b["image"][0, v] + 0.5) * 255, 0, 255).astype(np.uint8) for v in V]
            dumper.add_sample(f"seq0/{i:06d}", imgs, label)
    print(f"dumped {args.num} samples to {args.out}/{args.prefix}-*.tar")


if __name__ == "__main__":
    main()
