"""Single-dataset eval entry point (counterpart of ``poem_v2_tpu/cli/eval_single.py``;
reference scripts/eval_single.py).

Holds the pinned per-dataset eval protocol (tar shard urls, max views, frame
counts; eval_single.py:5-36) and the model-size table (eval_single.py:38-39),
builds the eval config in memory and runs the port's eval CLI body
(``cli/eval.py:evaluate``) on it: no YAML file is written, so it runs where
PyYAML is absent. Shard images decode on ``--device`` (nvJPEG on the card).

Usage:
  python -m poem_v2_tpu_torch.cli.eval_single -d DexYCB -m medium --reload <ckpt> \\
      [--eval_extra auc] [--device cuda] [--dtype bf16]
"""

from __future__ import annotations

import argparse

from ..utils.config import Config

# per-dataset eval protocol (reference scripts/eval_single.py:5-36)
DATASET_META = {
    "HO3D": {
        "urls": "data/dataset_tars/HO3D_mv/HO3D_mv_test-{000000..000002}.tar",
        "max_view": 5,
        "epoch_size": 2706,
    },
    "DexYCB": {
        "urls": "data/dataset_tars/DexYCB_mv/DexYCB_mv_test-{000000..000003}.tar",
        "max_view": 8,
        "epoch_size": 4950,
    },
    "Arctic": {
        "urls": "data/dataset_tars/Arctic_mv/Arctic_mv_val_p1-{000000..000045}.tar",
        "max_view": 8,
        "epoch_size": 17392,
    },
    "Interhand": {
        "urls": "data/dataset_tars/Interhand_mv/Interhand_mv_val-{000000..000022}.tar",
        "max_view": 8,
        "epoch_size": 85255,
    },
    "Oakink": {
        "urls": "data/dataset_tars/Oakink_mv/Oakink_mv_test-{000000..000045}.tar",
        "max_view": 4,
        "epoch_size": 21351,
    },
    "Freihand": {
        "urls": "data/dataset_tars/Freihand_mv/Freihand_mv_test-000000.tar",
        "max_view": 1,
        "epoch_size": 3960,
    },
}

# model size tier -> embed dim (reference eval_single.py:38-39)
MODEL_SIZES = {"small": 128, "medium": 256, "large": 512, "huge": 1024, "medium_MANO": 256}


def build_eval_cfg(dataset: str, model_size: str, reload_path: str, view_range=None,
                   urls=None, epoch_size=None, model_overrides=None) -> Config:
    """Build the pinned per-dataset eval config.

    ``urls`` / ``epoch_size`` override the shard location (protocol
    semantics — view ranges, transforms, model wiring — stay pinned);
    ``model_overrides`` merges a dict over cfg.MODEL (the six-protocol
    contract test shrinks the model with it to drive every dataset chain
    on CPU). The released tiers never pass any of the three.
    """
    meta = DATASET_META[dataset]
    embed = MODEL_SIZES[model_size]
    parametric = model_size.endswith("_MANO")
    view_max = meta["max_view"]
    vr = view_range or [1 if view_max == 1 else 2, view_max]

    cfg = Config(
        {
            "TRAIN": {"BATCH_SIZE": 8, "MANUAL_SEED": 1, "EPOCH": 1, "OPTIMIZER": "adam",
                      "LR": 1e-4, "SCHEDULER": "constant"},
            "DATA_PRESET": {
                "CENTER_IDX": 0,
                "NUM_JOINTS": 21,
                "NUM_VERTS": 778,
                "IMAGE_SIZE": [256, 256],
            },
            "DATASET": {
                "TEST": {
                    "TYPE": "MultiviewWebDataset",
                    "URLS": meta["urls"],
                    "DATA_SPLIT": "test",
                    "EPOCH_SIZE": meta["epoch_size"],
                    "RANDOM_N_VIEWS": True,
                    "VIEW_RANGE": vr,
                    "TRANSFORM": {"TYPE": "SimpleTransform3DMultiView", "AUG": False},
                }
            },
            "MODEL": {
                "TYPE": "PtEmbedMultiviewStereoV2",
                "PRETRAINED": reload_path,
                "BACKBONE": {"TYPE": "HRNet", "WIDTH": 40, "NORM": "gn"},
                "HEAD": {
                    "TYPE": "POEM_Generalized_Head",
                    "TRANSFORMER": {
                        "TYPE": "PtEmbedTRv4",
                        "N_BLOCKS": 3,
                        "INPUT_FEAT_DIM": embed,
                        "NUM_ATTENTION_HEADS": 4,
                        "DROPOUT": 0.1,
                        "BPS_FEAT_DIM": 4096,
                        "N_NEIGHBOR": 32,
                        "N_NEIGHBOR_QUERY": 32,
                        "PARAMETRIC_OUTPUT": parametric,
                    },
                    "POSITIONAL_ENCODING": {"NUM_FEATS": 128, "NORMALIZE": True},
                    "NUM_QUERY": 799,
                    "NUM_PREDS": 3,
                    "DEPTH_NUM": 32,
                    "POSITION_RANGE": [-0.6, -0.6, 0.0, 0.6, 0.6, 1.2],
                    "LID": False,
                    "DEPTH_START": 0.0,
                    "DEPTH_END": 1.2,
                    "POINTS_FEAT_DIM": embed,
                    "EMBED_DIMS": embed,
                    "IN_CHANNELS": 160,
                    "N_SAMPLE": 4096,
                    "RADIUS_SAMPLE": 0.1,
                    "CAM_FEAT_MERGE": "attn",
                    "QUERY_TYPE": "KPT",
                },
                "LOSS": {
                    "JOINTS_LOSS_TYPE": "l2",
                    "VERTICES_LOSS_TYPE": "l1",
                    "HEATMAP_JOINTS_WEIGHT": 10.0,
                    "JOINTS_LOSS_WEIGHT": 1.0,
                    "VERTICES_LOSS_WEIGHT": 1.0,
                    "JOINTS_2D_LOSS_WEIGHT": 1.0,
                },
            },
        }
    )
    if urls is not None:
        cfg.DATASET.TEST.URLS = urls
    if epoch_size is not None:
        cfg.DATASET.TEST.EPOCH_SIZE = int(epoch_size)
    if model_overrides:
        cfg.MODEL.merge(model_overrides)
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser("eval_single")
    p.add_argument("-d", "--dataset", required=True, choices=sorted(DATASET_META))
    p.add_argument("-m", "--model_size", default="medium", choices=sorted(MODEL_SIZES))
    p.add_argument("--reload", required=True)
    p.add_argument("--eval_extra", default="auc")
    p.add_argument("--view_min", type=int, default=None)
    p.add_argument("--view_max", type=int, default=None)
    p.add_argument("--approx_knn", action="store_true",
                   help="accepted and without effect: the port always selects neighbours "
                        "exactly (the reference's pytorch3d knn is exact)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda by default; cpu runs the kernels' plain "
                        "versions and decodes JPEG with OpenCV)")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    args = p.parse_args(argv)

    meta = DATASET_META[args.dataset]
    vr = None
    if args.view_min or args.view_max:
        vr = [args.view_min or 1, args.view_max or meta["max_view"]]
    cfg = build_eval_cfg(args.dataset, args.model_size, args.reload, view_range=vr)

    from ..utils.config import get_config
    from .eval import evaluate
    from .opt import parse_exp_args

    eval_args = parse_exp_args([
        "-c", f"<eval_single {args.dataset}>",
        "--exp_id", f"eval_{args.dataset}_{args.model_size}",
        "--reload", args.reload,
        "--eval_extra", args.eval_extra,
        "--view_max", str(meta["max_view"]),
        "--device", args.device,
        "--dtype", args.dtype,
    ])
    return evaluate(get_config(cfg.to_dict(), arg=eval_args, merge=True), eval_args)


if __name__ == "__main__":
    main()
