"""Data: the webdataset shards, the synthetic multi-view dataset, padded collation
and the dataset factory (counterpart of ``poem_v2_tpu/data/__init__.py``)."""

import itertools

from .collate import batch_iterator, collate_padded, pad_views
from .synthetic import SyntheticMultiviewDataset
from .transforms import SimpleTransform3DMultiView
from .wds import MixWebDataset, MultiviewWebDataset, expand_urls


class SyntheticSampleStream:
    """Per-sample adapter over the synthetic generator, so that
    :func:`batch_iterator` / :func:`collate_padded` apply unchanged.

    ``fixed_set=True`` draws the first ``epoch_size`` samples once and
    replays them every epoch (the overfitting protocols); otherwise every
    epoch streams fresh samples."""

    def __init__(self, view_max=8, image_size=256, epoch_size=0, seed=0, fixed_set=False,
                 view_range=None, render=False):
        gen_kw = {} if view_range is None else {"view_range": tuple(view_range)}
        self._gen = SyntheticMultiviewDataset(batch_size=1, view_max=view_max,
                                              image_size=image_size, seed=seed, render=render,
                                              **gen_kw)
        self.epoch_size = epoch_size
        self.fixed_set = fixed_set and epoch_size > 0
        self._cache = None

    def _draw(self):
        b = self._gen.sample_batch()
        n = int(b["view_mask"][0].sum())
        return {
            "image": b["image"][0, :n],
            "target_cam_intr": b["cam_intr"][0, :n],
            "target_cam_extr": b["cam_extr"][0, :n],
            "target_joints_2d": b["target_joints_2d"][0, :n],
            "master_joints_3d": b["master_joints_3d"][0],
            "master_verts_3d": b["master_verts_3d"][0],
            "mano_pose": b["mano_pose"][:1].repeat(n, 0),
            "mano_shape": b["mano_shape"][:1].repeat(n, 0),
        }

    def __iter__(self):
        if self.fixed_set:
            if self._cache is None:
                self._cache = [self._draw() for _ in range(self.epoch_size)]
            yield from self._cache
            return
        for _ in (itertools.count() if not self.epoch_size else range(self.epoch_size)):
            yield self._draw()


def create_dataset(cfg, data_preset=None, is_train: bool = True, **kwargs):
    """Dataset factory (reference lib/datasets/__init__.py:14-35).

    ``MixWebDataset`` configs carry a ``DATASET_LIST`` of per-dataset blocks with
    ``MIX_RATIO``; ``MultiviewWebDataset`` / ``WebDataset`` build one stream of
    shards (``kwargs``, e.g. ``device``, go to each); ``Synthetic`` the generator;
    any other ``TYPE`` a registered adapter (``data/adapters``), which decodes its
    raw frames on ``kwargs["device"]``."""
    kind = cfg["TYPE"]
    if kind == "MixWebDataset":
        datasets, ratios = [], []
        for name in cfg["DATASET_LIST"]:
            sub = cfg[name]
            datasets.append(MultiviewWebDataset(sub, data_preset=data_preset, is_train=is_train,
                                                **kwargs))
            ratios.append(sub["MIX_RATIO"])
        return MixWebDataset(datasets, ratios)
    if kind in ("MultiviewWebDataset", "WebDataset"):
        return MultiviewWebDataset(cfg, data_preset=data_preset, is_train=is_train, **kwargs)
    if kind == "Synthetic":
        return SyntheticSampleStream(
            view_max=cfg.get("VIEW_MAX", 8),
            image_size=cfg.get("IMAGE_SIZE", 256),
            epoch_size=cfg.get("EPOCH_SIZE", 0),
            seed=cfg.get("SEED", 0),
            fixed_set=cfg.get("FIXED_SET", False),
            view_range=cfg.get("VIEW_RANGE", None),
            render=cfg.get("RENDER", False),
        )
    # the map-style adapters (DexYCB / HO3D / OakInk / InterHand / Arctic /
    # FreiHAND and their multi-view variants) register themselves on import
    from . import adapters  # noqa: F401
    from ..utils.registry import DATASET

    if kind in DATASET:
        ds = DATASET.get(kind)(cfg)
        ds.device = str(kwargs.get("device", "cpu"))
        return ds
    raise ValueError(f"unknown dataset TYPE {kind!r}")


__all__ = ["MixWebDataset", "MultiviewWebDataset", "SimpleTransform3DMultiView",
           "SyntheticMultiviewDataset", "SyntheticSampleStream", "batch_iterator",
           "collate_padded", "create_dataset", "expand_urls", "pad_views"]
