"""Multi-view webdataset tar reader (counterpart of ``poem_v2_tpu/data/wds.py``).

Streams the reference's released ``.tar`` shards with the standard library's
``tarfile``: brace-expanded shard urls, host-level shard splitting (the
replacement for ``wds.split_by_node``, lib/data_wds/multiview_wds.py:47), shard
and sample shuffling, image decode (``data/codec.py``: nvJPEG when the dataset's
``device`` is a CUDA device, OpenCV on the CPU, PNG by the port's decoder on
both), and the reference's ``process_data_item`` (multiview_wds.py:63-144): a
random view subset n ~ round(gauss(4, 2)) clamped to VIEW_RANGE, every
extrinsic re-based on the master (the augmentation's pre-rotation included),
the optional request_flip reflection, the master pinned to view 0. The same
``random.Random`` streams as the JAX package, so a CPU run yields its samples.
"""

from __future__ import annotations

import os
import pickle
import random
import re
import tarfile
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

from ..utils.logger import logger
from .codec import decode_image

# datasets whose stored extrinsics are inverted (multiview_wds.py:14)
INV_EXTR_DATASETS = ("Interhand", "Arctic", "Oakink", "Oakink2")


def brace_expand(pattern: str) -> List[str]:
    """Expand one '{000000..000008}' style range (the only form used)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [
        pattern[: m.start()] + str(i).zfill(width) + pattern[m.end() :]
        for i in range(int(lo), int(hi) + 1)
    ]


def expand_urls(urls: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(urls, str):
        urls = [urls]
    out: List[str] = []
    for u in urls:
        out.extend(brace_expand(os.path.expanduser(os.path.expandvars(u))))
    return out


def iter_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Group tar members by key prefix (webdataset convention)."""
    with tarfile.open(path, "r|*") as tf:
        current_key = None
        sample: Dict[str, bytes] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            key, _, suffix = name.partition(".")
            data = tf.extractfile(member).read()
            if current_key is None:
                current_key = key
            if key != current_key:
                sample["__key__"] = current_key
                yield sample
                sample = {}
                current_key = key
            sample[suffix] = data
        if sample:
            sample["__key__"] = current_key
            yield sample


def decode_sample(raw: Dict[str, bytes], device="cpu") -> Dict:
    """Decode images to (H, W, 3) uint8 RGB on ``device`` + unpickle label.pyd."""
    out: Dict = {"__key__": raw.get("__key__", "")}
    for k, v in raw.items():
        if k == "__key__":
            continue
        if k.startswith("image"):
            out[k] = decode_image(v, device)
        elif k.endswith("pyd") or k == "label.pyd":
            out[k] = pickle.loads(v)
        else:
            out[k] = v
    return out


def split_urls_for_process(urls: List[str], process_index: int, process_count: int) -> List[str]:
    """Disjoint, exhaustive shard split across hosts.

    The SPMD replacement for ``wds.split_by_node``
    (reference multiview_wds.py:47): process i strides the shard list.
    """
    return list(urls[process_index::process_count])


def flip_image(img: np.ndarray, shift: float, size) -> np.ndarray:
    """The request_flip reflection x -> ``shift`` - x of an (H, W, C) uint8 image,
    as ``cv2.warpAffine(img, [[-1, 0, shift], [0, 1, 0]], size)`` (INTER_LINEAR,
    border 0) computes it in OpenCV 5.0: source column ``shift - x``
    in float32, its two neighbours blended as ``f0 + a (f1 - f0)`` with one
    rounding (float32 fused multiply-add), rounded half to even; rows map to
    themselves. ``size`` is (width, height) of the result."""
    w_out, h_out = int(size[0]), int(size[1])
    h_in, w_in, ch = img.shape
    sx = np.float32(shift) - np.arange(w_out, dtype=np.float32)
    ix = np.floor(sx)
    alpha = (sx - ix).astype(np.float64)
    # columns of the source framed by a zero column each side (the border)
    src = np.zeros((h_out, w_in + 2, ch), np.float64)
    rows = min(h_in, h_out)
    src[:rows, 1:w_in + 1] = img[:rows]
    i0 = np.clip(ix.astype(np.int64) + 1, 0, w_in + 1)
    i1 = np.clip(ix.astype(np.int64) + 2, 0, w_in + 1)
    f0, f1 = src[:, i0], src[:, i1]
    out = (f0 + alpha[None, :, None] * (f1 - f0)).astype(np.float32)  # exact, then one rounding
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# -- spawn-pool plumbing (WORKERS_MODE: process) ---------------------------
# Each spawned worker re-imports this module and receives ONE pickled copy
# of the dataset object via the pool initializer (not one per task); tasks
# ship only the raw tar bytes + an int RNG seed. A worker of a dataset on a
# CUDA device decodes through nvJPEG in its own CUDA context.
_POOL_DATASET = None


def _pool_init(pickled_dataset: bytes) -> None:
    global _POOL_DATASET
    _POOL_DATASET = pickle.loads(pickled_dataset)


def _pool_work(raw: Dict[str, bytes], seed: int) -> Dict:
    return _POOL_DATASET.process_data_item(
        decode_sample(raw, _POOL_DATASET.device), rng=random.Random(seed))


def _make_process_pool(dataset: "MultiviewWebDataset", workers: int):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_pool_init,
        initargs=(pickle.dumps(dataset),),
    )


class MultiviewWebDataset:
    """Stream of processed multi-view samples from tar shards; images decoded on
    ``device`` (``data/codec.py``)."""

    def __init__(
        self,
        cfg,
        data_preset=None,
        is_train: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        seed: int = 0,
        device: str = "cpu",
    ):
        from ..utils.registry import build_transform
        from . import transforms  # noqa: F401  (registers the TRANSFORM classes)

        self.device = str(device)

        self.urls = expand_urls(cfg["URLS"])
        self.name = cfg["URLS"].split("/")[-1].split("_")[0]
        self.inv_extr = self.name in INV_EXTR_DATASETS
        self.random_n_views = cfg.get("RANDOM_N_VIEWS", False)
        self.view_range = cfg.get("VIEW_RANGE", None)
        self.is_train = is_train
        self.process_index = process_index
        self.process_count = process_count
        self._seed = seed + process_index
        self.rng = random.Random(self._seed)
        # WORKERS > 1: decode + transform in an ordered pool (the stand-in for
        # the reference DataLoader's num_workers). Samples come in submission
        # order and each sample's RNG is seeded in the submitting thread, so
        # results do not depend on the workers' timing.
        self.workers = int(cfg.get("WORKERS", 0))
        # "thread" (default): the decoders (OpenCV, nvJPEG through ctypes) and
        # the native warp release the GIL, so threads scale where the host has
        # cores. "process": a spawn pool, for transform code that holds the
        # GIL; on a CUDA device each worker opens its own CUDA context.
        self.workers_mode = str(cfg.get("WORKERS_MODE", "thread"))
        if self.workers_mode not in ("thread", "process"):
            raise ValueError(f"WORKERS_MODE {self.workers_mode!r}: thread or process")
        self.transform = build_transform(
            cfg["TRANSFORM"], data_preset=data_preset, is_train=is_train
        )
        if self.random_n_views:
            assert self.view_range is not None and self.view_range[0] >= 1

    def _shards_for_host(self) -> List[str]:
        return split_urls_for_process(self.urls, self.process_index, self.process_count)

    def _raw_stream(self) -> Iterator[Dict]:
        """Shuffled stream of RAW (still-encoded) samples.

        The shuffle buffer holds jpeg bytes rather than decoded arrays —
        same ordering decisions as the reference's shuffle(1000), ~10x
        less resident memory.
        """
        shards = self._shards_for_host()
        if self.is_train:
            shards = list(shards)
            self.rng.shuffle(shards)
        buffer: List[Dict] = []
        buffer_size = 1000 if self.is_train else 0
        for shard in shards:
            if not os.path.exists(shard):
                logger.warning(f"shard missing, skipped: {shard}")
                continue
            for raw in iter_tar_samples(shard):
                if buffer_size:
                    buffer.append(raw)
                    if len(buffer) >= buffer_size:
                        idx = self.rng.randrange(len(buffer))
                        yield buffer.pop(idx)
                else:
                    yield raw
        while buffer:
            idx = self.rng.randrange(len(buffer))
            yield buffer.pop(idx)

    def __iter__(self) -> Iterator[Dict]:
        stream = self._raw_stream()
        if self.workers <= 1:
            for raw in stream:
                yield self.process_data_item(decode_sample(raw, self.device))
            return
        from collections import deque

        if self.workers_mode == "process":
            ex = _make_process_pool(self, self.workers)
            submit = lambda raw, i: ex.submit(
                _pool_work, raw, self._seed * 1_000_003 + i)
        else:
            from concurrent.futures import ThreadPoolExecutor

            ex = ThreadPoolExecutor(self.workers)

            def work(raw: Dict, rng: random.Random) -> Dict:
                return self.process_data_item(decode_sample(raw, self.device), rng=rng)

            submit = lambda raw, i: ex.submit(
                work, raw, random.Random(self._seed * 1_000_003 + i))
        try:
            futs: deque = deque()
            for i, raw in enumerate(stream):
                # per-sample RNG seed drawn HERE (deterministic submission
                # order), so results are worker-timing independent
                futs.append(submit(raw, i))
                if len(futs) >= self.workers * 2:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    # -- the reference's process_data_item, loop-for-loop ------------------
    def process_data_item(self, item: Dict, rng: random.Random = None) -> Dict:
        imgs = {k: v for k, v in item.items() if k.startswith("image")}
        n_cams = len(imgs)
        labels = dict(item["label.pyd"])
        img_type = "png" if any("png" in k for k in imgs) else "jpg"

        if "mano_pose" in labels:
            labels["mano_pose"] = [
                np.asarray(labels["mano_pose"][i]).reshape(-1)[:48].reshape(16, 3)
                for i in range(n_cams)
            ]
        else:
            labels["mano_pose"] = [np.zeros((16, 3), np.float32) for _ in range(n_cams)]
            labels["mano_shape"] = [np.zeros(10, np.float32) for _ in range(n_cams)]
        if self.inv_extr:
            labels["cam_extr"] = [np.linalg.inv(labels["cam_extr"][i]) for i in range(n_cams)]

        rng = rng if rng is not None else self.rng
        indices = list(range(n_cams))
        if self.random_n_views:
            rng.shuffle(indices)
            n = int(round(rng.gauss(4, 2)))
            n = min(max(self.view_range[0], n), self.view_range[1])
            n = min(n, n_cams)
            indices_keep = indices[:n]
        else:
            indices_keep = indices

        new_master = indices_keep[0]
        t_master_2_new = labels["cam_extr"][new_master]
        master_joints_3d = labels["joints_3d"][new_master]
        master_verts_3d = labels["verts_3d"][new_master]

        res: Dict[str, List] = {}
        for ind in indices_keep:
            img = imgs[f"image_{ind}.{img_type}"]
            if labels.get("request_flip", False):
                intr = labels["cam_intr"][ind]
                raw_size = tuple(labels["raw_size"][ind])
                cc = np.array([intr[0, 2], intr[1, 2]])
                m = np.array([[-1, 0, 2 * cc[0]], [0, 1, 0]], dtype=np.float32)
                img = flip_image(img, m[0, 2], raw_size)

            lab = {k: v[ind] for k, v in labels.items() if k != "request_flip"}
            tgt = self.transform(img, lab, no_rot=(ind == new_master))

            # extrinsic re-basing incl. augmentation pre-rotation
            # (multiview_wds.py:119-126)
            t_m2c = lab["cam_extr"]
            t_new_2_cam = np.linalg.inv(t_master_2_new) @ t_m2c
            prerot = np.eye(4)
            prerot[:3, :3] = tgt["extr_prerot"]
            tgt["target_cam_extr"] = np.linalg.inv(prerot @ np.linalg.inv(t_new_2_cam)).astype(
                np.float32
            )

            for k, v in {**lab, **tgt}.items():
                res.setdefault(k, []).append(v)

        out = {}
        for k, v in res.items():
            if isinstance(v[0], (int, float, np.integer, np.floating, np.ndarray)):
                out[k] = np.stack([np.asarray(x) for x in v])
            else:
                out[k] = v
        out["master_id"] = 0
        out["master_joints_3d"] = np.asarray(master_joints_3d, dtype=np.float32)
        out["master_verts_3d"] = np.asarray(master_verts_3d, dtype=np.float32)
        out["__key__"] = item.get("__key__", "")
        return out


class MixWebDataset:
    """Ratio mixer over several MultiviewWebDataset streams
    (reference lib/datasets/mix_dataset.py:79-93 / wds.RandomMix)."""

    def __init__(self, datasets: Sequence[MultiviewWebDataset], ratios: Sequence[float], seed: int = 0):
        self.datasets = list(datasets)
        total = float(sum(ratios))
        self.ratios = [r / total for r in ratios]
        self.rng = random.Random(seed)

    def __iter__(self) -> Iterator[Dict]:
        iters = [iter(d) for d in self.datasets]
        alive = list(range(len(iters)))
        while alive:
            i = self.rng.choices(alive, weights=[self.ratios[a] for a in alive])[0]
            try:
                yield next(iters[i])
            except StopIteration:
                alive.remove(i)
