"""Flax parameter trees of the JAX package -> ``state_dict`` of the port.

Input: the flax variables as nested dicts of numpy arrays,
``{"params": ..., "batch_stats": ...}`` (``batch_stats`` only with the
``bn`` norm). The port names its submodules after the flax paths, so the
map is mechanical:

* module segments keep their flax names, except the auto-named norms
  (``GroupNorm_i``, ``FrozenBatchNorm_i``, ``BatchNorm_i``) -> ``norm_i``;
* ``kernel`` of rank 4 (conv HWIO) -> ``weight`` OIHW, except under a
  ``deconv{i}`` module (flax ``ConvTranspose``, padding "SAME"), whose
  (kh, kw, in, out) kernel is flipped in space and laid out (in, out, kh, kw),
  ``ConvTranspose2d``'s weight at stride 2, padding 1; of rank 2 (Dense
  (in, out)) -> ``weight`` (out, in), except ``w_ks`` / ``w_vs`` (RawDense),
  whose ``kernel`` stays (in, out) because the kernels take it as a matrix;
* ``scale`` -> ``weight``; FrozenBatchNorm ``mean`` / ``var`` and BatchNorm
  statistics -> ``running_mean`` / ``running_var`` (BatchNorm also gets
  ``num_batches_tracked`` = 0);
* every other leaf (``fc_delta_w1`` ... , ``query_feat_embedding``, PETR's
  ``reference_points``, MVP's ``tgt_pose_embedding``) keeps its name and
  layout.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np

_AUTO_NORM = re.compile(r"^(?:GroupNorm|FrozenBatchNorm|BatchNorm)_(\d+)$")
_RAW_KERNELS = ("w_ks", "w_vs")
_DECONV = re.compile(r"^deconv\d+$")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _module_path(path: Tuple[str, ...]) -> str:
    return ".".join(_AUTO_NORM.sub(r"norm_\1", p) for p in path)


def torch_key(path: Tuple[str, ...], leaf: str, ndim: int) -> str:
    """The port's state_dict key of the flax ``params`` leaf ``path/leaf``."""
    mod = _module_path(path)
    if leaf == "kernel":
        name = "kernel" if path and path[-1] in _RAW_KERNELS else "weight"
    else:
        name = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
    return f"{mod}.{name}" if mod else name


def convert_leaf(path: Tuple[str, ...], leaf: str, value) -> np.ndarray:
    a = np.asarray(value)
    if leaf == "kernel" and not (path and path[-1] in _RAW_KERNELS):
        if a.ndim == 4 and path and _DECONV.match(path[-1]):
            return np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
        if a.ndim == 4:
            return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        if a.ndim == 2:
            return np.ascontiguousarray(a.T)
    return a


def flax_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """Flax variables -> {torch key: numpy array}; raises on a key produced twice."""
    out: Dict[str, np.ndarray] = {}

    def put(key, arr):
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = arr

    for full, value in _leaves(variables.get("params", {})):
        path, leaf = full[:-1], full[-1]
        put(torch_key(path, leaf, np.ndim(value)), convert_leaf(path, leaf, value))
    bn_modules = set()
    for full, value in _leaves(variables.get("batch_stats", {})):
        path, leaf = full[:-1], full[-1]
        put(torch_key(path, leaf, np.ndim(value)), np.asarray(value))
        bn_modules.add(_module_path(path))
    for mod in sorted(bn_modules):
        put(f"{mod}.num_batches_tracked", np.zeros((), np.int64))
    return out
