"""Hierarchical configuration tree (counterpart of ``poem_v2_tpu/utils/config.py``).

``Config`` is a dict with attribute access, recursive conversion, freezing,
merge, clone and dump; :func:`get_config` loads an experiment config and
merges the CLI's overrides by the JAX package's rules. PyYAML is optional:
when it imports, a config file is read with it; otherwise a file whose stem
names a configuration of :mod:`poem_v2_tpu_torch.configs` (the seven
``configs/synthetic_*.yaml``, or ``train_<tier>`` of the released ones) is
taken from there, and any other file raises, naming the missing parser.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
from typing import Any, Dict, Mapping, Optional, Union


def _yaml():
    """The PyYAML module, or None where it is not installed."""
    try:
        return importlib.import_module("yaml")
    except ImportError:
        return None


class Config(dict):
    """A dict with attribute access, recursive conversion and freezing: nested
    dicts become ``Config`` nodes, lists of dicts lists of ``Config`` nodes."""

    __slots__ = ("_frozen",)

    def __init__(self, init: Optional[Mapping[str, Any]] = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = _convert(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if self.frozen:
            raise AttributeError(f"Config is frozen; cannot set {key!r}")
        super().__setitem__(key, _convert(value))

    @property
    def frozen(self) -> bool:
        return object.__getattribute__(self, "_frozen")

    def _set_frozen(self, frozen: bool) -> "Config":
        object.__setattr__(self, "_frozen", frozen)
        for v in self.values():
            for item in (v if isinstance(v, list) else [v]):
                if isinstance(item, Config):
                    item._set_frozen(frozen)
        return self

    def freeze(self) -> "Config":
        return self._set_frozen(True)

    def defrost(self) -> "Config":
        return self._set_frozen(False)

    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Recursively merge ``other`` on top of this config."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def clone(self) -> "Config":
        return Config(self.to_dict())

    def to_dict(self) -> Dict[str, Any]:
        return _deconvert(self)

    def dump(self, stream=None) -> str:
        """YAML where PyYAML imports; otherwise JSON, which YAML parsers also read."""
        yaml = _yaml()
        text = (yaml.safe_dump(self.to_dict(), sort_keys=False) if yaml is not None
                else json.dumps(self.to_dict(), indent=2) + "\n")
        if stream is not None:
            stream.write(text)
        return text

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(self.to_dict(), memo))

    def __reduce__(self):
        return (Config, (self.to_dict(),))


def _convert(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return [_convert(x) for x in v]
    return v


def _deconvert(v: Any) -> Any:
    if isinstance(v, Config):
        return {k: _deconvert(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_deconvert(x) for x in v]
    return v


def known_configs() -> Dict[str, dict]:
    """The configurations this package holds as data, by the stem of their file."""
    from ..configs import RELEASE, SYNTHETIC

    return {**SYNTHETIC, **{f"train_{name}": cfg for name, cfg in RELEASE.items()}}


def load_config_file(path: str) -> Dict[str, Any]:
    """The contents of a config file as a dict (see the module docstring)."""
    yaml = _yaml()
    if yaml is not None:
        with open(path, "r") as f:
            return yaml.safe_load(f) or {}
    stem = os.path.splitext(os.path.basename(path))[0]
    known = known_configs()
    if stem in known:
        return copy.deepcopy(known[stem])
    raise RuntimeError(f"cannot read {path}: PyYAML is not installed, and {stem!r} names no "
                       f"configuration of poem_v2_tpu_torch/configs.py ({sorted(known)})")


# Defaults of the reference TRAIN block (lib/utils/config.py:46-63).
DEFAULT_TRAIN = {
    "MANUAL_SEED": 1,
    "CONV_REPEATABLE": True,
    "BATCH_SIZE": 8,
    "EPOCH": 10,
    "OPTIMIZER": "adam",
    "LR": 1e-4,
    "SCHEDULER": "StepLR",
    "LR_DECAY_GAMMA": 0.1,
    "LR_DECAY_STEP": [7],
    "LOG_INTERVAL": 10,
    "FIND_UNUSED_PARAMETERS": False,
    "GRAD_CLIP_ENABLED": True,
    "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0},
    "WEIGHT_DECAY": 0.0,
}


def get_config(config_file: Union[str, Mapping[str, Any]], arg: Optional[Any] = None,
               merge: bool = True) -> Config:
    """An experiment config from a file (or a dict of one), frozen.

    Over ``DEFAULT_TRAIN``; with ``merge``, ``arg.batch_size`` overrides
    ``TRAIN.BATCH_SIZE``, ``arg.reload`` ``MODEL.PRETRAINED`` and
    ``arg.val_batch_size`` ``TRAIN.VAL_BATCH_SIZE``, as the JAX package does."""
    cfg = Config({"TRAIN": copy.deepcopy(DEFAULT_TRAIN)})
    cfg.merge(config_file if isinstance(config_file, Mapping)
              else load_config_file(config_file))
    if merge and arg is not None:
        batch_size = getattr(arg, "batch_size", None)
        if batch_size:
            cfg.TRAIN.BATCH_SIZE = batch_size
        reload_ckpt = getattr(arg, "reload", None)
        if reload_ckpt:
            if "MODEL" not in cfg:
                cfg.MODEL = {}
            cfg.MODEL.PRETRAINED = reload_ckpt
        val_batch_size = getattr(arg, "val_batch_size", None)
        if val_batch_size:
            cfg.TRAIN.VAL_BATCH_SIZE = val_batch_size
    return cfg.freeze()
