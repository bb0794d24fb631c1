"""Component registries (counterpart of ``poem_v2_tpu/utils/registry.py``), as far
as the port needs them: the data layer's ``TRANSFORM`` and ``DATASET``, and the
models' ``MODEL``, ``HEAD``, ``BACKBONE``, ``TRANSFORMER`` and ``ATTENTION``.

``build_from_cfg`` keeps the JAX package's contract: look ``cfg.TYPE`` up, merge
the extra keyword arguments (upper-cased) into a clone of ``cfg`` and call the
registered class or function with it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .config import Config


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def get(self, key: str) -> Callable:
        if key not in self._module_dict:
            raise KeyError(f"{key!r} is not registered in registry {self.name!r}; "
                           f"available: {sorted(self._module_dict)}")
        return self._module_dict[key]

    def keys(self):
        return self._module_dict.keys()

    def register_module(self, name: Optional[str] = None):
        """A decorator: ``@DATASET.register_module("DexYCB")``."""

        def _wrapper(obj):
            key = name or obj.__name__
            if self._module_dict.get(key, obj) is not obj:
                raise KeyError(f"{key!r} already registered in {self.name!r}")
            self._module_dict[key] = obj
            return obj

        return _wrapper


def build_from_cfg(cfg: Config, registry: Registry, **kwargs: Any):
    """``registry.get(cfg.TYPE)(cfg)``, the extra keyword arguments merged
    (upper-cased) into a clone of ``cfg``; ``data_preset`` as ``DATA_PRESET``."""
    if "TYPE" not in cfg:
        raise KeyError(f"cfg for registry {registry.name!r} has no TYPE field: {cfg}")
    cls = registry.get(cfg["TYPE"])
    cfg = Config(cfg).clone()
    data_preset = kwargs.pop("data_preset", None)
    for k, v in kwargs.items():
        cfg[k.upper()] = v
    if data_preset is not None:
        cfg["DATA_PRESET"] = data_preset
    return cls(cfg)


DATASET = Registry("dataset")
TRANSFORM = Registry("transform")
MODEL = Registry("model")
ATTENTION = Registry("attention")
TRANSFORMER = Registry("transformer")
HEAD = Registry("head")
BACKBONE = Registry("backbone")


def build_transform(cfg: Config, **kwargs):
    return build_from_cfg(cfg, TRANSFORM, **kwargs)
