"""Per-dataset SDK adapters, map-style, host side (counterpart of
``poem_v2_tpu/data/adapters/__init__.py``).

Toolkit-free readers of the published on-disk layouts of every dataset
the reference supports (reference lib/datasets/*.py). These feed the
shard dumper (``poem_v2_tpu_torch.data.dumper``) and offline tooling; the
training path streams the dumped tars (``poem_v2_tpu_torch.data.wds``).
"""

from .arctic import Arctic, ArcticMultiView
from .dexycb import DexYCB, DexYCBMultiView
from .freihand import FreiHAND, FreiHANDV2Extra
from .ho3d import HO3D, HO3DV3, HO3DMultiView
from .interhand import InterHand, InterHandMultiView
from .oakink import OakInk, OakInkMultiView
from .oakink2 import OakInk2Dev, OakInk2MultiView
from .yt3d import YT3D

__all__ = [
    "Arctic", "ArcticMultiView",
    "DexYCB", "DexYCBMultiView",
    "FreiHAND", "FreiHANDV2Extra",
    "HO3D", "HO3DV3", "HO3DMultiView",
    "InterHand", "InterHandMultiView",
    "OakInk", "OakInkMultiView",
    "OakInk2Dev", "OakInk2MultiView",
    "YT3D",
]
