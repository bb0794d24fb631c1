"""The PtEmbedTRv3 model's operations a sample, by its number of valid views.

Counted as ``counts/model.py`` counts the flagship's: ``FlopCounterMode`` (products
and convolutions, 2 operations a multiply-add) over the v3 reference forward
(``reference/poem_v3_ref.py``) on the meta device, one sample with 1 and with 2
views, all valid; the count is linear in the views (the backbone, the necks, the
head's per-view layers and the coarse mesh's sampling and merge) plus a part a
sample (the BPS merge's master path, the METRO stage and the refinement).
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.poem_ref import Precision, load_constants
from ..reference.poem_v3_ref import V3Reference


def _count(model_cfg: dict, shapes, views: int, size: int) -> float:
    dev = torch.device("meta")
    params = {n: torch.empty(s, device=dev) for n, s in shapes}
    consts = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
              for k, v in load_constants(model_cfg, "cpu").items()}
    ref = V3Reference(params, model_cfg, consts, Precision("float32"))
    img = torch.empty((1, views, size, size, 3), device=dev)
    mask = torch.ones((1, views), dtype=torch.bool, device=dev)
    intr = torch.empty((1, views, 3, 3), device=dev)
    extr = torch.empty((1, views, 4, 4), device=dev)
    joints = torch.empty((1, 21, 3), device=dev)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(img, mask, intr, extr, ref_joints=joints)
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=8)
def _linear(model_json: str, shapes_json: str, size: int):
    model_cfg = json.loads(model_json)
    shapes = [(n, tuple(s)) for n, s in json.loads(shapes_json)]
    f1 = _count(model_cfg, shapes, 1, size)
    return f1, _count(model_cfg, shapes, 2, size) - f1


def forward_flops(model_cfg: dict, shapes, views: int, size: int = 256) -> float:
    """Operations of one sample's v3 forward with ``views`` valid views."""
    f1, per_view = _linear(json.dumps(model_cfg, sort_keys=True),
                           json.dumps([[n, list(s)] for n, s in shapes]), size)
    return f1 + (views - 1) * per_view
