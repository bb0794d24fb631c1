"""Seeded weights for the program and the reference, made on the device.

The scales are a copy of ``poem_v2_tpu_torch/models/poem.py:init_parameters``
(l.179-212): N(0, 0.02) for the BERT attention / FFN dense layers and the
query embedding, U(0, 1) for reference embeddings, other matrices at half the
lecun-normal scale (at the full scale the decoded points leave the hand and
neighbour distances tie), zero biases, unit norm scales. The draws differ from
``init_parameters``'s: one ``randn`` and one ``rand`` over all leaves, from a
generator on the device, then a slice of each per leaf.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Tuple

import torch

_BERT = re.compile(r"\.(attn|cross_attn|ffn|layer\d+_attn|layer\d+_ffn)\.")


def leaf_rule(name: str, shape: Tuple[int, ...]):
    """("ones" | "zeros" | "uniform" | "normal", std) of one parameter."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1:
        return ("ones", 0.0) if leaf in ("weight", "running_var") else ("zeros", 0.0)
    if leaf in ("reference_embed", "reference_points", "tgt_pose_embedding"):
        return "uniform", 0.0
    if leaf in ("query_feat_embedding", "position_embeddings") or _BERT.search(name):
        return "normal", 0.02
    # torch layouts are (out, in, ...); raw kernels and MLP parameters are (in, out)
    raw = leaf == "kernel" or leaf.startswith("fc_")
    fan_in = shape[0] if raw else math.prod(shape[1:])
    return "normal", 0.5 / math.sqrt(fan_in)


def make_weights(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, a function of ``seed`` alone."""
    items = [(n, tuple(s), leaf_rule(n, tuple(s))) for n, s in named_shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(math.prod(s) for _, s, (k, _) in items if k == "normal")
    n_unif = sum(math.prod(s) for _, s, (k, _) in items if k == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) if n_unif else None
    out, i_n, i_u = {}, 0, 0
    for name, shape, (kind, std) in items:
        size = math.prod(shape)
        if kind == "normal":
            out[name] = normal[i_n:i_n + size].view(shape).mul_(std)
            i_n += size
        elif kind == "uniform":
            out[name] = unif[i_u:i_u + size].view(shape)
            i_u += size
        else:
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` over every parameter of ``model`` (cast to each one's dtype)."""
    params = dict(model.named_parameters())
    missing = set(params) ^ set(weights)
    if missing:
        raise KeyError(f"weights and model differ in {sorted(missing)[:5]}")
    for name, p in params.items():
        p.copy_(weights[name])
