"""Grid helpers for bilinear point sampling (counterpart of ``poem_v2_tpu/ops/sampling.py``).

The sampler itself is kernel K4 (:mod:`.bilinear`), whose plain version
:func:`.bilinear.plain_grid_sample_points` is the JAX package's
``grid_sample_points_matmul`` contract.
"""

from __future__ import annotations

import torch


def pixel_to_grid(uv: torch.Tensor, inp_res) -> torch.Tensor:
    """Pixel coords (..., 2) -> [-1, 1] grid coords: uv / inp_res * 2 - 1."""
    res = torch.tensor(inp_res, dtype=uv.dtype, device=uv.device)
    return uv / res * 2.0 - 1.0
