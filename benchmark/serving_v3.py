"""The output check of the PtEmbedTRv3 serving cells: every answer against the plain
float32 reference of the v3 forward (``reference/poem_v3_ref.py``) over the same
seeded weights, with ``serving``'s set-up, outputs, gaps and summary."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .reference.poem_ref import Precision, float32_matmuls, load_constants
from .reference.poem_v3_ref import V3Reference
from .serving import DTYPES, INF, gaps, reference_outputs, reference_weights


def judge(answers: List[Tuple[int, dict]], pool, config: dict, seed: int, shapes, device,
          chunk: int, precision: str = "float32", wanted=None):
    """As ``serving.judge``, against :class:`V3Reference`."""
    consts = load_constants(config["MODEL"], device)
    ref = V3Reference(reference_weights(shapes, seed, device, DTYPES[config["serve_dtype"]]),
                      config["MODEL"], consts, Precision(precision))
    wanted, out = ({} if wanted is None else wanted), []
    with float32_matmuls():
        for i, ans in answers:
            if i not in wanted:
                wanted[i] = reference_outputs(ref, pool[i], device, chunk)
            if not all(np.isfinite(v).all() for v in ans.values()):
                out.append(dict(INF))
            else:
                out.append(gaps(ans, wanted[i], pool[i]["view_mask"]))
    return out
