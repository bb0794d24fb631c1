"""step_mfu.v3serve: the v3 forward's operations (valid views, ``counts/model_v3.py``)
a second of the window's untraced steps after the profiles, % of the bf16 peak."""
from benchmark.counts.model_v3 import forward_flops
from benchmark.counts.peaks import PEAK_FLOPS


def read(out, cell):
    views, seconds = out.facts.get("tail_views", []), out.facts.get("tail_seconds", 0.0)
    if out.trace is None or not views or seconds <= 0:
        return None
    cfg, size = cell.config["MODEL"], cell.traffic["image_size"]
    shapes = out.facts["param_shapes"]
    ops = sum(forward_flops(cfg, shapes, v, size) for v in views)
    return 100.0 * ops / seconds / PEAK_FLOPS["bfloat16"]
