"""knn_attn_bwd_roofline_pct.train: K6b's least time a step (``counts/train.py``) over
the device time of its ``knn_bwd_*`` kernels a step on the timeline (%)."""
from benchmark.counts.train import knn_bwd_least_ms

GROUP = "K6b knn_bwd_*"


def read(out, cell):
    t, dev_s = out.trace, out.facts.get("device_groups_s", {}).get(GROUP, 0.0)
    if t is None or dev_s <= 0:
        return None
    return 100.0 * knn_bwd_least_ms(cell) * t.steps / 1e3 / dev_s
