"""step_mfu.train: the train step's operations, 3 x the forward's (valid views only, the
remat recompute not counted), a second of the window's untraced steps after the
profiles, % of the bf16 peak."""
from benchmark.readers import mfu


def read(out, cell):
    forward = mfu(out, cell)
    return None if forward is None else 3.0 * forward
