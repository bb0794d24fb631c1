"""step_mfu.serve: the forward's operations (valid views) a second of the window's untraced
steps after the profiles, % of the bf16 peak."""
from benchmark.readers import mfu


def read(out, cell):
    return mfu(out, cell)
