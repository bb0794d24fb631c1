"""device_idle_pct.train: the training window's idle share of the card (%): 1 - the
timeline's busy time a step over the host-clock time a step of the untraced steps."""
from benchmark.readers import idle_pct


def read(out, cell):
    return idle_pct(out)
