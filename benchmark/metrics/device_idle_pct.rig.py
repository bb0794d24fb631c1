"""device_idle_pct.rig: the rig window's idle share of the card (%)."""
from benchmark.readers import idle_pct


def read(out, cell):
    return idle_pct(out)
