"""device_idle_pct.serve: the serving window's idle share of the card (%)."""
from benchmark.readers import idle_pct


def read(out, cell):
    return idle_pct(out)
