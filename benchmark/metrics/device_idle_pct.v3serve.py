"""device_idle_pct.v3serve: the v3 serving window's idle share of the card (%)."""
from benchmark.readers import idle_pct


def read(out, cell):
    return idle_pct(out)
