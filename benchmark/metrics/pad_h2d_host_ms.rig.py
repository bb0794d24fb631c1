"""pad_h2d_host_ms.rig: host ms a request of the untraced tail in the Predictor's pad and
host-to-device copies (its ``pad`` and ``h2d`` spans)."""
from benchmark.program_spans import phase_ms


def read(out, cell):
    return phase_ms(out, "pad", "h2d")
