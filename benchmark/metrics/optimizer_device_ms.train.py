"""optimizer_device_ms.train: device ms a profiled step of the work launched inside
``Optimizer.step`` (per-parameter clipping and Adam)."""
from benchmark.train_profile import phase_ms


def read(out, cell):
    return phase_ms(out, "optim")
