"""backward_device_ms.train: device ms a profiled step of the work launched inside
autograd's backward (the engine's evaluate_function events on any thread, the
checkpointed blocks' recompute with it)."""
from benchmark.train_profile import phase_ms


def read(out, cell):
    return phase_ms(out, "backward")
