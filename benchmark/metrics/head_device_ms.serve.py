"""head_device_ms.serve: device ms a batch of the kernels launched inside the head."""
from benchmark.readers import per_step_ms


def read(out, cell):
    return per_step_ms(out, "head")
