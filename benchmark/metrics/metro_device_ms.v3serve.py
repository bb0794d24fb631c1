"""metro_device_ms.v3serve: device ms a batch of the kernels launched inside the
METRO stage's encoder blocks (the driver's ``bench.metro`` hooks)."""
from benchmark.readers import per_step_ms


def read(out, cell):
    return per_step_ms(out, "metro")
