"""backbone_device_ms.serve: device ms a batch of the kernels launched inside the
backbone, feat_neck and uv_neck forwards."""
from benchmark.readers import per_step_ms


def read(out, cell):
    return per_step_ms(out, "backbone", "feat_neck", "uv_neck")
