"""sync_wait_ms.rig: host ms a request of the untraced tail blocked on the device (the
program's ``wait`` spans)."""
from benchmark.program_spans import sync_wait_ms


def read(out, cell):
    return sync_wait_ms(out)
