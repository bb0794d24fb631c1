"""launch_host_ms.rig: host ms a request of the untraced tail in the forward less its waits
on the device: the host issuing the forward's work."""
from benchmark.program_spans import launch_host_ms


def read(out, cell):
    return launch_host_ms(out)
